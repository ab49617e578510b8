#!/usr/bin/env python3
"""The MGPMH sweep kernels and the MGPMH engine's sweep call of several
checkouts, timed on one card.

  python3 scripts/mgpmh_ab.py PARENT_ROOT CHANGE_ROOT [MORE_ROOTS ...]
  python3 scripts/mgpmh_ab.py ROOT          # one checkout, one run

The first process builds potts-64x64 (W, the row sums and the row alias
tables, packed) once and saves it under ``build/mgpmh_ab/``.  Each checkout
(a directory holding ``src/repro_torch``) then runs in a process of its
own, in the order given and then back (parent, change, change, parent),
builds its kernels from its own sources and, on inputs drawn on the card
from fixed seeds (the same in every checkout):

  * times both MGPMH kernels (host streams and in-kernel Philox) at
    phase 4's call, potts-64x64 C=256 S=64 K=201 D=10 (CUDA-event medians
    of single calls; device time alone from ``torch.profiler``), and the
    uniform Gibbs kernel at the same C and S, whose outputs the shared row
    ring must not change; hashes every output;
  * traces its own MGPMH engine's sweep call (``chip_smoke.call_trace``:
    the call, its draws and the kernel's wrapper alone, each with the
    host's issue time, and the device's busy time, idle share and top ops
    over a stream of calls);
  * runs that engine as phase 4 of ``chip_smoke.py`` does (200 sweep
    calls, 10 snapshots, through ``run_marginal_experiment``) from seed 0,
    after a warm-up run: updates/s (host clock to a synchronize),
    acceptance and a hash of the final chains and accepts and one of the
    marginal sums, which must be the same in every checkout (the draws are
    the same); then the Gibbs engine the same way;
  * prints the kernels' registers, spills and shared memory
    (``-Xptxas -v``) and a random-gather probe (``chip_smoke.gather_probe``)
    at the kernel's live draws.

A checkout from before the packed signature gets the two row tables (as
contiguous copies of the packed records' fields).  Prints one JSON line per
run, then the checks and the card's name and power limit, and writes them
all to ``chiprun_out/mgpmh_ab.json``.  Needs one CUDA card; imports nothing
of JAX.
"""
import argparse
import hashlib
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GRAPH = ROOT / "build" / "mgpmh_ab" / "potts.pt"
C, S = 256, 64
REPS = dict(kernel=20, rng=10, gibbs=20)
CALLS = 200                 # engine sweep calls per run, as phase 4's


def save_graph():
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import engine
    g = engine.make_workload("potts-64x64", device="cpu").graph
    GRAPH.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(W=g.W, row_sum=g.row_sum, row_pack=g.row_pack, D=g.D,
                    psi=g.psi, L=g.L, delta=g.delta), GRAPH)


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas(log):
    """{entry: "registers; spills; shared memory"} of the MGPMH and Gibbs
    kernels."""
    lines, out = log.splitlines(), {}
    for k, ln in enumerate(lines):
        hit = re.search(r"\d((?:mgpmh|gibbs)_sweep_kernel\w*)", ln)
        if "entry function" in ln and hit:
            out[hit.group(1)] = "; ".join(
                x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4]
                if "spill" in x or "registers" in x)
    return out


def time_tree(tree):
    """Readings of the checkout at ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.core import chains, engine, samplers
    from repro_torch.core.estimators import recommended_capacity
    from repro_torch.core.factor_graph import MatchGraph
    from repro_torch.kernels import _build, fused_sweep as fs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    built = _build.load_library()
    t = torch.load(GRAPH)
    W, row_sum, pack = (t[k].to(dev) for k in ("W", "row_sum", "row_pack"))
    D, L = t["D"], t["L"]
    n = W.shape[0]
    packed = "row_pack" in inspect.signature(fs.mgpmh_sweep_cuda).parameters
    tables = ((pack,) if packed else
              (pack[..., 0].view(torch.float32).contiguous(),
               pack[..., 1].contiguous()))
    lam = 4.0 * L ** 2
    K = recommended_capacity(lam)
    scale = L / lam
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randint(0, D, (C, n), generator=gen, device=dev,
                      dtype=torch.int32)
    i = torch.randint(0, n, (C, S), generator=gen, device=dev,
                      dtype=torch.int32)
    rate = (lam / L) * row_sum
    B = torch.poisson(rate[i.long()], generator=gen).clamp_(max=K).to(
        torch.int32)
    u1 = torch.rand((C, S, K), generator=gen, device=dev)
    u2 = torch.rand((C, S, K), generator=gen, device=dev)
    g = samplers.gumbel((C, S, D), gen, dev)
    lu = torch.rand((C, S), generator=gen, device=dev).log_()
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    out = {}
    host = lambda: fs.mgpmh_sweep_cuda(x, W, *tables, i, B, u1, u2, g, lu,
                                       D=D, scale=scale)
    rng = lambda: fs.mgpmh_sweep_rng_cuda(x, W, *tables, i, B, seed, D=D,
                                          scale=scale, K=K)
    for name, fn, reps in (("mgpmh_sweep", host, REPS["kernel"]),
                           ("mgpmh_sweep_rng", rng, REPS["rng"])):
        ms, res = cs.timed(fn, reps)
        torch.cuda.synchronize()
        out[name] = dict(
            shape=f"potts-64x64 C={C} S={S} K={K} D={D}", ms=ms,
            device_ms=cs.kernel_device_ms(fn, 10, "mgpmh_sweep"),
            outputs=digest(*res), accepts=int(res[1].sum()))
        del res
    out["gather_probe_ms"] = cs.gather_probe(int(B.long().sum()), dev)
    gi = torch.randint(0, n, (C, S), generator=gen, device=dev,
                       dtype=torch.int32)
    gg = samplers.gumbel((C, S, D), gen, dev)
    ms, res = cs.timed(lambda: fs.gibbs_sweep_cuda(x, W, gi, gg, D=D),
                       REPS["gibbs"])
    out["gibbs_sweep"] = dict(ms=ms, outputs=digest(res))
    del res, u1, u2
    torch.cuda.empty_cache()

    # the engine: its sweep call traced, then 100 calls from seed 0
    graph = MatchGraph(W=W, D=D, psi=t["psi"], L=L, delta=t["delta"],
                       row_sum=row_sum,
                       tables=(dict(row_pack=pack) if packed else
                               dict(row_prob=tables[0], row_alias=tables[1])))
    eng = engine.make("mgpmh", graph, sweep=S)
    st = eng.init(3, C, start="random")
    dgen = torch.Generator(device=dev).manual_seed(4)
    # a checkout from before the rate was made once takes lambda
    takes_rate = "rate" in inspect.signature(samplers.mgpmh_draws).parameters
    per_site = samplers.mgpmh_rate(graph, lam) if takes_rate else lam
    draw = lambda: samplers.mgpmh_draws(dgen, graph, C, S, per_site, K)
    dr = draw()
    trace = cs.call_trace(lambda: eng.sweep(st), {
        "draws": draw,
        "kernel": lambda: fs.mgpmh_sweep_cuda(st.x, W, *tables, *dr, D=D,
                                              scale=scale)})
    del dr

    def phase4(eng):
        chains.run_marginal_experiment(eng, eng.init(1, C), n_iters=20 * S,
                                       n_snapshots=1)    # warm-up
        st = eng.init(0, C)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = chains.run_marginal_experiment(eng, st, n_iters=CALLS * S,
                                            n_snapshots=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc = (1.0 if eng.exact_accept else
               float(tr.final.accepts.double().sum()) / (CALLS * S * C))
        return dict(calls=CALLS, seconds=wall,
                    updates_per_s=CALLS * S * C / wall, acceptance=acc,
                    marg_err=float(tr.error[-1]),
                    chains=digest(tr.final.x, tr.final.accepts),
                    marginals=digest(tr.marg))
    run = phase4(eng)
    gibbs_run = phase4(engine.make("gibbs", graph, sweep=S))
    return dict(tree=str(tree), module=fs.__file__, packed=packed,
                ptxas=ptxas(built.log) if built.log else "reused",
                kernels=out, call=trace, engine=run, gibbs_engine=gibbs_run)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.trees[0])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("mgpmh_ab: no CUDA device", file=sys.stderr)
        return 1
    save_graph()
    order = (args.trees if len(args.trees) == 1
             else args.trees + args.trees[::-1])
    runs = []
    for tree in order:
        res = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    same = lambda get: len({get(r) for r in runs}) == 1
    checks = dict(
        mgpmh_outputs_same=same(lambda r: r["kernels"]["mgpmh_sweep"]
                                ["outputs"]),
        mgpmh_rng_outputs_same=same(lambda r: r["kernels"]["mgpmh_sweep_rng"]
                                    ["outputs"]),
        gibbs_outputs_same=same(lambda r: r["kernels"]["gibbs_sweep"]
                                ["outputs"]),
        engine_chains_same=same(lambda r: (r["engine"]["chains"],
                                           r["engine"]["marginals"])),
        gibbs_engine_chains_same=same(lambda r: (
            r["gibbs_engine"]["chains"], r["gibbs_engine"]["marginals"])),
        per_run=[dict(
            tree=r["tree"], mgpmh_ms=r["kernels"]["mgpmh_sweep"]["ms"],
            mgpmh_rng_ms=r["kernels"]["mgpmh_sweep_rng"]["ms"],
            gibbs_ms=r["kernels"]["gibbs_sweep"]["ms"],
            call_ms=r["call"]["stream_call_ms"],
            idle=r["call"]["device_idle_share"],
            updates_per_s=r["engine"]["updates_per_s"],
            gibbs_updates_per_s=r["gibbs_engine"]["updates_per_s"])
            for r in runs])
    print(json.dumps(checks))
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "mgpmh_ab.json").write_text(
        json.dumps(dict(card=smi, checks=checks, runs=runs), indent=1))
    return 0 if all(v for k, v in checks.items() if k != "per_run") else 1


if __name__ == "__main__":
    sys.exit(main())
