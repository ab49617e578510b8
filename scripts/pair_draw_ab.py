#!/usr/bin/env python3
"""The MIN-Gibbs and DoubleMIN sweep kernels of several checkouts, timed on
one card.

  python3 scripts/pair_draw_ab.py PARENT_ROOT CHANGE_ROOT [MORE_ROOTS ...]

The first process builds potts-64x64's row alias tables once and saves
them with the node table under ``build/pair_draw_ab/``.  Each checkout (a
directory holding ``src/repro_torch``) then runs in a process of its own,
in the order given and then back (parent, change, change, parent), builds
its kernels from its own sources and times its four global-minibatch
sweep kernels on the inputs of ``chip_smoke.py`` phase 6, drawn on the card
from fixed seeds: the host-stream forms at MIN-Gibbs C=128 S=8 and
DoubleMIN C=256 S=64, the Philox forms at C=256 S=64 (potts-64x64, the
engines' default lambdas), and the host-stream forms again at the fewer
chains of phase 3b (MIN-Gibbs C=16, DoubleMIN C=64), where one block per
chain leaves most of the card's 132 SMs idle.  Each reading is the median
of CUDA-event times of single calls.  Every run also
prints each kernel's registers, spills and shared memory (``-Xptxas -v``),
pair draws per second, the byte bound of ``chip_smoke.py`` and a
random-gather probe: ``torch.take`` of as many 8-byte records as the
MIN-Gibbs call draws, from a 128 MiB table at uniform random indices (a
yardstick for the gather floor, used nowhere in the port).  The outputs of
every run are hashed: the host-stream forms and the Philox forms must give
the same bits in every checkout.  Prints one
JSON line per run and the card's name and power limit, and writes them all
to ``chiprun_out/pair_draw_ab.json``.  Needs one CUDA card; imports nothing
of JAX.
"""
import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TABLES = ROOT / "build" / "pair_draw_ab" / "tables.pt"
# case -> (kernel, C, S); the first four are chip_smoke.py phase 6's
CASES = {"min_gibbs_sweep": ("min_gibbs_sweep", 128, 8),
         "double_min_sweep": ("double_min_sweep", 256, 64),
         "min_gibbs_sweep_rng": ("min_gibbs_sweep_rng", 256, 64),
         "double_min_sweep_rng": ("double_min_sweep_rng", 256, 64),
         "min_gibbs_sweep C=16": ("min_gibbs_sweep", 16, 8),
         "double_min_sweep C=64": ("double_min_sweep", 64, 16)}
REPS = {"min_gibbs_sweep": 10, "double_min_sweep": 10,
        "min_gibbs_sweep_rng": 3, "double_min_sweep_rng": 10}


def save_tables():
    """potts-64x64's row and node alias tables and the constants the draws
    read, built once on the host."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import engine, samplers
    g = engine.make_workload("potts-64x64", device="cpu").graph
    npb, nab = samplers._node_alias_table(g)
    TABLES.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(row_prob=g.row_prob, row_alias=g.row_alias,
                    row_sum=g.row_sum, node_prob=npb, node_alias=nab,
                    n=g.n, D=g.D, L=g.L, psi=g.psi), TABLES)


def inputs(t, dev):
    """The plain-version arguments and keywords of each kernel, drawn on
    the card from fixed seeds, as the engines draw them."""
    import torch
    from repro_torch.core.estimators import (min_gibbs_lscale,
                                             recommended_capacity)
    n, D, L, psi = t["n"], t["D"], t["L"], t["psi"]
    tabs = [t[k].to(dev) for k in ("node_prob", "node_alias", "row_prob",
                                   "row_alias")]
    row_sum = t["row_sum"].to(dev)
    lam1, lam2 = 4.0 * L ** 2, min(2.0 * psi ** 2, 16384.0)
    K1, K2 = recommended_capacity(lam1), recommended_capacity(lam2)
    lscale2 = min_gibbs_lscale(psi, lam2)
    gen = torch.Generator(device=dev).manual_seed(31)

    def common(C, S):
        x = torch.randint(0, D, (C, n), generator=gen, device=dev,
                          dtype=torch.int32)
        i = torch.randint(0, n, (C, S), generator=gen, device=dev,
                          dtype=torch.int32)
        cache = torch.rand((C,), generator=gen, device=dev) * 3
        return x, i, cache

    def poisson(rate, K):
        return torch.poisson(rate, generator=gen).clamp_(max=K).to(
            torch.int32)

    def gumbel(shape):
        u = torch.rand(shape, generator=gen, device=dev)
        return -torch.log(-torch.log(u + 1e-20) + 1e-20)

    def local_B(i):
        return poisson((lam1 / L) * row_sum[i.long()], K1)

    rp, ra, npb, nab = tabs[2], tabs[3], tabs[0], tabs[1]
    out = {}
    for case, (kernel, C, S) in CASES.items():
        x, i, cache = common(C, S)
        if kernel == "min_gibbs_sweep":
            B = poisson(torch.full((C, S, D), lam2, device=dev), K2)
            u4 = [torch.rand((C, S, D, K2), generator=gen, device=dev)
                  for _ in range(4)]
            out[case] = ((x, *tabs, i, B, *u4, gumbel((C, S, D)), cache),
                         dict(D=D, lscale=lscale2), B)
        elif kernel == "double_min_sweep":
            B1 = local_B(i)
            u2 = [torch.rand((C, S, K1), generator=gen, device=dev)
                  for _ in range(2)]
            g = gumbel((C, S, D))
            B2 = poisson(torch.full((C, S), lam2, device=dev), K2)
            v4 = [torch.rand((C, S, K2), generator=gen, device=dev)
                  for _ in range(4)]
            logu = torch.log(torch.rand((C, S), generator=gen, device=dev))
            out[case] = (
                (x, rp, ra, npb, nab, i, B1, *u2, g, B2, *v4, logu, cache),
                dict(D=D, scale1=L / lam1, lscale2=lscale2), B2)
        elif kernel == "min_gibbs_sweep_rng":
            B = poisson(torch.full((C, S, D), lam2, device=dev), K2)
            out[case] = ((x, *tabs, i, B, cache),
                         dict(D=D, lscale=lscale2, K=K2), B)
        else:
            B1 = local_B(i)
            B2 = poisson(torch.full((C, S), lam2, device=dev), K2)
            out[case] = (
                (x, rp, ra, npb, nab, i, B1, B2, cache),
                dict(D=D, scale1=L / lam1, lscale2=lscale2, K1=K1, K2=K2),
                B2)
    return out, row_sum


def kernel_args(fs, name, args):
    """The checkout's argument list of kernel ``name``: the packed tables
    (its own ``pack_alias``) where its wrapper takes them, else the plain
    version's arguments."""
    params = list(inspect.signature(getattr(fs, name + "_cuda")).parameters)
    if params[1] not in ("node_pack", "row_pack"):
        return args
    from repro_torch.core.factor_graph import pack_alias
    return (args[0], pack_alias(args[1], args[2]),
            pack_alias(args[3], args[4]), *args[5:])


def ptxas(log):
    """{kernel: "registers; spills; shared memory"} of the four kernels."""
    lines, out = log.splitlines(), {}
    for k, ln in enumerate(lines):
        if "entry function" not in ln:
            continue
        for name in ("min_gibbs", "double_min"):
            if f"{name}_sweep_kernel" in ln:
                form = "_rng" if "Philox" in ln else ""
                out[f"{name}_sweep{form}"] = "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4]
                    if "spill" in x or "registers" in x)
    return out


def digest(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_tree(tree):
    """Readings of the checkout at ``tree``'s four kernels."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.kernels import _build, fused_sweep as fs
    dev = torch.device("cuda")
    built = _build.load_library()
    t = torch.load(TABLES)
    cases, row_sum = inputs(t, dev)
    out = {}
    for case, (name, _, _) in CASES.items():
        args, kw, B = cases[case]
        rng = name.endswith("_rng")
        kargs = kernel_args(fs, name, args)
        wrapper = getattr(fs, name + "_cuda")
        seed = (cs._seed(77, dev),) if rng else ()
        if name.startswith("min_gibbs"):
            nbytes, ops, int_ops = cs.min_gibbs_bound(args, row_sum, rng,
                                                      kw.get("K", 0))
        else:
            B1 = args[6]
            nbytes, ops, int_ops = cs.double_min_bound(
                args[0], args[5], B1, B, row_sum, kw["D"], rng)
        bound_ms, by = cs.bound(nbytes, ops, int_ops)
        live = int(B.long().sum())
        ms, res = cs.timed(lambda: wrapper(*kargs, *seed, **kw), REPS[name])
        torch.cuda.synchronize()
        out[case] = dict(ms=ms, pair_draws_per_s=live / (ms / 1e3),
                         outputs=digest(res), bound_ms=bound_ms, bound_by=by,
                         live_draws=live)
        del res
        del kargs
        torch.cuda.empty_cache()
    # the gather probe: as many random 8-byte records as the MIN-Gibbs call
    # draws, from a 128 MiB table
    live = out["min_gibbs_sweep"]["live_draws"]
    probe_ms = cs.gather_probe(live, dev)
    torch.cuda.empty_cache()
    return dict(tree=str(tree), module=fs.__file__,
                ptxas=ptxas(built.log) if built.log else "reused",
                kernels=out,
                gather_probe=dict(records=live, table_bytes=128 << 20,
                                  ms=probe_ms,
                                  records_per_s=live / (probe_ms / 1e3)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.trees[0])))
        return 0
    if len(args.trees) < 2:
        ap.error("give the parent's and the change's checkout")
    import torch
    if not torch.cuda.is_available():
        print("pair_draw_ab: no CUDA device", file=sys.stderr)
        return 1
    save_tables()
    runs = []
    for tree in args.trees + args.trees[::-1]:
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
    # the same bits everywhere: kernel by kernel, over checkouts
    same = {k: len({run["kernels"][k]["outputs"] for run in runs}) == 1
            for k in CASES}
    print(json.dumps(dict(same_outputs=same)))
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "pair_draw_ab.json").write_text(
        json.dumps(dict(card=smi, same_outputs=same, runs=runs), indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
