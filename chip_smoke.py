#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:
  1. device and toolchain (card, power limit, torch/CUDA, nvcc, triton);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     with ``-Xptxas -v`` registers / shared memory per kernel);
  3. each kernel against its plain PyTorch version on the card, on the same
     tensors: (a) at the parity shapes of the tests, exactly equal;
     (b) at full width (potts-64x64, C=256, S=64, K=201, D=10, and the
     chromatic lattice-ising-64x64 class), at most 1% of chains differ — the
     plain version sums the ~1564 non-zero W terms of a row in another
     order, so only a near-tie can flip a decision, and a flip then changes
     the rest of that chain;
  4. the main path through the user entry points (``engine.make`` +
     ``run_marginal_experiment``): mgpmh and gibbs on potts-64x64 with 256
     chains x 200 sweeps of 64 updates, then chromatic gibbs on
     lattice-ising-64x64; launch counts reset before and read after each
     run, and must equal the sweep calls (color classes x calls);
  5. kernel times (CUDA-event medians) at the main-path shapes beside the
     plain versions' times and the least time the card could take.

Prints the kernels' JSON record and the card's name and power limit, then
as its last line ``{"ok": true, "device": {...}}``.  Also writes the full
record to ``chiprun_out/chip_smoke.json``.  Needs one CUDA card; imports
nothing of JAX.
"""
import importlib.metadata
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

C_FULL, S_FULL, SWEEPS = 256, 64, 200
PARITY_MGPMH = [(4, 5, 17, 3, 11), (8, 8, 128, 10, 40), (3, 1, 1, 2, 5),
                (5, 12, 33, 6, 20), (2, 3, 9, 129, 7)]
PARITY_GIBBS = [(4, 5, 3, 11), (8, 8, 10, 40), (3, 1, 2, 5)]


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, reps, warmup=1):
    """Median CUDA-event time of ``fn()`` over ``reps`` timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "not installed"
    info = dict(device=name, nvidia_smi=smi, count=torch.cuda.device_count(),
                python=sys.version.split()[0], torch=torch.__version__,
                torch_cuda=torch.version.cuda, nvcc=nvcc, triton=triton)
    say("1 device", json.dumps(info))
    return info


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.load_library()
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "entry function" in ln or "spill" in ln]
    for ln in ptxas:
        say("2 build", ln)
    say("2 build", f"{built.path.name}: nvcc {built.seconds:.1f} s, load "
        f"{wall:.1f} s")
    return dict(nvcc_seconds=built.seconds, load_seconds=wall, ptxas=ptxas)


def _alias_rows(rng, n):
    from repro_torch.core.factor_graph import build_alias_table
    A = rng.uniform(0.1, 1.0, (n, n))
    A = (A + A.T) / 2
    np.fill_diagonal(A, 0)
    rp = np.zeros((n, n), np.float32)
    ra = np.zeros((n, n), np.int32)
    for i in range(n):
        rp[i], ra[i] = build_alias_table(A[i])
    return A.astype(np.float32), rp, ra


def phase_parity(dev):
    """Kernels vs plain versions at the test shapes: exactly equal."""
    from repro_torch.kernels import fused_sweep as fs, ref
    t = lambda a: torch.from_numpy(a).to(dev)
    for (C, S, K, D, n) in PARITY_MGPMH:
        rng = np.random.default_rng(C * 100 + S * 10 + K + D + n)
        W, rp, ra = _alias_rows(rng, n)
        x = rng.integers(0, D, (C, n)).astype(np.int32)
        i = rng.integers(0, n, (C, S)).astype(np.int32)
        B = rng.integers(0, K + 1, (C, S)).astype(np.int32)
        u1 = rng.uniform(size=(C, S, K)).astype(np.float32)
        u2 = rng.uniform(size=(C, S, K)).astype(np.float32)
        g = rng.gumbel(size=(C, S, D)).astype(np.float32)
        lu = np.log(rng.uniform(size=(C, S))).astype(np.float32)
        args = [t(a) for a in (x, W, rp, ra, i, B, u1, u2, g, lu)]
        xk, ak = fs.mgpmh_sweep_cuda(*args, D=D, scale=0.7)
        xr, ar = ref.mgpmh_sweep_ref(*args, D, 0.7)
        torch.cuda.synchronize()
        check(torch.equal(xk, xr) and torch.equal(ak, ar),
              f"mgpmh kernel != plain version at (C,S,K,D,n)="
              f"{(C, S, K, D, n)}")
    for (C, S, D, n) in PARITY_GIBBS:
        rng = np.random.default_rng(C + S + D + n)
        W, _, _ = _alias_rows(rng, n)
        x = rng.integers(0, D, (C, n)).astype(np.int32)
        i = rng.integers(0, n, (C, S)).astype(np.int32)
        g = rng.gumbel(size=(C, S, D)).astype(np.float32)
        args = [t(a) for a in (x, W, i, g)]
        xk = fs.gibbs_sweep_cuda(*args, D=D)
        torch.cuda.synchronize()
        check(torch.equal(xk, ref.gibbs_sweep_ref(*args, D)),
              f"gibbs kernel != plain version at (C,S,D,n)={(C, S, D, n)}")
    say("3a parity", f"{len(PARITY_MGPMH)} mgpmh + {len(PARITY_GIBBS)} gibbs "
        f"shapes: kernel == plain version exactly (x and accepts)")


def build_graphs(dev):
    from repro_torch.core import engine
    t0 = time.perf_counter()
    potts = engine.make_workload("potts-64x64", device=dev).graph
    _ = potts.row_prob                       # the lazy row tables MGPMH reads
    t1 = time.perf_counter()
    lattice = engine.make_workload("lattice-ising-64x64", device=dev)
    t2 = time.perf_counter()
    say("graphs", f"potts-64x64 n={potts.n} D={potts.D} L={potts.L:.4f} "
        f"psi={potts.psi:.1f} delta={potts.delta} built in {t1 - t0:.1f} s; "
        f"lattice-ising-64x64 n={lattice.graph.n} built in {t2 - t1:.1f} s")
    return potts, lattice


def mgpmh_inputs(graph, C, S, seed):
    from repro_torch.core import samplers
    from repro_torch.core.estimators import recommended_capacity
    lam = 4.0 * graph.L ** 2
    K = recommended_capacity(lam)
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    x = torch.randint(0, graph.D, (C, graph.n), generator=gen,
                      device=graph.device, dtype=torch.int32)
    draws = samplers.mgpmh_draws(gen, graph, C, S, lam, K)
    args = (x, graph.W, graph.row_prob, graph.row_alias, *draws)
    return args, dict(D=graph.D, scale=graph.L / lam), lam, K


def gibbs_inputs(graph, C, S, seed, sites=None):
    """Inputs of one Gibbs sweep call; with ``sites``, of one chromatic
    color class (S = its size)."""
    from repro_torch.core import samplers
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    x = torch.randint(0, graph.D, (C, graph.n), generator=gen,
                      device=graph.device, dtype=torch.int32)
    if sites is not None:
        S = sites.numel()
    i, g = samplers.gibbs_draws(gen, C, S, graph.n, graph.D, graph.device)
    if sites is not None:
        i = sites.expand(C, -1).contiguous()
    return (x, graph.W, i, g)


def compare(name, out_k, out_p, C):
    """(differing chains, max abs err) of kernel vs plain outputs."""
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    differ = torch.zeros(C, dtype=torch.bool, device=outs_k[0].device)
    err = 0.0
    for a, b in zip(outs_k, outs_p):
        d = (a != b)
        differ |= d if d.dim() == 1 else d.any(dim=1)
        err = max(err, float((a.double() - b.double()).abs().max()))
    n_diff = int(differ.sum())
    say("3b full width", f"{name}: {n_diff}/{C} chains differ from the "
        f"plain version, max abs err {err}")
    check(n_diff <= 0.01 * C, f"{name}: {n_diff} of {C} chains differ "
          f"(tolerance 1%)")
    return n_diff, err


def phase_full_width(potts, lattice):
    from repro_torch.kernels import fused_sweep as fs, ref
    out = {}
    args, kw, lam, K = mgpmh_inputs(potts, C_FULL, S_FULL, seed=1)
    say("3b full width", f"mgpmh lam={lam:.2f} capacity K={K} "
        f"mean B={float(args[5].float().mean()):.2f}")
    check(K == 201, f"capacity {K} != 201 at potts-64x64's default lambda")
    out["mgpmh_sweep"] = compare(
        "mgpmh_sweep", fs.mgpmh_sweep_cuda(*args, **kw),
        ref.mgpmh_sweep_ref(*args, kw["D"], kw["scale"]), C_FULL)
    args = gibbs_inputs(potts, C_FULL, S_FULL, seed=2)
    out["gibbs_sweep"] = compare(
        "gibbs_sweep", fs.gibbs_sweep_cuda(*args, D=potts.D),
        ref.gibbs_sweep_ref(*args, potts.D), C_FULL)
    sites = torch.as_tensor(np.flatnonzero(lattice.colors == 0),
                            dtype=torch.int32, device=potts.device)
    args = gibbs_inputs(lattice.graph, C_FULL, None, seed=3,
                        sites=sites)
    out["gibbs_sweep_chromatic"] = compare(
        "gibbs_sweep (chromatic class)",
        fs.gibbs_sweep_cuda(*args, D=2), ref.gibbs_sweep_ref(*args, 2),
        C_FULL)
    return out


def run_main_path(name, eng, n_iters, n_snapshots, expect):
    """Drive one engine through run_marginal_experiment with the launch
    counts set to 0 just before and read just after."""
    from repro_torch.core import chains
    from repro_torch.kernels import fused_sweep as fs
    st = eng.init(0, C_FULL)
    torch.cuda.synchronize()
    fs.reset_launch_counts()
    t0 = time.perf_counter()
    tr = chains.run_marginal_experiment(eng, st, n_iters=n_iters,
                                        n_snapshots=n_snapshots)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gibbs_sweep": fs.gibbs_sweep_cuda.launches,
                "mgpmh_sweep": fs.mgpmh_sweep_cuda.launches}
    errs = [float(e) for e in tr.error]
    calls = int(tr.iters[-1]) // eng.updates_per_call
    updates = calls * eng.updates_per_call * C_FULL
    acc = (1.0 if eng.exact_accept else
           float(tr.final.accepts.double().sum()) / updates)
    rec = dict(engine=eng.describe(), sweep_calls=calls, marg_err=errs,
               acceptance=acc, seconds=wall, updates_per_s=updates / wall,
               launches=launches)
    say("4 main path", f"{name}: marg_err " + " ".join(f"{e:.4f}" for e in errs)
        + f"; acc={acc:.4f}; {updates / wall / 1e6:.2f}M updates/s "
        f"({wall:.2f} s); launches {launches}")
    for kernel, want in expect(calls).items():
        check(launches[kernel] == want,
              f"{name}: {kernel} launched {launches[kernel]} times, "
              f"expected {want}")
    check(all(np.isfinite(errs)), f"{name}: non-finite marginal error")
    check(errs[-1] < errs[0] and all(b <= a + 1e-3 for a, b in
                                    zip(errs, errs[1:])),
          f"{name}: marginal error not decreasing: {errs}")
    check(tr.final.x.shape == (C_FULL, eng.graph.n)
          and int(tr.final.x.min()) >= 0
          and int(tr.final.x.max()) < eng.graph.D,
          f"{name}: final state out of domain")
    return rec


def phase_main_path(potts, lattice):
    from repro_torch.core import engine
    out = {}
    eng = engine.make("mgpmh", potts, sweep=S_FULL)
    check(eng.backend == "cuda", "mgpmh engine is not on the cuda backend")
    out["mgpmh"] = run_main_path(
        "mgpmh potts-64x64", eng, SWEEPS * S_FULL, 10,
        lambda calls: {"mgpmh_sweep": calls, "gibbs_sweep": 0})
    check(out["mgpmh"]["acceptance"] > 0.9,
          f"mgpmh acceptance {out['mgpmh']['acceptance']} <= 0.9")
    eng = engine.make("gibbs", potts, sweep=S_FULL)
    out["gibbs"] = run_main_path(
        "gibbs potts-64x64", eng, SWEEPS * S_FULL, 10,
        lambda calls: {"gibbs_sweep": calls, "mgpmh_sweep": 0})
    eng = engine.make("gibbs", lattice.graph,
                      schedule=engine.ChromaticBlocks(lattice.colors))
    out["chromatic"] = run_main_path(
        "chromatic gibbs lattice-ising-64x64", eng, 20 * lattice.graph.n, 4,
        lambda calls: {"gibbs_sweep": 2 * calls, "mgpmh_sweep": 0})
    return out


def _unique_rows(i):
    return int(torch.unique(i).numel())


def _row_nnz(W, i):
    """Non-zero W entries summed over the rows the sub-steps read: the
    terms an exact pass needs (zeros add nothing)."""
    return int((W != 0).sum(dim=1)[i.long()].sum())


def gibbs_bound(x, W, i, g):
    C, n = x.shape
    nbytes = (8 * C * n + 4 * i.numel() + 4 * g.numel()
              + 4 * n * _unique_rows(i))
    ops = _row_nnz(W, i) * g.shape[-1]       # one compare-add per (j, u)
    return nbytes, ops


def mgpmh_bound(x, W, rp, ra, i, B, u1, u2, g, lu):
    C, n = x.shape
    K = u1.shape[-1]
    live = torch.arange(K, device=x.device) < B[..., None]
    idx = torch.clamp((u1 * n).to(torch.int64), max=n - 1)
    keys = (i.long()[..., None] * n + idx)[live]
    nbytes = (8 * C * n + 4 * C + 12 * i.numel() + 4 * g.numel()
              + 8 * int(B.long().sum())              # the live uniforms
              + 8 * int(torch.unique(keys).numel())   # their table entries
              + 4 * n * _unique_rows(i))              # exact-pass W rows
    ops = 2 * _row_nnz(W, i) + 4 * int(B.long().sum())
    return nbytes, ops


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_times(potts, lattice):
    from repro_torch.kernels import fused_sweep as fs, ref
    recs = {}
    args, kw, _, _ = mgpmh_inputs(potts, C_FULL, S_FULL, seed=4)
    ms = median_ms(lambda: fs.mgpmh_sweep_cuda(*args, **kw), 20)
    pms = median_ms(lambda: ref.mgpmh_sweep_ref(*args, kw["D"], kw["scale"]),
                    3)
    bms, by = bound(*mgpmh_bound(*args))
    recs["mgpmh_sweep"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                               shape="potts-64x64 C=256 S=64 K=201 D=10")
    args = gibbs_inputs(potts, C_FULL, S_FULL, seed=5)
    ms = median_ms(lambda: fs.gibbs_sweep_cuda(*args, D=potts.D), 20)
    pms = median_ms(lambda: ref.gibbs_sweep_ref(*args, potts.D), 3)
    bms, by = bound(*gibbs_bound(*args))
    recs["gibbs_sweep"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                               shape="potts-64x64 C=256 S=64 D=10")
    sites = torch.as_tensor(np.flatnonzero(lattice.colors == 0),
                            dtype=torch.int32, device=potts.device)
    args = gibbs_inputs(lattice.graph, C_FULL, None, seed=6,
                        sites=sites)
    ms = median_ms(lambda: fs.gibbs_sweep_cuda(*args, D=2), 5)
    pms = median_ms(lambda: ref.gibbs_sweep_ref(*args, 2), 1)
    bms, by = bound(*gibbs_bound(*args))
    recs["gibbs_sweep_chromatic"] = dict(
        ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        shape="lattice-ising-64x64 one class C=256 S=2048 D=2")
    for k, r in recs.items():
        say("5 times", f"{k} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    recs["per_sweep_ms"] = sweep_parts(potts, lattice)
    return recs


def sweep_parts(potts, lattice):
    """CUDA-event medians of the other device work one sweep call of each
    main-path run makes: its draws and the runner's marginal accumulation."""
    from repro_torch.core import samplers
    from repro_torch.core.estimators import recommended_capacity
    gen = torch.Generator(device=potts.device).manual_seed(7)
    lam = 4.0 * potts.L ** 2
    K = recommended_capacity(lam)
    marg = torch.zeros((C_FULL, potts.n, potts.D), device=potts.device)
    ones = torch.ones((C_FULL, potts.n, 1), device=potts.device)
    x = torch.zeros((C_FULL, potts.n), dtype=torch.long, device=potts.device)
    half = lattice.graph.n // 2
    parts = {
        "mgpmh_draws": median_ms(lambda: samplers.mgpmh_draws(
            gen, potts, C_FULL, S_FULL, lam, K), 20),
        "gibbs_draws": median_ms(lambda: samplers.gibbs_draws(
            gen, C_FULL, S_FULL, potts.n, potts.D, potts.device), 20),
        "chromatic_draws_per_class": median_ms(lambda: samplers.gumbel(
            (C_FULL, half, 2), gen, potts.device), 20),
        "marginal_accumulate": median_ms(lambda: marg.scatter_add_(
            2, x.unsqueeze(-1), ones), 20),
    }
    say("5 times", "per sweep call, besides the kernel: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items()))
    return parts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device("cuda")
    record = {"device": phase_device()}
    record["build"] = phase_build()
    phase_parity(dev)
    potts, lattice = build_graphs(dev)
    record["full_width"] = phase_full_width(potts, lattice)
    record["main_path"] = main = phase_main_path(potts, lattice)
    record["times"] = times = phase_times(potts, lattice)

    src = "src/repro_torch/kernels/csrc/fused_sweep.cu"
    replaces = {"gibbs_sweep": "src/repro/kernels/fused_sweep.py:577",
                "mgpmh_sweep": "src/repro/kernels/fused_sweep.py:505"}
    kernels = []
    for k in ("gibbs_sweep", "mgpmh_sweep"):
        launches = sum(run["launches"][k] for run in main.values())
        check(launches > 0, f"{k} was not launched on the main path")
        t = times[k]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=replaces[k],
            launches=launches, max_abs_err=record["full_width"][k][1],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    record["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(record["device"]["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
