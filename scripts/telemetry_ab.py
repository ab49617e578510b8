#!/usr/bin/env python3
"""The telemetry'd MGPMH sweep call of several checkouts, timed on one card.

  python3 scripts/telemetry_ab.py PARENT_ROOT CHANGE_ROOT [MORE_ROOTS ...]
  python3 scripts/telemetry_ab.py ROOT          # one checkout, one run

Loads potts-64x64 as ``scripts/mgpmh_ab.py`` saves it (built once, under
``build/mgpmh_ab/``).  Each checkout (a directory holding
``src/repro_torch``) runs in a process of its own, in the order given and
then back (parent, change, change, parent), builds its kernels from its own
sources and times, with the MGPMH engine at potts-64x64, C=256, S=64:

  * the sweep call with and without a telemetry carry (K=8), per call as a
    stream of 10, in turns (CUDA events), and the host's issue time of each
    (``chip_smoke.host_ms``);
  * the pieces the carry adds, each alone (stream ms and host issue ms):
    the instrumented sweep (``sweep_stats_fn``) against the plain sweep,
    and the update itself on one call's arguments, with its device time
    (``torch.profiler``);
  * 200 calls through ``run_marginal_experiment`` with and without
    ``telemetry=True`` (host wall to a synchronize, three each in turns);
  * the reference's contract at its own shape (mgpmh on potts-20x20,
    C=64, S=64, 48 calls in 4 snapshots, ``benchmarks/
    diagnostics_bench.py:47-65``): seven runs each in turns, medians;
  * where the checkout has ``repro_torch.obs``: the call (with and without
    telemetry) under an active Recorder (a ``sweep_chunk`` span) against
    the NullRecorder, 15 turns, the median of the turns' ratios;
  * AdaptiveScan mgpmh beside uniform mgpmh, 200 calls each: updates/s;
  * last, under ``torch.profiler``: the update's device time and the
    device's busy time per call over a stream of 10 calls, with and
    without the carry (the profiler's ``repro.`` ranges left out); then the
    two calls timed again (a capture with CUDA activity leaves the host's
    issue slower for the rest of the process, so it comes last).

Prints one JSON line per run, then a summary and the card's name and power
limit, and writes them all to ``chiprun_out/telemetry_ab.json``.  Needs one
CUDA card; imports nothing of JAX.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
C, S, CALLS = 256, 64, 200
REF = dict(C=64, S=64, calls=48, snapshots=4, reps=7)
WINDOW, REPS = 10, 9


def time_tree(tree):
    """Readings of the checkout at ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch import diagnostics as diag
    from repro_torch.core import chains, engine
    from repro_torch.core.factor_graph import MatchGraph, make_potts_graph
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    _build.load_library()
    t = torch.load(ROOT / "build" / "mgpmh_ab" / "potts.pt")
    graph = MatchGraph(W=t["W"].to(dev), D=t["D"], psi=t["psi"], L=t["L"],
                       delta=t["delta"], row_sum=t["row_sum"].to(dev),
                       tables=dict(row_pack=t["row_pack"].to(dev)))
    eng = engine.make("mgpmh", graph, sweep=S)
    out = dict(tree=str(tree))

    box = {"tel": eng.init(1, C), "plain": eng.init(1, C)}
    box["carry"] = eng.init_telemetry(box["tel"])

    def with_tel():
        box["tel"], box["carry"] = eng.sweep(box["tel"], box["carry"])

    def without():
        box["plain"] = eng.sweep(box["plain"])

    out["call_ms"], out["plain_call_ms"], _ = cs.alternating_per_launch_ms(
        with_tel, without, WINDOW, reps=REPS)
    out["call_host_ms"] = cs.host_ms(with_tel, 50)
    out["plain_call_host_ms"] = cs.host_ms(without, 50)
    st = eng.init(2, C)
    stats = lambda: eng.sweep_stats_fn(st)
    plain = lambda: eng.sweep_fn(st)
    out["stats_sweep_ms"], out["plain_sweep_ms"], _ = (
        cs.alternating_per_launch_ms(stats, plain, WINDOW, reps=REPS))
    out["stats_sweep_host_ms"] = cs.host_ms(stats, 50)
    out["plain_sweep_host_ms"] = cs.host_ms(plain, 50)
    new, sweep_stats = eng.sweep_stats_fn(st)
    args = (st.x, new.x, eng.updates_per_call, new.accepts - st.accepts,
            sweep_stats)
    kw = dict(cache=new.cache, n_values=graph.D)
    ubox = {"carry": eng.init_telemetry(st)}

    def update():
        ubox["carry"] = diag.telemetry_update(ubox["carry"], *args, **kw)

    out["update_ms"] = cs.per_launch_ms(update, 20)
    out["update_host_ms"] = cs.host_ms(update, 50)

    # the runner: 200 calls, with and without the carry, in turns
    def runner(telemetry):
        s0 = eng.init(0, C)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = chains.run_marginal_experiment(eng, s0, n_iters=CALLS * S,
                                            n_snapshots=10,
                                            telemetry=telemetry)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, tr

    runner(False), runner(True)
    walls = {True: [], False: []}
    for telemetry in (False, True, True, False, False, True):
        walls[telemetry].append(runner(telemetry)[0])
    out["runner_s"] = walls[True]
    out["plain_runner_s"] = walls[False]

    # the reference's shape
    g20 = make_potts_graph(20, 4.6, 10, device=dev)
    e20 = engine.make("mgpmh", g20, sweep=REF["S"])

    def ref_run(telemetry):
        s0 = e20.init(0, REF["C"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chains.run_marginal_experiment(
            e20, s0, n_iters=REF["calls"] * REF["S"],
            n_snapshots=REF["snapshots"], telemetry=telemetry)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ref_run(False), ref_run(True)
    ref = {True: [], False: []}
    for k in range(REF["reps"]):
        for telemetry in ((False, True) if k % 2 == 0 else (True, False)):
            ref[telemetry].append(ref_run(telemetry))
    out["reference_s"] = ref[True]
    out["plain_reference_s"] = ref[False]
    out["reference_overhead"] = (statistics.median(ref[True])
                                 / statistics.median(ref[False]) - 1.0)

    # observability, where the checkout has it
    try:
        from repro_torch import obs
    except ImportError:
        obs = None
    if obs is not None:
        rec = obs.Recorder()
        labels = rec.register_engine(eng, workload="potts-64x64", chains=C)
        null = obs.NullRecorder()
        for mode in ("telemetry", "plain"):
            boxes = {}
            for name in ("active", "null"):
                s0 = eng.init(1, C)
                boxes[name] = [s0, eng.init_telemetry(s0)
                               if mode == "telemetry" else None]

            def call(r, b):
                with r.span("sweep_chunk", **labels):
                    if b[1] is None:
                        b[0] = eng.sweep(b[0])
                    else:
                        b[0], b[1] = eng.sweep(b[0], b[1])

            a, n, ratio = cs.alternating_per_launch_ms(
                lambda: call(rec, boxes["active"]),
                lambda: call(null, boxes["null"]), WINDOW, 15)
            out[f"obs_{mode}"] = dict(active_ms=a, null_ms=n,
                                      overhead=ratio - 1.0)

    # AdaptiveScan beside uniform
    ada = engine.make("mgpmh", graph,
                      schedule=engine.AdaptiveScan(sweep_len=S))
    rates = {}
    for label, e in (("uniform", eng), ("adaptive", ada), ("adaptive", ada),
                     ("uniform", eng)):
        s0 = e.init(0, C)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chains.run_marginal_experiment(e, s0, n_iters=CALLS * S,
                                       n_snapshots=10)
        torch.cuda.synchronize()
        rates.setdefault(label, []).append(
            CALLS * S * C / (time.perf_counter() - t0))
    out["updates_per_s"] = rates

    # torch.profiler last: after a capture with CUDA activity the host's
    # issue time per call stays higher for the rest of the process (the
    # calls above, timed again here, show by how much)
    out["update_device_ms"] = cs.device_busy(
        lambda: [update() for _ in range(WINDOW)])["device_busy_ms"] / WINDOW
    for label, fn in (("", with_tel), ("plain_", without)):
        busy = cs.device_busy(lambda: [fn() for _ in range(WINDOW)])
        out[f"{label}device_busy_ms"] = busy["device_busy_ms"] / WINDOW
    out["after_profiler_call_ms"], out["after_profiler_plain_call_ms"], _ = (
        cs.alternating_per_launch_ms(with_tel, without, WINDOW, reps=REPS))
    return out


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
        print("telemetry_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "scripts"))
    import mgpmh_ab
    if not mgpmh_ab.GRAPH.exists():
        mgpmh_ab.save_graph()
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
    med = statistics.median
    summary = [dict(
        tree=r["tree"], call_ms=r["call_ms"], plain_call_ms=r["plain_call_ms"],
        call_overhead=r["call_ms"] / r["plain_call_ms"] - 1.0,
        update_ms=r["update_ms"], update_host_ms=r["update_host_ms"],
        update_device_ms=r["update_device_ms"],
        runner_overhead=med(r["runner_s"]) / med(r["plain_runner_s"]) - 1.0,
        reference_overhead=r["reference_overhead"],
        obs_overhead={k: r[k]["overhead"] for k in ("obs_telemetry",
                                                     "obs_plain") if k in r},
        adaptive_per_s=med(r["updates_per_s"]["adaptive"]),
        uniform_per_s=med(r["updates_per_s"]["uniform"])) for r in runs]
    print(json.dumps(summary))
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "telemetry_ab.json").write_text(
        json.dumps(dict(card=smi, summary=summary, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
