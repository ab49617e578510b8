"""Gibbs-engine launcher: the paper's sampling loop end to end, on one
device or sharded over a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.gibbs --config potts-64x64 \
      --engine mgpmh --steps 200 --chains 256 --sweep 64
  PYTHONPATH=src python -m repro_torch.launch.gibbs --config potts-64x64 \
      --engine min-gibbs --steps 200 --chains 128 --sweep 8
  PYTHONPATH=src python -m repro_torch.launch.gibbs \
      --config lattice-ising-64x64 --engine gibbs --chromatic --steps 20
  PYTHONPATH=src python -m repro_torch.launch.gibbs \
      --config hetero-pairs-1024 --engine gibbs --adaptive --telemetry \
      --sweep 64
  PYTHONPATH=src python -m repro_torch.launch.gibbs --config potts-64x64 \
      --engine mgpmh --steps 200 --chains 256 --sweep 64 --telemetry \
      --metrics-dir out/m --trace out/m/trace.json --profile out/prof
  torchrun --nproc-per-node P -m repro_torch.launch.gibbs \
      --config potts-64x64 --engine mgpmh --steps 200 --chains 256 \
      --sweep 64 --backend dist --mp-shards M
  PYTHONPATH=src python -m repro_torch.launch.gibbs --config potts-64x64 \
      --engine mgpmh --steps 128 --chains 256 --sweep 64 --supervise \
      --ckpt-dir out/ck --fault-plan '{"faults": [{"step": 2, \
      "kind": "preempt"}, {"step": 4, "kind": "nan", "target": "x"}]}'

Engines (gibbs, mgpmh, min-gibbs, doublemin, local-gibbs) and workloads
come from the registries in ``repro_torch.core.engine``.  Runs on the card
unless ``--device cpu``.  ``--adaptive`` switches to the telemetry-driven
``AdaptiveScan`` site selection (gibbs, mgpmh, min-gibbs, doublemin);
``--telemetry`` threads the streaming diagnostics carry through the run
and logs the max split-R-hat and ESS per second too.  ``--backend dist``
runs the engine sharded (``runtime/dist_gibbs.py``) over a (data, model)
mesh of the world's ranks, dp = world / ``--mp-shards``: one process per
rank under ``torchrun``, NCCL on the card and gloo on the CPU, one
all-reduce per sweep call; the running marginals are gathered (one more
all-reduce) only at log lines, and only rank 0 logs and writes metrics.
``--metrics-dir`` writes ``metrics.jsonl`` (one snapshot per log line) and
``metrics.prom`` there, ``--trace`` a Chrome trace-event JSON of the
``sweep_chunk`` spans (one per sweep call), and ``--profile`` a
``torch.profiler`` capture of the run (CPU, and CUDA on the card) into a
directory, as ``profile_trace.json``, where the ``repro.sweep/...`` ranges
hold each call's kernels (``obs``).  The metrics (``sweeps_total``,
``updates_total``, ``acceptance``, ``marginal_err``) are taken at the log
line's existing host read: the observability adds no host sync.
Each log line reports the running-marginal error, the acceptance rate and
the throughput in site updates per second (host clock; the log line's host
read waits for the device).  ``--ckpt-dir`` checkpoints the state (its
generators included) and the running marginals at every log line; a rerun
over the same directory resumes bit-exactly (``resumed at step N``).
``--supervise`` runs the loop under ``runtime/supervisor.py`` in outer
steps of ``--supervise-chunk`` sweep calls, optionally under a
deterministic ``--fault-plan``, and ends with one ``supervised done``
line.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import diagnostics as diag
from .. import obs
from .._device import resolve_device
from ..core import engine as engine_lib
from ..core.chains import accumulate_marginals
from ..runtime.dist_gibbs import dist_restore, dist_to_host, gather_marginals
from .mesh import init_distributed, make_device_mesh, mesh_group

__all__ = ["run", "run_supervised", "main", "engine_factory"]

ADAPTIVE_ENGINES = ("gibbs", "mgpmh", "min-gibbs", "doublemin")


def engine_factory(config: str, sweep: int = 0, *, chromatic: bool = False,
                   adaptive: bool = False, backend: str = "auto",
                   mp_shards: int = 0, device=None):
    """``(make_engine, graph)``: ``make_engine(name, ranks, **params)``
    builds the engine, on ``backend == "dist"`` over a (len(ranks) /
    mp_shards, mp_shards) mesh of the given ranks (on a rank outside
    ``ranks`` it returns None), else (``"auto"``) on one device, the
    device's backend (``ranks`` unused).
    The launcher's one construction hook (the supervisor rebuilds its
    engine through it over the surviving ranks).
    On ``"dist"`` the workload's graph is built on the host, and each
    rank's engine takes its shard of it to ``device``."""
    dev = resolve_device(device)
    wl = engine_lib.make_workload(
        config, device="cpu" if backend == "dist" else dev)
    if chromatic:
        if wl.colors is None:
            raise ValueError(f"workload {config!r} has no coloring for "
                             f"--chromatic")
        schedule = engine_lib.ChromaticBlocks(wl.colors)
    elif adaptive:
        schedule = engine_lib.AdaptiveScan(sweep_len=max(sweep, 1))
    else:
        schedule = engine_lib.UniformSites(max(sweep, 1))

    def make_engine(name, ranks, **params):
        if backend == "dist":
            mp = mp_shards or 1
            dp = max(len(ranks) // mp, 1)
            mesh = make_device_mesh((dp, mp), ("data", "model"), ranks,
                                    device_type=dev.type)
            if mesh is None:          # a rank the mesh leaves out
                return None
            return engine_lib.make(name, wl.graph, schedule=schedule,
                                   mesh=mesh, **params)
        return engine_lib.make(name, wl.graph, schedule=schedule,
                               device=dev, **params)
    return make_engine, wl.graph


def run_supervised(config: str, engine: str, steps: int, chains: int, *,
                   ckpt_dir: str = "", seed: int = 0, sweep: int = 0,
                   chromatic: bool = False, adaptive: bool = False,
                   device=None, backend: str = "auto", mp_shards: int = 0,
                   fault_plan: str = "", chunk: int = 16,
                   max_restarts: int = 5):
    """The supervised counterpart of :func:`run`: the same engine and
    workload flags, the loop driven by ``runtime.supervisor.SupervisedRun``
    -- restarts, verified-checkpoint rollback, health guards with
    lambda-retune / degrade-to-gibbs escalation, elastic restart over the
    dist backend's ranks -- optionally under a deterministic ``fault_plan``
    (inline JSON or a path).  ``steps`` sweep calls in outer steps of
    ``chunk``.  Returns the :class:`~repro_torch.runtime.supervisor.
    RunResult` (on ``backend="dist"`` this rank's; ``left`` on a rank a
    device loss left out)."""
    from ..runtime import supervisor as sup
    from ..runtime.faultinject import FaultPlan

    dist_run = backend == "dist"
    if dist_run:
        device = init_distributed(device)
    make_engine, g = engine_factory(
        config, sweep, chromatic=chromatic, adaptive=adaptive,
        backend=backend, mp_shards=mp_shards, device=device)
    ranks = list(range(dist.get_world_size())) if dist_run else []
    cfg = sup.SupervisorConfig(
        outer_steps=-(-steps // chunk), sweeps_per_outer=chunk,
        chains=chains, seed=seed, ckpt_dir=ckpt_dir,
        max_restarts=max_restarts, workload=config,
        heartbeat=os.path.join(ckpt_dir, "heartbeat.json")
        if ckpt_dir else "")
    plan = FaultPlan.from_json(fault_plan) if fault_plan else None
    res = sup.SupervisedRun(engine, make_engine, cfg, plan,
                            ranks=ranks).run()
    if res.left or (dist_run and dist.get_rank() != 0):
        return res
    m = res.marginals
    err = float(np.sqrt(((m - 1 / g.D) ** 2).sum(-1)).mean())
    print(f"[gibbs] supervised done: outer_steps={res.outer_steps} "
          f"restarts={res.restarts} rollbacks={res.rollbacks} "
          f"engine={res.engine.name} marg_err={err:.4f}", flush=True)
    return res


def run(config: str, engine: str, steps: int, chains: int, *,
        ckpt_dir: str = "", log_every: int = 2000, seed: int = 0,
        sweep: int = 0, chromatic: bool = False, adaptive: bool = False,
        telemetry: bool = False, device=None, backend: str = "auto",
        mp_shards: int = 0):
    """Advance ``chains`` chains by ``steps`` sweep calls, logging at every
    ``log_every`` calls and at the end.  Returns the final state (on
    ``backend="dist"`` this rank's part of it; the process group must be
    up, as :func:`main` makes it).  With ``ckpt_dir`` the state (with its
    generators) and the running marginals are saved at every log line and
    a rerun resumes from the newest checkpoint (on the dist backend the
    global arrays, which rank 0 writes)."""
    from ..checkpoint import checkpoint as ckpt

    dist_run = backend == "dist"
    if dist_run:
        device = init_distributed(device)
    make_engine, _ = engine_factory(
        config, sweep, chromatic=chromatic, adaptive=adaptive,
        backend=backend, mp_shards=mp_shards, device=device)
    ranks = list(range(dist.get_world_size())) if dist_run else []
    eng = make_engine(engine, ranks)
    g = eng.graph
    upd_per_step = eng.updates_per_call
    rec = obs.get_recorder()
    labels = rec.register_engine(eng, workload=config, chains=chains)
    lead = not dist_run or dist.get_rank() == 0

    st = eng.init(seed, chains)
    marg = None             # a dist state keeps its own running marginals
    if not dist_run:
        marg = torch.zeros((chains, g.n, g.D), dtype=torch.float32,
                           device=eng.device)
        weight = torch.empty((chains, g.n), dtype=torch.float32,
                             device=eng.device)
    start = 0
    if ckpt_dir and (last := ckpt.latest_step(ckpt_dir)) is not None:
        if dist_run:
            st = dist_restore(ckpt_dir, last, st, eng.mesh)
        else:
            st, marg = ckpt.restore(ckpt_dir, last, (st, marg))
        start = last
        if lead:
            print(f"[gibbs] resumed at step {start}", flush=True)
    tel = eng.init_telemetry(st) if telemetry else None
    t0 = time.time()
    last_logged = start
    for s in range(start, steps):
        # one span per sweep call (dispatch only: the log line's host read
        # below is the loop's only sync)
        with rec.span("sweep_chunk", **labels):
            if tel is None:
                st = eng.sweep(st)
            else:
                st, tel = eng.sweep(st, tel)
            if not dist_run:
                accumulate_marginals(marg, st.x, weight)
        if (s + 1) % log_every == 0 or s == steps - 1:
            if dist_run:    # every rank takes part in the gather
                m, accepts = gather_marginals(st, eng.mesh)
            else:
                m, accepts = marg, st.accepts
            if ckpt_dir:
                if dist_run:        # every rank takes part in the gather
                    host = dist_to_host(st, eng.mesh, 0)
                    if lead:
                        ckpt.save(ckpt_dir, s + 1, host)
                    # no rank goes on before the save is on disk: a rerun
                    # on every rank must find the same newest step
                    dist.all_reduce(torch.zeros(1, device=st.x.device),
                                    group=mesh_group(eng.mesh))
                else:
                    ckpt.save(ckpt_dir, s + 1, (st, marg))
            if not lead:
                continue
            # samples accumulated since step 0 (marginals and accepts are
            # cumulative across resumes)
            m = m.sum(0) / ((s + 1) * chains)
            err = float(torch.sqrt(((m - 1 / g.D) ** 2).sum(-1)).mean())
            acc = 1.0 if eng.exact_accept else (
                float(accepts.double().mean()) / ((s + 1) * upd_per_step))
            elapsed = time.time() - t0
            rate = (s + 1 - start) * chains * upd_per_step / elapsed
            line = (f"[gibbs] step {s+1:7d} marg_err={err:.4f} "
                    f"acc={acc:.3f} {rate/1e3:.1f}k updates/s")
            if tel is not None:
                ts = diag.summarize(tel, eng.exact_accept,
                                    elapsed_sec=elapsed)
                line += (f" rhat={ts['max_split_rhat']:.3f} "
                         f"ess/s={ts.get('ess_per_sec', 0.0):.1f}")
            print(line, flush=True)
            # piggyback the log line's host read for metric export
            rec.count("sweeps_total", s + 1 - last_logged, **labels)
            rec.count("updates_total",
                      (s + 1 - last_logged) * chains * upd_per_step,
                      **labels)
            last_logged = s + 1
            rec.gauge("acceptance", acc, **labels)
            rec.gauge("marginal_err", err, **labels)
            rec.snapshot()
    return st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="potts-20x20",
                    choices=list(engine_lib.workload_names()))
    ap.add_argument("--engine", default="mgpmh",
                    choices=list(engine_lib.names()))
    ap.add_argument("--steps", type=int, default=20_000)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--sweep", type=int, default=0,
                    help="site updates per kernel launch (uniform schedule)")
    ap.add_argument("--chromatic", action="store_true",
                    help="ChromaticBlocks schedule (gibbs on a colorable "
                         "workload): one full sweep per call")
    ap.add_argument("--adaptive", action="store_true",
                    help="AdaptiveScan schedule (gibbs/mgpmh/min-gibbs/"
                         "doublemin): telemetry-driven non-uniform site "
                         "selection")
    ap.add_argument("--telemetry", action="store_true",
                    help="thread streaming convergence telemetry and log "
                         "split-R-hat / ESS per second")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda')")
    ap.add_argument("--backend", default="auto", choices=["auto", "dist"],
                    help="'auto': one device, the kernels on the card; "
                         "'dist': the engine sharded over the world's "
                         "ranks (run under torchrun; NCCL on the card, "
                         "gloo on the CPU)")
    ap.add_argument("--mp-shards", type=int, default=0,
                    help="model shards of the dist mesh (graph columns); "
                         "dp = world / mp-shards")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint the sampler state (generators "
                         "included) here and resume from the newest "
                         "checkpoint on a rerun")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the supervised runtime: verified-"
                         "checkpoint restarts, health guards with "
                         "rollback + lambda-retune / degrade-to-gibbs, "
                         "elastic restart (runtime/supervisor.py)")
    ap.add_argument("--fault-plan", default="",
                    help="deterministic FaultPlan as inline JSON or a file "
                         "path (requires --supervise); see "
                         "runtime/faultinject.py")
    ap.add_argument("--supervise-chunk", type=int, default=16,
                    help="sweep calls per supervised outer step (health "
                         "check + checkpoint cadence)")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--metrics-dir", default="",
                    help="write metrics.jsonl / metrics.prom here")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace-event JSON here")
    ap.add_argument("--profile", default="",
                    help="capture a torch.profiler trace into this dir")
    args = ap.parse_args(argv)
    if args.chromatic and args.engine != "gibbs":
        ap.error("--chromatic runs the gibbs engine only")
    if args.adaptive and args.engine not in ADAPTIVE_ENGINES:
        ap.error(f"--adaptive supports the {'/'.join(ADAPTIVE_ENGINES)} "
                 f"engines, not {args.engine!r}")
    if args.adaptive and args.chromatic:
        ap.error("--adaptive and --chromatic are two schedules; pick one")
    if args.mp_shards and args.backend != "dist":
        ap.error("--mp-shards needs --backend dist")
    if args.fault_plan and not args.supervise:
        ap.error("--fault-plan requires --supervise")
    joined = False
    if args.backend == "dist":
        if "dist" not in engine_lib.backends(args.engine):
            ap.error(f"engine {args.engine!r} has no dist backend")
        joined = not dist.is_initialized()
        init_distributed(args.device)
    # only rank 0 writes metrics, traces and profiles
    lead = args.backend != "dist" or dist.get_rank() == 0
    out = (lambda path: path or None) if lead else (lambda path: None)
    rec = obs.configure(metrics_dir=out(args.metrics_dir),
                        trace_path=out(args.trace),
                        profile_dir=out(args.profile),
                        process_name="repro.gibbs")
    try:
        common = dict(ckpt_dir=args.ckpt_dir, sweep=args.sweep,
                      chromatic=args.chromatic, adaptive=args.adaptive,
                      device=args.device, backend=args.backend,
                      mp_shards=args.mp_shards)
        with rec.profile():
            if args.supervise:
                run_supervised(args.config, args.engine, args.steps,
                               args.chains, fault_plan=args.fault_plan,
                               chunk=args.supervise_chunk,
                               max_restarts=args.max_restarts, **common)
            else:
                run(args.config, args.engine, args.steps, args.chains,
                    telemetry=args.telemetry, **common)
        rec.close()
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
