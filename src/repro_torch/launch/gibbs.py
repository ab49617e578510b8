"""Gibbs-engine launcher: the paper's sampling loop end to end on one device.

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

Engines (gibbs, mgpmh, min-gibbs, doublemin, local-gibbs) and workloads
come from the registries in ``repro_torch.core.engine``.  Runs on the card
unless ``--device cpu``.  ``--adaptive`` switches to the telemetry-driven
``AdaptiveScan`` site selection (gibbs, mgpmh, min-gibbs, doublemin);
``--telemetry`` threads the streaming diagnostics carry through the run
and logs the max split-R-hat and ESS per second too.
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
read waits for the device).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import diagnostics as diag
from .. import obs
from ..core import engine as engine_lib

__all__ = ["run", "main"]

ADAPTIVE_ENGINES = ("gibbs", "mgpmh", "min-gibbs", "doublemin")


def run(config: str, engine: str, steps: int, chains: int, *,
        log_every: int = 2000, seed: int = 0, sweep: int = 0,
        chromatic: bool = False, adaptive: bool = False,
        telemetry: bool = False, device=None):
    """Advance ``chains`` chains by ``steps`` sweep calls, logging at every
    ``log_every`` calls and at the end.  Returns the final state."""
    wl = engine_lib.make_workload(config, device=device)
    if chromatic:
        if wl.colors is None:
            raise ValueError(f"workload {config!r} has no coloring for "
                             f"--chromatic")
        schedule = engine_lib.ChromaticBlocks(wl.colors)
    elif adaptive:
        schedule = engine_lib.AdaptiveScan(sweep_len=max(sweep, 1))
    else:
        schedule = engine_lib.UniformSites(max(sweep, 1))
    eng = engine_lib.make(engine, wl.graph, schedule=schedule, device=device)
    g = eng.graph
    upd_per_step = eng.updates_per_call
    rec = obs.get_recorder()
    labels = rec.register_engine(eng, workload=config, chains=chains)

    st = eng.init(seed, chains)
    tel = eng.init_telemetry(st) if telemetry else None
    marg = torch.zeros((chains, g.n, g.D), dtype=torch.float32,
                       device=eng.device)
    ones = torch.ones((chains, g.n, 1), dtype=torch.float32,
                      device=eng.device)
    t0 = time.time()
    last_logged = 0
    for s in range(steps):
        # one span per sweep call (dispatch only: the log line's host read
        # below is the loop's only sync)
        with rec.span("sweep_chunk", **labels):
            if tel is None:
                st = eng.sweep(st)
            else:
                st, tel = eng.sweep(st, tel)
            marg.scatter_add_(2, st.x.long().unsqueeze(-1), ones)
        if (s + 1) % log_every == 0 or s == steps - 1:
            m = marg.sum(0) / ((s + 1) * chains)
            err = float(torch.sqrt(((m - 1 / g.D) ** 2).sum(-1)).mean())
            acc = 1.0 if eng.exact_accept else (
                float(st.accepts.double().mean()) / ((s + 1) * upd_per_step))
            elapsed = time.time() - t0
            rate = (s + 1) * chains * upd_per_step / elapsed
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
    rec = obs.configure(metrics_dir=args.metrics_dir or None,
                        trace_path=args.trace or None,
                        profile_dir=args.profile or None,
                        process_name="repro.gibbs")
    with rec.profile():
        run(args.config, args.engine, args.steps, args.chains,
            sweep=args.sweep, chromatic=args.chromatic,
            adaptive=args.adaptive, telemetry=args.telemetry,
            device=args.device)
    rec.close()


if __name__ == "__main__":
    main()
