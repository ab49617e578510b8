"""Serving launcher: resident sampling chains answering marginal queries
(the JAX package's ``launch/serve.py`` on the port).

The request front of ``repro_torch.serving``: register a workload with a
warm :class:`~repro_torch.serving.ChainPool`, submit a batch of
marginal/MAP queries (optionally evidence-clamped), and get
freshness-gated answers back as JSON.  Runs on the card unless
``--device cpu`` (the kernels' plain versions).  With ``--supervise`` the
resident chains are driven by
:class:`~repro_torch.runtime.supervisor.SupervisedRun` — verified
checkpoints,
health guards, crash-resume — publishing a pool snapshot after every
committed outer step (and fencing the pool's lanes on every rollback), so
a restarted server resumes its chains bit-exactly and never serves a lane
forked from a discarded chunk.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --workload hetero-pairs-24 --engine gibbs --device cpu --chains 32 \
      --demo 8 --out answers.json
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --workload hetero-pairs-1024 --engine gibbs --chains 256 --sweep 64 \
      --chunk 16 --demo 8 --supervise --ckpt-dir out/serve-ckpt

``--queries`` takes a JSON list of ``{"sites": [...], "evidence":
[[site, value], ...], "kind": "marginal"|"map", "deadline_ms": ...,
"priority": ...}`` objects — validated against the workload's graph
(site/value domains) with a clear error BEFORE any chain work starts;
``--demo N`` generates N alternating unclamped / single-site-clamped
queries instead.  ``--max-pending`` / ``--deadline-ms`` /
``--breaker-open-after`` set the resilience policies;
``--chaos-lane-fault`` runs the chaos drill: poison one lane's snapshot
after the first batch, re-submit until the breaker opens (degraded
answers), then once more to watch the half-open probe recover it.
``--profile`` captures a ``torch.profiler`` trace of the batch (CPU, and
CUDA on the card) into a directory (``obs``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np

from .. import obs
from ..core import engine as engine_lib
from ..diagnostics.freshness import FreshnessPolicy
from ..serving import AdmissionPolicy, BreakerPolicy, ChainPool, Query


def _demo_queries(workload: str, graph, n: int, seed: int) -> List[Query]:
    """N queries alternating unclamped marginals / single-site-clamped
    marginals at random sites — the smoke-test traffic pattern."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append(Query(workload))
        else:
            s = int(rng.integers(graph.n))
            v = int(rng.integers(graph.D))
            out.append(Query(workload, evidence=((s, v),)))
    return out


def _load_queries(workload: str, path: str, graph) -> List[Query]:
    """Parse + validate a ``--queries`` JSON file against the workload's
    graph.  Every malformed entry dies here with a clear message naming
    the file, the entry index, and the offending field — never a
    traceback mid-batch after chains have already burned sweeps."""
    def die(msg: str):
        raise SystemExit(f"--queries {path}: {msg}")

    try:
        with open(path) as f:
            specs = json.load(f)
    except OSError as e:
        die(f"cannot read file ({e})")
    except json.JSONDecodeError as e:
        die(f"malformed JSON ({e})")
    if not isinstance(specs, list):
        die(f"top level must be a JSON list of query objects, "
            f"got {type(specs).__name__}")
    out = []
    for i, q in enumerate(specs):
        where = f"queries[{i}]"
        if not isinstance(q, dict):
            die(f"{where}: must be an object, got {type(q).__name__}")
        unknown = set(q) - {"sites", "evidence", "kind", "deadline_ms",
                            "priority"}
        if unknown:
            die(f"{where}: unknown fields {sorted(unknown)}")
        sites = q.get("sites")
        if sites is not None:
            if (not isinstance(sites, list)
                    or not all(isinstance(s, int) for s in sites)):
                die(f"{where}: 'sites' must be a list of ints")
            bad = [s for s in sites if not 0 <= s < graph.n]
            if bad:
                die(f"{where}: sites {bad} out of range [0, {graph.n})")
        ev = q.get("evidence", [])
        if (not isinstance(ev, list)
                or not all(isinstance(e, (list, tuple)) and len(e) == 2
                           and all(isinstance(x, int) for x in e)
                           for e in ev)):
            die(f"{where}: 'evidence' must be a list of [site, value] "
                f"int pairs")
        bad = [s for s, _ in ev if not 0 <= s < graph.n]
        if bad:
            die(f"{where}: evidence sites {bad} out of range "
                f"[0, {graph.n})")
        bad = [v for _, v in ev if not 0 <= v < graph.D]
        if bad:
            die(f"{where}: evidence values {bad} out of range "
                f"[0, {graph.D})")
        try:
            out.append(Query(
                workload,
                sites=None if sites is None else tuple(sites),
                evidence=tuple((s, v) for s, v in ev),
                kind=q.get("kind", "marginal"),
                deadline_ms=q.get("deadline_ms"),
                priority=q.get("priority", 0)))
        except (ValueError, TypeError) as e:
            die(f"{where}: {e}")
    return out


def serve_batch(workload: str, queries: List[Query], *,
                engine: str = "gibbs", device=None,
                chains: int = 32, sweep: int = 0, chunk: int = 16,
                warmup_chunks: int = 0,
                max_extra_sweeps: Optional[int] = None,
                policy: Optional[FreshnessPolicy] = None, seed: int = 0,
                supervise: bool = False, ckpt_dir: str = "",
                outer_steps: int = 32, pool: Optional[ChainPool] = None,
                fault_plan=None, max_pending: int = 0,
                deadline_ms: Optional[float] = None,
                breaker_open_after: int = 0,
                chaos_lane_fault: bool = False) -> dict:
    """Register ``workload``, warm the pool, answer ``queries``; returns a
    JSON-safe dict (per-answer records + batch summary).

    Plain path: the pool advances its own lanes synchronously (each stale
    lane sweeps until fresh, bounded by ``max_extra_sweeps`` and the
    queries' deadlines).  Supervised path: ``SupervisedRun`` drives the
    resident chains for ``outer_steps`` committed steps — checkpointing
    to ``ckpt_dir``, publishing a pool snapshot after each, fencing the
    pool's lane epochs on every rollback — then the batch is answered.
    ``chaos_lane_fault`` runs the chaos drill after the first batch (see
    module docstring); its summary lands under ``"chaos"``.  The pool
    runs on ``device`` (the card unless told otherwise)."""
    if pool is None:
        admission = AdmissionPolicy(
            max_pending=max_pending or 1024,
            default_deadline_ms=deadline_ms)
        breaker = (BreakerPolicy(open_after=breaker_open_after)
                   if breaker_open_after else BreakerPolicy())
        pool = ChainPool(policy=policy or FreshnessPolicy(), seed=seed,
                         admission=admission, breaker=breaker)
    w = pool.register(workload, engine=engine, device=device,
                      chains=chains, sweep=sweep or None,
                      sweeps_per_chunk=chunk, seed=seed)
    g = w.engine.graph
    t0 = time.time()
    if supervise:
        _drive_supervised(pool, workload, engine, chains,
                          sweep or g.n, chunk, outer_steps, seed, ckpt_dir,
                          fault_plan)
    elif warmup_chunks:
        pool.advance(workload, chunks=warmup_chunks)
    answers = pool.submit(queries, max_extra_sweeps=max_extra_sweeps)
    chaos = None
    if chaos_lane_fault:
        chaos = _chaos_drill(pool, w, workload, queries)
    dt = time.time() - t0
    obs.get_recorder().snapshot()     # batch end: an existing sync point
    records = [a.to_dict() for a in answers]
    n_fresh = sum(r["fresh"] for r in records)
    status_counts: dict = {}
    source_counts: dict = {}
    for r in records:
        status_counts[r["status"]] = status_counts.get(r["status"], 0) + 1
        if r["source"]:
            source_counts[r["source"]] = \
                source_counts.get(r["source"], 0) + 1
    out = {
        "workload": workload, "engine": w.engine.describe(),
        "chains": chains, "sweeps_per_chunk": chunk,
        "n_queries": len(records), "fresh_fraction":
        n_fresh / max(len(records), 1),
        "status_counts": status_counts, "source_counts": source_counts,
        "elapsed_s": dt, "queries_per_sec": len(records) / max(dt, 1e-9),
        "compiled_traces": pool.compiled_cache_size(workload),
        "resident_sweeps": w.resident.sweeps,
        "answers": records,
    }
    if chaos is not None:
        out["chaos"] = chaos
    return out


def _chaos_drill(pool: ChainPool, w, workload: str,
                 queries: List[Query]) -> dict:
    """Poison one lane's snapshot, re-submit until the breaker opens
    (every answer must stay structured and degraded, never an exception),
    then submit once more so the half-open probe recovers the lane."""
    target_sig = next(iter(w.lanes), ())
    lane = w.resident if target_sig == () else w.lanes[target_sig]
    pool.inject_lane_fault(workload, target_sig, target="cache")
    pool.advance(workload, chunks=1)          # latch the in-graph guard
    degraded_statuses: List[str] = []
    degraded_sources: List[str] = []
    opens = 0
    for _ in range(max(pool.breaker_policy.open_after, 1) + 1):
        batch = pool.submit(queries, max_extra_sweeps=0)
        degraded_statuses += [a.status for a in batch]
        degraded_sources += [a.source for a in batch
                             if a.query.signature == target_sig]
        opens = lane.breaker.open_count
        if opens:
            break
    recovered = pool.submit(queries)          # half-open probe path
    return {
        "target_lane": ("resident" if target_sig == ()
                        else [list(e) for e in target_sig]),
        "breaker_opens": opens,
        "breaker_state_after": lane.breaker.state,
        "degraded_statuses": degraded_statuses,
        "degraded_sources": degraded_sources,
        "recovered_sources": [a.source for a in recovered],
        "recovered_statuses": [a.status for a in recovered],
    }


def _drive_supervised(pool: ChainPool, workload: str, engine: str,
                      chains: int, sweep: int, chunk: int,
                      outer_steps: int, seed: int, ckpt_dir: str,
                      fault_plan=None):
    """Run the resident chains under the supervised runtime, publishing a
    pool snapshot after every committed outer step and fencing the pool's
    lane epochs on every rollback/restart recovery.  The engines are
    built on the pool's device; ``publish`` copies the supervisor's
    buffers, which its next outer step updates in place."""
    from ..runtime import supervisor as sup

    g = pool.engine(workload).graph

    def make_engine(name, ranks, **params):
        return engine_lib.make(name, g, sweep=sweep, device=g.device,
                               **params)

    cfg = sup.SupervisorConfig(outer_steps=outer_steps,
                               sweeps_per_outer=chunk, chains=chains,
                               seed=seed, ckpt_dir=ckpt_dir,
                               workload=workload)

    def on_step(step, bundle, tel, eng):
        pool.publish(workload, bundle.st, tel, bundle.marg, bundle.count,
                     step * chunk)

    def on_rollback(step, bundle, tel, eng):
        # the published lineage rewound: fence lanes forked from the
        # discarded chunks, then re-publish the restored snapshot (which
        # closes the fence with a second epoch bump)
        pool.invalidate(workload)
        pool.publish(workload, bundle.st, tel, bundle.marg, bundle.count,
                     step * chunk)

    sup.SupervisedRun(engine, make_engine, cfg, on_step=on_step,
                      on_rollback=on_rollback,
                      fault_plan=fault_plan).run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="hetero-pairs-24",
                    choices=list(engine_lib.workload_names()))
    ap.add_argument("--engine", default="gibbs",
                    choices=["gibbs", "mgpmh", "min-gibbs", "doublemin"])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda')")
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--sweep", type=int, default=0,
                    help="site updates per sweep call (default: n)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="sweeps per chunk (snapshot cadence)")
    ap.add_argument("--warmup-chunks", type=int, default=0,
                    help="chunks to advance the resident lane before "
                         "answering (stale lanes also self-advance)")
    ap.add_argument("--max-extra-sweeps", type=int, default=None,
                    help="per-lane sweep budget to reach freshness before "
                         "the answer degrades")
    ap.add_argument("--rhat", type=float, default=1.1,
                    help="freshness gate: max split-R-hat")
    ap.add_argument("--min-ess", type=float, default=64.0,
                    help="freshness gate: min per-site ESS")
    ap.add_argument("--min-samples", type=int, default=16,
                    help="freshness gate: min telemetry snapshots")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="admission control: in-flight query budget "
                         "(overflow is shed lowest-priority first; "
                         "0 = default 1024)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-query deadline (queries may carry "
                         "their own deadline_ms)")
    ap.add_argument("--breaker-open-after", type=int, default=0,
                    help="per-lane circuit breaker: consecutive unhealthy "
                         "chunks before opening (0 = default policy)")
    ap.add_argument("--chaos-lane-fault", action="store_true",
                    help="chaos drill: poison one lane after the first "
                         "batch, assert degraded answers + breaker "
                         "recovery (summary under 'chaos' in --out)")
    ap.add_argument("--queries", default="",
                    help="JSON file of query specs (see module docstring)")
    ap.add_argument("--demo", type=int, default=0,
                    help="generate N demo queries (alternating unclamped / "
                         "single-site-clamped)")
    ap.add_argument("--out", default="", help="write answers JSON here")
    ap.add_argument("--supervise", action="store_true",
                    help="drive resident chains under SupervisedRun "
                         "(verified checkpoints, health guards, resume)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--outer-steps", type=int, default=32,
                    help="supervised outer steps before answering")
    ap.add_argument("--fault-plan", default="",
                    help="inline JSON or path: deterministic fault "
                         "injection into the supervised driver")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-dir", default="",
                    help="write metrics.jsonl / metrics.prom / "
                         "events.jsonl here")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace-event JSON here")
    ap.add_argument("--profile", default="",
                    help="capture a torch.profiler trace into this dir")
    args = ap.parse_args(argv)
    if args.queries and args.demo:
        ap.error("pass --queries or --demo, not both")
    if not args.queries and not args.demo:
        ap.error("no queries: pass --queries FILE or --demo N")
    if args.ckpt_dir and not args.supervise:
        ap.error("--ckpt-dir requires --supervise")
    if args.fault_plan and not args.supervise:
        ap.error("--fault-plan requires --supervise")

    rec = obs.configure(metrics_dir=args.metrics_dir or None,
                        trace_path=args.trace or None,
                        profile_dir=args.profile or None,
                        process_name="repro.serve")
    fault_plan = None
    if args.fault_plan:
        from ..runtime.faultinject import FaultPlan
        fault_plan = FaultPlan.from_json(args.fault_plan)
    g = engine_lib.make_workload(args.workload, device="cpu").graph
    # queries are parsed and domain-validated BEFORE any pool/chain work
    queries = (_load_queries(args.workload, args.queries, g)
               if args.queries
               else _demo_queries(args.workload, g, args.demo, args.seed))
    policy = FreshnessPolicy(max_rhat=args.rhat,
                             min_ess_per_site=args.min_ess,
                             min_samples=args.min_samples)
    with rec.profile():
        res = serve_batch(args.workload, queries, engine=args.engine,
                          device=args.device, chains=args.chains,
                          sweep=args.sweep, chunk=args.chunk,
                          warmup_chunks=args.warmup_chunks,
                          max_extra_sweeps=args.max_extra_sweeps,
                          policy=policy, seed=args.seed,
                          supervise=args.supervise, ckpt_dir=args.ckpt_dir,
                          outer_steps=args.outer_steps,
                          fault_plan=fault_plan,
                          max_pending=args.max_pending,
                          deadline_ms=args.deadline_ms,
                          breaker_open_after=args.breaker_open_after,
                          chaos_lane_fault=args.chaos_lane_fault)
    rec.close()
    print(f"[serve] {res['n_queries']} queries on {args.workload} "
          f"({args.engine}/{res['engine']['backend']}): "
          f"fresh={res['fresh_fraction']:.2f} "
          f"statuses={res['status_counts']} "
          f"{res['queries_per_sec']:.1f} q/s "
          f"traces={res['compiled_traces']} "
          f"resident_sweeps={res['resident_sweeps']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"[serve] wrote {args.out}")


if __name__ == "__main__":
    main()
