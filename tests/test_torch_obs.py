"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs`` on the CPU.

  * the metrics registry (counters, gauges, kind mixing), its Prometheus
    exposition and escaping, the Chrome trace JSON, ``configure`` and
    ``using`` — and the same call sequence gives the JAX package's
    Prometheus text, JSONL series and trace JSON (timestamps normalised);
  * ``register_engine``'s identity and cost gauges on every port engine
    (no collective payload off the dist backend), equal to the JAX
    engine's at hetero-pairs-24, sweep 8, chains 4; on dist engines (a
    spawned gloo rank) the collective gauges are ``psum_footprint``'s;
    ``sweep_cost`` equal for every engine name;
  * no added work: the aten operations of a CPU sweep chunk are the same
    under the null and an active recorder, and ``annotate`` dispatches no
    operation (the port's counterpart of the reference's jaxpr-equality
    and transfer-guard checks); the profiler capture holds the engine's
    ``repro.sweep`` ranges;
  * the launcher's ``--metrics-dir`` / ``--trace`` files parse, count
    every sweep call, and carry the JAX launcher's metric names and label
    keys; under ``--backend dist --mp-shards 2`` on two gloo ranks, rank 0
    logs and writes them, rank 1 neither;
  * the supervised runtime's golden files (``tests/test_obs.py:229-305``):
    its trace spans and labels, its Prometheus series, its ``events.jsonl``
    incident stream, and the checkpoint spans and counters.
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.launch import gibbs as jlaunch  # noqa: E402
from repro.obs import costmodel as jcost  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.launch import gibbs as tlaunch  # noqa: E402
from repro_torch.obs import costmodel as tcost  # noqa: E402
from repro_torch.obs import recorder as trecorder  # noqa: E402

import torch_dist_workers as dist_workers  # noqa: E402

WORKLOAD = "hetero-pairs-24"
GRAPH = engine.make_workload(WORKLOAD, device="cpu").graph
ENGINES = ("gibbs", "mgpmh", "min-gibbs", "doublemin", "local-gibbs")


@pytest.fixture(autouse=True)
def _null_recorder():
    """Every test starts and ends with the null recorder active."""
    obs.set_recorder(obs.NullRecorder())
    yield
    obs.set_recorder(obs.NullRecorder())


def _calls(reg):
    """One call sequence of every kind, escapes included."""
    reg.count("sweeps_total", 5, engine="gibbs", backend="jnp")
    reg.count("sweeps_total", 2, engine="gibbs", backend="jnp")
    reg.count("sweeps_total", 1, engine="mgpmh", backend="cuda")
    reg.gauge("acceptance", 0.25, help="mean acceptance",
              schedule="uniform-sites(S=4)",
              note='quote " and \\ back\nline')
    reg.gauge("acceptance", 0.5, schedule="uniform-sites(S=4)",
              note='quote " and \\ back\nline')
    for v in (0.0003, 0.02, 0.02, 7.0, 30.0):
        reg.histogram("query_seconds", v, workload="w")
    reg.histogram("wait_seconds", 0.5, buckets=(0.1, 1.0), workload="w")


# -- metrics registry --------------------------------------------------------

def test_metrics_counter_accumulates_and_gauge_overwrites():
    m = obs.MetricsRegistry()
    m.count("hits", 2, engine="gibbs")
    m.count("hits", 3, engine="gibbs")
    m.count("hits", 1, engine="mgpmh")
    m.gauge("depth", 4.0)
    m.gauge("depth", 7.0)
    assert m.value("hits", engine="gibbs") == 5
    assert m.value("hits", engine="mgpmh") == 1
    assert m.value("depth") == 7.0
    assert m.value("missing") is None


@pytest.mark.parametrize("first, then", [("count", "gauge"),
                                         ("gauge", "count"),
                                         ("histogram", "gauge")])
def test_metrics_rejects_kind_mixing(first, then):
    m = obs.MetricsRegistry()
    getattr(m, first)("x", 1.0)
    with pytest.raises(ValueError, match="metric 'x' is a"):
        getattr(m, then)("x", 1.0)


def test_prometheus_exposition_parses_and_escapes():
    m = obs.MetricsRegistry()
    m.count("sweeps_total", 5, engine="gibbs", backend="cuda")
    m.gauge("acceptance", 0.5, schedule='uniform-sites(S=4)',
            note='quote " and \\ back\nline')
    text = m.to_prometheus()
    assert '# TYPE repro_sweeps_total counter' in text
    assert '# TYPE repro_acceptance gauge' in text
    assert 'repro_sweeps_total{backend="cuda",engine="gibbs"} 5' in text
    assert '\\n' in text and '\\"' in text
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? '
                        r'[-+0-9.eE]+$')
    for line in text.strip().splitlines():
        assert line.startswith("#") or sample.match(line), line


@pytest.mark.parametrize("export", ["to_prometheus", "snapshot"])
def test_metrics_exports_equal_jax(export):
    """The same calls give the JAX registry's Prometheus text and JSONL
    series, character for character."""
    port, ref = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _calls(port)
    _calls(ref)
    assert getattr(port, export)() == getattr(ref, export)()
    assert obs.prometheus_escape('a"b\\c\nd') == jobs.prometheus_escape(
        'a"b\\c\nd')


# -- trace buffer ------------------------------------------------------------

def test_trace_buffer_writes_chrome_trace_json(tmp_path):
    tb = obs.TraceBuffer(process_name="repro.test")
    t0 = tb.now_us()
    tb.complete("sweep_chunk", t0, max(tb.now_us() - t0, 1.0),
                engine="gibbs")
    tb.instant("fault", step=3)
    out = tmp_path / "trace.json"
    tb.write(str(out))
    doc = json.loads(out.read_text())
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M" and evs[0]["name"] == "process_name"
    assert evs[0]["args"]["name"] == "repro.test"
    x = [e for e in evs if e["ph"] == "X"]
    i = [e for e in evs if e["ph"] == "i"]
    assert x[0]["name"] == "sweep_chunk" and x[0]["args"]["engine"] == "gibbs"
    assert x[0]["dur"] >= 1.0 and "ts" in x[0]
    assert i[0]["name"] == "fault" and i[0]["s"] == "p"


def _normalised_trace(path):
    doc = json.loads(path.read_text())
    for ev in doc["traceEvents"]:
        for key in ("ts", "dur"):
            if key in ev:
                ev[key] = 0.0
        ev["pid"] = ev["tid"] = 0
    return doc


def test_trace_json_equals_jax(tmp_path):
    """The same spans, completes and instants give the JAX buffer's trace
    JSON once timestamps, process and thread ids are normalised."""
    docs = []
    for mod, name in ((obs, "port"), (jobs, "jax")):
        tb = mod.TraceBuffer(process_name="repro.gibbs")
        with tb.span("sweep_chunk", engine="mgpmh", backend="x"):
            pass
        tb.complete("query", 1.0, 2.5, id=7)
        tb.instant("rollback", step=3, reason="nan")
        path = tmp_path / f"{name}.json"
        tb.write(str(path), extra_meta={"run": 1})
        docs.append(_normalised_trace(path))
    assert docs[0] == docs[1]


# -- recorder ----------------------------------------------------------------

def test_configure_null_by_default_and_using_restores(tmp_path):
    assert obs.configure().enabled is False
    rec = obs.configure(metrics_dir=str(tmp_path))
    assert rec.enabled and obs.get_recorder() is rec
    with obs.using(obs.NullRecorder()):
        assert not obs.get_recorder().enabled
    assert obs.get_recorder() is rec


@pytest.mark.parametrize("name", ENGINES)
def test_register_engine_publishes_identity_and_cost_gauges(name):
    eng = engine.make(name, GRAPH, sweep=8, device="cpu")
    rec = obs.Recorder()
    labels = rec.register_engine(eng, workload=WORKLOAD, chains=4)
    assert labels == {"engine": name, "backend": "torch",
                      "schedule": eng.schedule.describe(),
                      "workload": WORKLOAD}
    assert rec.metrics.value("engine_chains", **labels) == 4
    assert rec.metrics.value("engine_updates_per_call", **labels) == 8
    assert rec.metrics.value("sweep_flops_per_call", **labels) > 0
    assert rec.metrics.value("sweep_bytes_per_call", **labels) > 0
    # a single-device engine: no collective, no payload
    assert rec.metrics.value("psum_payload_bytes", **labels) == 0
    assert rec.metrics.value("collectives_per_sweep", **labels) == 0


def test_register_engine_dist_gauges_equal_psum_footprint(tmp_path):
    """Dist engines on a world of one gloo rank: the collective gauges are
    ``psum_footprint``'s (one per call, or one per color class)."""
    out = dist_workers.run_ranks(dist_workers.gauges_rank, 1, tmp_path,
                                 (1, 1))[0]
    assert [name for name, *_ in out] == [*dist_workers.ENGINES, "gibbs"]
    for name, backend, got, want in out:
        assert backend == "dist"
        assert got == want and got["psum_payload_bytes"] > 0, name
    assert out[-1][2]["collectives_per_sweep"] == 2       # chromatic


@pytest.mark.parametrize("name", ENGINES)
def test_register_engine_cost_gauges_equal_jax(name):
    """hetero-pairs-24, sweep 8, chains 4: the port engine's flops and
    bytes gauges are the JAX engine's (the same default lambda and
    capacity reach the same cost model)."""
    values = []
    for eng in (engine.make(name, GRAPH, sweep=8, device="cpu"),
                jengine.make(name, jengine.make_workload(WORKLOAD).graph,
                             sweep=8, backend="jnp")):
        rec = obs.Recorder()
        labels = rec.register_engine(eng, workload=WORKLOAD, chains=4)
        values.append([rec.metrics.value(m, **labels) for m in (
            "sweep_flops_per_call", "sweep_bytes_per_call",
            "engine_updates_per_call")])
    assert values[0] == values[1]


@pytest.mark.parametrize("algo", ["gibbs", "chromatic", "mgpmh",
                                  "min-gibbs", "doublemin", "local-gibbs",
                                  "unknown"])
def test_sweep_cost_equals_jax(algo):
    params = {"lam": 32.0, "lam2": 512.0, "capacity": 64}
    kw = dict(chains=16, n=400, D=10, sweep=64)
    assert tcost.sweep_cost(algo, params=params, **kw) == jcost.sweep_cost(
        algo, params=params, **kw)
    assert tcost.sweep_cost(algo, **kw) == jcost.sweep_cost(algo, **kw)


class _Ops(TorchDispatchMode):
    """Records every operation dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _chunk_ops(rec, telemetry):
    """The operations of two sweep calls of mgpmh (C=4, S=8) inside one
    ``sweep_chunk`` span, with ``rec`` active."""
    eng = engine.make("mgpmh", GRAPH, sweep=8, device="cpu")
    st = eng.init(0, 4)
    tel = eng.init_telemetry(st) if telemetry else None
    with obs.using(rec), _Ops() as mode:
        with obs.get_recorder().span("sweep_chunk"):
            for _ in range(2):
                if tel is None:
                    st = eng.sweep(st)
                else:
                    st, tel = eng.sweep(st, tel)
    return mode.ops, st


@pytest.mark.parametrize("telemetry", [False, True])
def test_instrumentation_adds_no_ops(telemetry):
    """The same aten operations, in the same order, under the null and an
    active recorder: spans are host-side timers, and the annotations
    dispatch nothing without a profiler."""
    null_ops, a = _chunk_ops(obs.NullRecorder(), telemetry)
    rec = obs.Recorder()
    live_ops, b = _chunk_ops(rec, telemetry)
    assert null_ops and null_ops == live_ops
    assert torch.equal(a.x, b.x)
    assert rec.metrics.value("span_calls_total", span="sweep_chunk") == 1


def test_annotate_dispatches_nothing_without_a_profiler():
    with _Ops() as mode:
        with obs.annotate("repro.sweep/mgpmh/torch"):
            pass
    assert mode.ops == []
    assert obs.annotate("a") is obs.annotate("b")     # one shared scope


def test_profile_captures_the_sweep_and_telemetry_ranges(tmp_path):
    """Under ``Recorder.profile`` the engine's two ranges are recorded,
    once per call, the telemetry range inside the sweep range."""
    eng = engine.make("mgpmh", GRAPH, sweep=8, device="cpu")
    st = eng.init(0, 4)
    tel = eng.init_telemetry(st)
    rec = obs.Recorder(profile_dir=str(tmp_path))
    with rec.profile():
        for _ in range(2):
            st, tel = eng.sweep(st, tel)
    doc = json.loads((tmp_path / trecorder.PROFILE_FILE).read_text())
    spans = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name", "").startswith("repro."):
            spans.setdefault(ev["name"], []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    outer = spans["repro.sweep/mgpmh/torch"]
    inner = spans["repro.sweep/telemetry"]
    assert len(outer) == len(inner) == 2
    for (a0, a1), (b0, b1) in zip(sorted(outer), sorted(inner)):
        assert a0 <= b0 <= b1 <= a1


# -- the launcher ------------------------------------------------------------

def _series(metrics_dir):
    lines = (metrics_dir / "metrics.jsonl").read_text().splitlines()
    return json.loads(lines[-1])["series"]


def test_launcher_writes_metrics_and_trace_like_jax(tmp_path):
    steps, chains, sweep = 3, 4, 8
    mdir, trace = tmp_path / "m", tmp_path / "trace.json"
    tlaunch.main(["--config", WORKLOAD, "--engine", "mgpmh", "--steps",
                  str(steps), "--chains", str(chains), "--sweep", str(sweep),
                  "--device", "cpu", "--metrics-dir", str(mdir),
                  "--trace", str(trace)])
    series = _series(mdir)
    by_name = {s["name"]: s for s in series}
    assert by_name["sweeps_total"]["value"] == steps
    assert by_name["updates_total"]["value"] == steps * chains * sweep
    assert 0.0 < by_name["acceptance"]["value"] <= 1.0
    assert np.isfinite(by_name["marginal_err"]["value"])
    assert by_name["sweeps_total"]["labels"]["backend"] == "torch"
    prom = (mdir / "metrics.prom").read_text()
    assert "# TYPE repro_sweeps_total counter" in prom
    spans = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["sweep_chunk"] * steps

    jdir = tmp_path / "jax"
    with jobs.using(jobs.Recorder(metrics_dir=str(jdir))):
        jlaunch.run(WORKLOAD, "mgpmh", steps, chains, sweep=sweep,
                    backend="jnp")
    jseries = _series(jdir)
    keys = lambda ss: sorted((s["name"], s["kind"], tuple(sorted(
        s["labels"]))) for s in ss)
    assert keys(series) == keys(jseries)
    jby = {s["name"]: s for s in jseries}
    for name in ("sweeps_total", "updates_total", "engine_chains",
                 "engine_updates_per_call", "sweep_flops_per_call",
                 "sweep_bytes_per_call", "psum_payload_bytes"):
        assert by_name[name]["value"] == jby[name]["value"], name


def test_launcher_dist_backend_logs_and_writes_on_rank_0_only(tmp_path):
    """``--backend dist --mp-shards 2`` on two gloo ranks: rank 0 prints
    the log lines and writes ``metrics.jsonl`` (one snapshot per log line
    and one at close) and the trace; rank 1 prints nothing and writes
    nothing."""
    steps, chains, sweep = 4, 4, 4
    mdir, trace, capture = tmp_path / "m", tmp_path / "t.json", tmp_path / "o"
    argv = ["--config", WORKLOAD, "--engine", "mgpmh", "--steps", str(steps),
            "--chains", str(chains), "--sweep", str(sweep), "--device",
            "cpu", "--backend", "dist", "--mp-shards", "2",
            "--metrics-dir", str(mdir), "--trace", str(trace)]
    dist_workers.run_ranks(dist_workers.launcher_rank, 2, tmp_path, argv,
                           str(capture))
    lines = [ln for ln in (tmp_path / "o.0").read_text().splitlines()
             if ln.startswith("[gibbs] step")]
    assert len(lines) == 1 and f"step {steps:7d}" in lines[0], lines
    assert (tmp_path / "o.1").read_text() == ""
    snaps = (mdir / "metrics.jsonl").read_text().splitlines()
    assert len(snaps) == 2
    by_name = {s["name"]: s for s in json.loads(snaps[-1])["series"]}
    assert by_name["sweeps_total"]["value"] == steps
    assert by_name["sweeps_total"]["labels"]["backend"] == "dist"
    assert by_name["collectives_per_sweep"]["value"] == 1
    assert 0.0 < by_name["acceptance"]["value"] <= 1.0
    spans = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["sweep_chunk"] * steps


# -- supervised runtime golden files ------------------------------------------

def _supervised_with_recorder(tmp_path, plan=None):
    from repro_torch.runtime.supervisor import SupervisedRun, SupervisorConfig

    def make_engine(name, ranks, **params):
        return engine.make(name, GRAPH, sweep=4, device="cpu", **params)

    cfg = SupervisorConfig(outer_steps=6, sweeps_per_outer=4, chains=8,
                           seed=0, ckpt_dir=str(tmp_path / "ckpt"),
                           backoff_base=0.0, workload=WORKLOAD)
    rec = obs.Recorder(metrics_dir=str(tmp_path / "metrics"),
                       trace_path=str(tmp_path / "trace.json"))
    with obs.using(rec):
        res = SupervisedRun("mgpmh", make_engine, cfg, plan,
                            sleep_fn=lambda s: None).run()
        rec.close()
    return res


REQUIRED_LABELS = ("engine", "backend", "schedule", "workload")


def test_supervised_trace_and_metrics_golden(tmp_path):
    from repro_torch.runtime.faultinject import Fault, FaultPlan
    res = _supervised_with_recorder(
        tmp_path, FaultPlan([Fault(step=2, kind="nan", target="x")]))
    assert res.rollbacks >= 1
    doc = json.loads((tmp_path / "trace.json").read_text())
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M"
    names = {}
    for e in evs[1:]:
        names.setdefault(e["name"], []).append(e)
    for name in ("sweep_chunk", "checkpoint/save", "rollback_recover",
                 "health", "fault"):
        assert name in names, name
    for e in names["sweep_chunk"]:
        assert e["ph"] == "X" and e["dur"] >= 0
        for k in REQUIRED_LABELS:
            assert k in e["args"], (k, e)
        assert e["args"]["engine"] == "mgpmh"
        assert e["args"]["workload"] == WORKLOAD
    prom = (tmp_path / "metrics" / "metrics.prom").read_text()
    for series in ("repro_acceptance", "repro_sweeps_total",
                   "repro_updates_total", "repro_rollbacks_total",
                   "repro_heartbeat_step", "repro_psum_payload_bytes",
                   "repro_checkpoint_saves_total",
                   "repro_checkpoint_bytes_total", "repro_events_total"):
        assert series in prom, series
    acc = [line for line in prom.splitlines()
           if line.startswith("repro_acceptance{")]
    assert acc and all(f'{k}="' in acc[0] for k in REQUIRED_LABELS)
    lines = (tmp_path / "metrics" / "metrics.jsonl").read_text().splitlines()
    snap = json.loads(lines[-1])
    assert {s["name"] for s in snap["series"]} >= {"sweeps_total",
                                                   "rollbacks_total"}


def test_events_jsonl_is_the_incident_stream(tmp_path):
    from repro_torch.runtime.faultinject import Fault, FaultPlan
    res = _supervised_with_recorder(
        tmp_path, FaultPlan([Fault(step=2, kind="nan", target="x")]))
    ev_kinds = [json.loads(line)["kind"] for line in
                (tmp_path / "metrics" / "events.jsonl").read_text()
                .splitlines()]
    assert not (tmp_path / "ckpt" / "incidents.jsonl").exists()
    assert ev_kinds == [i["kind"] for i in res.incidents]
    assert "fault" in ev_kinds and "health" in ev_kinds


def test_checkpoint_save_restore_emit_spans_and_counters(tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt
    gen = torch.Generator().manual_seed(0)
    tree = {"x": torch.arange(12, dtype=torch.int32).reshape(3, 4),
            "k": gen}
    rec = obs.Recorder(trace_path=str(tmp_path / "trace.json"))
    with obs.using(rec):
        ckpt.save(str(tmp_path / "c"), 1, tree)
        assert ckpt.verify(str(tmp_path / "c"), 1) == []
        out = ckpt.restore(str(tmp_path / "c"), 1, tree)
    assert torch.equal(out["x"], tree["x"])
    assert rec.metrics.value("checkpoint_saves_total") == 1
    nbytes = rec.metrics.value("checkpoint_bytes_total")
    assert nbytes >= tree["x"].numel() * 4 + gen.get_state().numel()
    spans = {e.get("name") for e in rec.trace.events()}
    assert {"checkpoint/save", "checkpoint/verify",
            "checkpoint/restore"} <= spans


# -- serving metrics (tests/test_obs.py:330-359) ------------------------------

def test_serving_emits_query_spans_and_freshness_metrics(tmp_path):
    from repro_torch.diagnostics.freshness import FreshnessPolicy
    from repro_torch.launch.serve import serve_batch
    from repro_torch.serving import Query

    rec = obs.Recorder(metrics_dir=str(tmp_path / "m"),
                       trace_path=str(tmp_path / "trace.json"))
    queries = [Query(WORKLOAD), Query(WORKLOAD, evidence=((0, 1),)),
               Query(WORKLOAD)]
    with obs.using(rec):
        res = serve_batch(
            WORKLOAD, queries, engine="gibbs", device="cpu",
            chains=8, sweep=12, chunk=4, max_extra_sweeps=200,
            policy=FreshnessPolicy(max_rhat=10.0, min_ess_per_site=1.0,
                                   min_samples=2))
    assert res["n_queries"] == 3
    labels = dict(engine="gibbs", backend="torch",
                  schedule=res["engine"]["schedule"], workload=WORKLOAD)
    assert rec.metrics.value("queries_total", fresh=True, **labels) >= 1
    assert rec.metrics.value("pool_lanes", **labels) == 2
    assert rec.metrics.value("sweeps_to_fresh_count", **labels) >= 1
    assert rec.metrics.value("sweeps_total", **labels) > 0
    names = {e.get("name") for e in rec.trace.events()}
    assert {"query", "queue_wait", "freshness_sweeps",
            "lane_fork", "admission", "sweep_chunk"} <= names
    for e in rec.trace.events():
        if e.get("name") in ("query", "freshness_sweeps", "sweep_chunk"):
            for k in REQUIRED_LABELS:
                assert k in e["args"], (k, e)
    prom = (tmp_path / "m" / "metrics.prom").read_text()
    for series in ("repro_queries_total", "repro_sweeps_to_fresh_total",
                   "repro_sweeps_to_fresh_count", "repro_pool_lanes",
                   "repro_queue_wait_seconds", "repro_serving_latency_seconds",
                   "repro_sweeps_total"):
        assert series in prom, series


def test_serving_trace_and_metric_names_equal_jax():
    """The same batch through both packages' fronts records the same span
    and event names and the same metric series names."""
    from repro.diagnostics.freshness import FreshnessPolicy as JPolicy
    from repro.launch.serve import serve_batch as jserve_batch
    from repro.serving import Query as JQuery
    from repro_torch.diagnostics.freshness import FreshnessPolicy
    from repro_torch.launch.serve import serve_batch
    from repro_torch.serving import Query

    kw = dict(engine="gibbs", chains=8, sweep=12, chunk=4,
              max_extra_sweeps=200)
    policy = dict(max_rhat=10.0, min_ess_per_site=1.0, min_samples=2)
    got, want = obs.Recorder(), jobs.Recorder()
    with obs.using(got):
        serve_batch(WORKLOAD, [Query(WORKLOAD),
                               Query(WORKLOAD, evidence=((0, 1),))],
                    device="cpu", policy=FreshnessPolicy(**policy), **kw)
    with jobs.using(want):
        jserve_batch(WORKLOAD, [JQuery(WORKLOAD),
                                JQuery(WORKLOAD, evidence=((0, 1),))],
                     backend="jnp", policy=JPolicy(**policy), **kw)

    def names(rec):
        return ({e.get("name") for e in rec.trace.events()},
                {s["name"] for s in rec.metrics.snapshot()})
    assert names(got) == names(want)
