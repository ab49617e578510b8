"""The port's marginal-inference serving (``repro_torch.serving`` and
``repro_torch.launch.serve``) on the CPU, held to the JAX package's
``repro.serving`` where it is deterministic and to exact conditionals
where the streams differ.

  * side by side with the JAX package: ``Query`` normalisation and
    ``signature``, ``Answer.to_dict`` JSON, the exact rung of a cold lane
    (1e-12), lane validation errors, the conditioned-lane LRU order, and
    the pool's freshness verdict against the reference ``freshness_report``
    on the same carry (the reference's own masked-freshness test is not
    copied: the reference fails it);
  * clamped answers against ``exact_conditional_marginals`` at the JAX
    test's bounds (``tests/test_serving.py:140-146``), gibbs and mgpmh;
  * evidence as data: one chunk signature, and the same operations in the
    same order for a clamped and an unclamped chunk;
  * copy-on-publish: a held snapshot never changes, and non-perturbation —
    the resident lane of a served pool bit-equal (x, marg, cache, the
    generator's state) to an unserved control, gibbs and min-gibbs (whose
    fork redraws the cache);
  * ``serve_batch`` end to end (``tests/test_system.py:43-60``) and the
    launcher's JSON, ``register`` on the card by default (it raises here
    rather than fall back to the CPU).
The pool on the card is ``chip_smoke.py`` phase 11's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from repro.diagnostics import telemetry as jtel  # noqa: E402
from repro.diagnostics.freshness import (  # noqa: E402
    FreshnessPolicy as JPolicy, freshness_report as jfreshness_report)
from repro.serving import Answer as JAnswer  # noqa: E402
from repro.serving import ChainPool as JChainPool  # noqa: E402
from repro.serving import Query as JQuery  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.diagnostics import (FreshnessPolicy,  # noqa: E402
                                     exact_conditional_marginals,
                                     telemetry_to_numpy)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import Answer, ChainPool, Query  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402

WL = "hetero-pairs-24"
POLICY = FreshnessPolicy(max_rhat=1.2, min_ess_per_site=16.0, min_samples=8)
JPOLICY = JPolicy(max_rhat=1.2, min_ess_per_site=16.0, min_samples=8)
GRAPH = engine.make_workload(WL, device="cpu").graph
SUMMARY_TOL = dict(rtol=1e-6, atol=0.0)


@pytest.fixture(autouse=True)
def _null_recorder():
    obs.set_recorder(obs.NullRecorder())
    yield
    obs.set_recorder(obs.NullRecorder())


def _pool(name="gibbs", chains=16, sweep=24, chunk=8, **kw):
    pool = ChainPool(policy=kw.pop("policy", POLICY), seed=kw.pop("seed", 0))
    pool.register(WL, engine=name, device="cpu", chains=chains, sweep=sweep,
                  sweeps_per_chunk=chunk, **kw)
    return pool


def _jpool(**kw):
    pool = JChainPool(policy=JPOLICY, seed=0)
    pool.register(WL, engine="gibbs", backend="jnp", chains=4, sweep=8,
                  sweeps_per_chunk=2, **kw)
    return pool


# ---------------------------------------------------------------------------
# queries and answers, side by side with the JAX package
# ---------------------------------------------------------------------------

QUERIES = [
    dict(),
    dict(evidence=((5, 1), (0, 1))),
    dict(sites=(3, 1), evidence=[[7, 0]], kind="map", deadline_ms=2,
         priority=3.0),
    dict(sites=[0], deadline_ms=0.0, priority=-1),
]


@pytest.mark.parametrize("kw", QUERIES)
def test_query_normalizes_like_jax(kw):
    a, b = Query(WL, **kw), JQuery(WL, **kw)
    assert a.signature == b.signature
    assert (a.sites, a.evidence, a.kind, a.deadline_ms, a.priority) == \
        (b.sites, b.evidence, b.kind, b.deadline_ms, b.priority)


@pytest.mark.parametrize("kw, match", [
    (dict(evidence=((0, 1), (0, 0))), "duplicate"),
    (dict(kind="mean"), "kind"),
    (dict(deadline_ms=-1.0), "deadline_ms"),
])
def test_query_rejects_like_jax(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        Query(WL, **kw)
    with pytest.raises(ValueError) as want:
        JQuery(WL, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind, status, source", [
    ("marginal", "ok", "fresh"), ("map", "ok", "stale"),
    ("marginal", "refused", None)])
def test_answer_json_equals_jax(kind, status, source):
    rng = np.random.default_rng(0)
    marg = rng.random((2, 3))
    arrays = {} if status == "refused" else (
        {"map_values": np.argmax(marg, -1)} if kind == "map"
        else {"marginals": marg})
    report = {"fresh": source == "fresh", "reason": None, "samples": 12,
              "max_rhat": 1.05, "min_ess": 70.5, "breaker": "closed"}
    qkw = dict(sites=(4, 2), evidence=((9, 1),), kind=kind, priority=2)
    got = Answer(query=Query(WL, **qkw), fresh=source == "fresh",
                 report=report, staleness_sweeps=8, sweeps=64,
                 status=status, source=source, **arrays).to_dict()
    want = JAnswer(query=JQuery(WL, **qkw), fresh=source == "fresh",
                   report=report, staleness_sweeps=8, sweeps=64,
                   status=status, source=source, **arrays).to_dict()
    assert json.dumps(got) == json.dumps(want)


# ---------------------------------------------------------------------------
# lanes, side by side with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ev", [(), ((0, 1), (5, 0))])
def test_cold_exact_rung_equals_jax(ev):
    got = _pool(chains=4, sweep=8, chunk=2).submit(
        [Query(WL, evidence=ev)], max_extra_sweeps=0)[0]
    want = _jpool().submit([JQuery(WL, evidence=ev)], max_extra_sweeps=0)[0]
    assert got.status == want.status == "ok"
    assert got.source == want.source == "exact"
    np.testing.assert_allclose(got.marginals, want.marginals, atol=1e-12)
    np.testing.assert_allclose(
        got.marginals, exact_conditional_marginals(
            GRAPH, [s for s, _ in ev], [v for _, v in ev]), atol=1e-12)
    assert got.report["reason"] == want.report["reason"]


@pytest.mark.parametrize("ev", [((99, 0),), ((0, 9),),
                                tuple((s, 0) for s in range(24))])
def test_lane_validation_errors_equal_jax(ev):
    with pytest.raises(ValueError) as got:
        _pool(chains=4, sweep=8, chunk=2).submit([Query(WL, evidence=ev)])
    with pytest.raises(ValueError) as want:
        _jpool().submit([JQuery(WL, evidence=ev)])
    assert str(got.value) == str(want.value)


def test_lane_lru_order_equals_jax():
    sigs = [((0, 1),), ((1, 1),), ((0, 1),), ((2, 0),), ((3, 1),),
            ((1, 1),), ((3, 1),)]
    tp = _pool(chains=4, sweep=8, chunk=2, max_conditioned=2)
    jp = _jpool(max_conditioned=2)
    for s in sigs:
        a = tp.submit([Query(WL, evidence=s)], max_extra_sweeps=0,
                      serve_stale=True)[0]
        b = jp.submit([JQuery(WL, evidence=s)], max_extra_sweeps=0,
                      serve_stale=True)[0]
        assert list(tp.workload(WL).lanes) == list(jp.workload(WL).lanes)
        assert (a.status, a.source) == (b.status, b.source)


def test_register_refuses_engines_without_evidence():
    pool = ChainPool(policy=POLICY)
    with pytest.raises(ValueError, match="cannot serve"):
        pool.register(WL, engine="local-gibbs", device="cpu", sweep=8)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal without a card")
def test_register_runs_on_the_card_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChainPool(policy=POLICY).register(WL, chains=4)


# ---------------------------------------------------------------------------
# clamped answers against exact conditionals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gibbs", "mgpmh"])
def test_clamped_marginals_match_exact_conditionals(name):
    pool = _pool(name, chains=32, chunk=16)
    ans = pool.submit([Query(WL, evidence=((0, 1),))],
                      max_extra_sweeps=30_000)[0]
    assert ans.fresh, ans.report
    exact = exact_conditional_marginals(GRAPH, [0], [1])
    m = ans.marginals
    assert m[0].tolist() == [0.0, 1.0]           # observed: exact delta
    assert abs(m[1, 1] - exact[1, 1]) < 0.05, (m[1], exact[1])
    tv = 0.5 * np.abs(m - exact).sum(-1)
    assert tv.mean() < 0.06, tv.mean()
    assert tv.max() < 0.25, tv.max()
    assert pool.compiled_cache_size(WL) == 1


def test_freshness_gate_refuses_then_serves():
    pool = _pool()
    q = Query(WL)
    cold = pool.submit([q], max_extra_sweeps=0)[0]
    assert not cold.fresh and cold.status == "ok" and cold.source == "exact"
    np.testing.assert_allclose(
        cold.marginals, exact_conditional_marginals(GRAPH, [], []),
        atol=1e-12)
    assert cold.report["reason"]
    warm = pool.submit([q], max_extra_sweeps=30_000)[0]
    assert warm.fresh and warm.source == "fresh"
    assert warm.report["max_rhat"] <= POLICY.max_rhat
    assert warm.report["min_ess"] >= POLICY.min_ess_per_site
    assert warm.marginals.shape == (24, 2)
    stale = pool.submit([Query(WL, evidence=((3, 0),))], max_extra_sweeps=0,
                        serve_stale=True)[0]
    assert not stale.fresh and stale.marginals is not None


@pytest.mark.parametrize("budget", [16, 400])
def test_pool_freshness_verdict_equals_reference_report(budget):
    """The pool's verdict on a clamped lane is the reference
    ``freshness_report`` on the same carry (converted), with the lane's
    site mask and health folded in: before the gate passes and after."""
    pool = _pool()
    sig = ((0, 1),)
    ans = pool.submit([Query(WL, evidence=sig)],
                      max_extra_sweeps=budget)[0]
    lane = pool.workload(WL).lanes[sig]
    snap = pool.snapshot(WL, sig)
    jt = jtel.Telemetry(**{f: jnp.asarray(a) for f, a in
                           telemetry_to_numpy(snap.tel).items()})
    want = jfreshness_report(jt, JPOLICY, site_mask=lane.site_mask,
                             include_health=True, exact_accept=True)
    got = pool._lane_report(pool.workload(WL), lane, snap)
    assert {k: got[k] for k in ("fresh", "reason", "samples", "bad_state",
                                "win_acceptance")} == \
        {k: want[k] for k in ("fresh", "reason", "samples", "bad_state",
                              "win_acceptance")}
    np.testing.assert_allclose(got["max_rhat"], want["max_rhat"],
                               **SUMMARY_TOL)
    np.testing.assert_allclose(got["min_ess"], want["min_ess"],
                               **SUMMARY_TOL)
    assert ans.report["fresh"] == want["fresh"] == (budget > 16)
    assert ans.report["samples"] == want["samples"]


# ---------------------------------------------------------------------------
# evidence as data: one chunk, the same operations
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    """Records every operation dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["gibbs", "min-gibbs"])
def test_clamped_and_unclamped_chunks_run_the_same_ops(name):
    pool = _pool(name, chains=4, sweep=8, chunk=2)
    w = pool.workload(WL)
    sig = ((2, 0), (5, 1))
    pool.submit([Query(WL, evidence=sig)], max_extra_sweeps=0)
    seqs = []
    for lane in (w.resident, w.lanes[sig]):
        with _Ops() as mode:
            pool._advance_lane(w, lane, 1)
        seqs.append(mode.ops)
    assert seqs[0] and seqs[0] == seqs[1]
    assert pool.compiled_cache_size(WL) == 1


def test_no_recompile_between_clamped_and_unclamped():
    pool = _pool(chains=8, chunk=4)
    pool.submit([Query(WL), Query(WL, evidence=((0, 1),)),
                 Query(WL, evidence=((2, 0), (5, 1)))],
                max_extra_sweeps=30_000)
    assert pool.compiled_cache_size(WL) == 1


# ---------------------------------------------------------------------------
# copy-on-publish and non-perturbation
# ---------------------------------------------------------------------------

def _bits(snap):
    return [snap.st.x.clone(), snap.st.cache.clone(),
            snap.st.accepts.clone(), snap.marg.clone(),
            snap.st.gen.get_state()] + [
        t.clone() for t in snap.tel if isinstance(t, torch.Tensor)]


def test_published_snapshot_is_never_written_again():
    pool = _pool(chunk=4)
    pool.advance(WL, chunks=2)
    held = pool.snapshot(WL)
    before = _bits(held)
    pool.advance(WL, chunks=3)
    pool.submit([Query(WL), Query(WL, evidence=((1, 0),))],
                max_extra_sweeps=0, serve_stale=True)
    pool.inject_lane_fault(WL, target="cache")
    pool.advance(WL, chunks=1)
    assert pool.snapshot(WL) is not held
    for a, b in zip(before, _bits(held)):
        assert torch.equal(a, b)
    # the working buffers share nothing with the published snapshot
    lane = pool.workload(WL).resident
    assert lane.work.marg.data_ptr() != lane.snap.marg.data_ptr()
    assert lane.work.st.gen is lane.gen is not lane.snap.st.gen


@pytest.mark.parametrize("name", ["gibbs", "min-gibbs"])
def test_resident_bit_exact_vs_unserved_control(name):
    kw = dict(chains=8, sweep=8, chunk=4)
    served, control = _pool(name, **kw), _pool(name, **kw)
    # interleave resident advances with serving traffic (snapshot reads +
    # conditioned-lane forks, whose clamp redraws min-gibbs' cache) on one
    # pool, advance the other untouched
    for k in range(3):
        served.advance(WL, chunks=2)
        served.submit([Query(WL), Query(WL, evidence=((k, 1),))],
                      max_extra_sweeps=0, serve_stale=True)
        served.snapshot(WL)
    chunks = served.workload(WL).resident.sweeps // 4
    control.advance(WL, chunks=chunks)
    a, b = served.snapshot(WL), control.snapshot(WL)
    assert served.workload(WL).lanes            # forks happened
    for x, y in zip(_bits(a), _bits(b)):
        assert torch.equal(x, y)
    assert a.count == b.count == chunks * 4


def test_fork_uses_its_own_seeded_generator():
    """A lane's generator is seeded from (workload seed, signature) only:
    the same signature forks the same stream, another signature another."""
    a, b = _pool(chains=4, sweep=8, chunk=2), _pool(chains=4, sweep=8,
                                                     chunk=2)
    a.advance(WL, chunks=1)
    for p, sigs in ((a, [((0, 1),), ((1, 1),)]), (b, [((0, 1),)])):
        for s in sigs:
            p.submit([Query(WL, evidence=s)], max_extra_sweeps=0,
                     serve_stale=True)
    la, lb = (p.workload(WL).lanes for p in (a, b))
    assert torch.equal(la[((0, 1),)].snap.st.gen.get_state(),
                       lb[((0, 1),)].snap.st.gen.get_state())
    assert not torch.equal(la[((0, 1),)].snap.st.gen.get_state(),
                           la[((1, 1),)].snap.st.gen.get_state())
    assert tpool._lane_seed(0, ((0, 1),)) != tpool._lane_seed(1, ((0, 1),))


def test_snapshot_marginals_equal_the_host_sum():
    pool = _pool(chunk=4)
    pool.advance(WL, chunks=3)
    snap = pool.snapshot(WL)
    host = snap.marg.numpy().astype(np.float64).sum(0) / (
        snap.count * snap.marg.shape[0])
    assert np.array_equal(pool._snap_marginals(snap), host)


# ---------------------------------------------------------------------------
# the front end to end
# ---------------------------------------------------------------------------

def test_serve_pipeline_answers_queries():
    queries = [Query(WL), Query(WL, evidence=((0, 1),)),
               Query(WL, sites=(1,), evidence=((0, 1),), kind="map")]
    res = tserve.serve_batch(WL, queries, engine="gibbs", device="cpu",
                             chains=16, sweep=24, chunk=16,
                             max_extra_sweeps=20_000, policy=POLICY)
    assert res["n_queries"] == 3
    assert res["fresh_fraction"] == 1.0
    assert res["compiled_traces"] == 1
    clamped = res["answers"][1]
    assert clamped["marginals"][0] == [0.0, 1.0]      # observed site: delta
    assert res["answers"][2]["map_values"] == [1]     # strong partner matches
    assert res["engine"]["backend"] == "torch"


def test_launcher_writes_the_jax_schema(tmp_path):
    out = tmp_path / "serve.json"
    tserve.main(["--workload", WL, "--engine", "gibbs", "--device", "cpu",
                 "--chains", "16", "--sweep", "24", "--chunk", "16",
                 "--demo", "4", "--min-ess", "16", "--min-samples", "8",
                 "--out", str(out)])
    res = json.loads(out.read_text())
    assert res["compiled_traces"] == 1 and res["n_queries"] == 4
    keys = set(JAnswer(query=JQuery(WL), fresh=True, report={},
                       staleness_sweeps=0, sweeps=0).to_dict())
    for a in res["answers"]:
        assert set(a) == keys and a["status"] == "ok"
        for s, v in a["evidence"]:
            assert a["marginals"][s][v] == 1.0
    with pytest.raises(SystemExit):
        tserve.main(["--workload", WL, "--device", "cpu"])   # no queries


def test_load_queries_validates_before_any_chain_work(tmp_path):
    bad = tmp_path / "q.json"
    bad.write_text(json.dumps([{"evidence": [[0, 1]]}, {"sites": [99]}]))
    with pytest.raises(SystemExit, match=r"queries\[1\].*out of range"):
        tserve._load_queries(WL, str(bad), GRAPH)
    good = tmp_path / "g.json"
    good.write_text(json.dumps([{"evidence": [[5, 1], [0, 1]],
                                 "kind": "map", "priority": 2}]))
    q, = tserve._load_queries(WL, str(good), GRAPH)
    assert q.signature == ((0, 1), (5, 1)) and q.kind == "map"
