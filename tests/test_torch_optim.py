"""The port's optimizer, data pipeline and gradient compression against the
JAX package, on the CPU.

  * ``data/pipeline.py``: the same batches byte for byte for any (seed,
    step, shard, num_shards), labels the next tokens with -1 at the end;
  * ``optim/adamw.py``: ``cosine_schedule``, ``clip_by_global_norm`` and
    ten ``adamw_update`` steps (warmup and cosine phases, clipping on and
    off, decay on matrices only) equal to the reference's on the same
    params and grads, rtol 1e-6 (float32 arithmetic in the same order; the
    sums of squares and the transcendental functions may round apart by
    an ulp or two).  The global norm's sum is XLA's order there, so it can
    land one ulp apart, which scales every clipped grad by an ulp; where
    an m entry nearly cancels that ulp is a larger relative difference, so
    each entry also has a floor of 1e-6 of its leaf's largest entry;
  * ``runtime/compression.py``: ``quantize_int8`` / ``dequantize_int8``
    equal to the reference's, and ``compressed_psum_mean`` on 2 gloo ranks
    (``tests/torch_dist_workers.py``: a file:// store, every rank joined
    under a deadline), two calls with the error feedback carried, equal to
    the reference function on the same inputs (run under ``jax.vmap``
    with a named axis, whose all_to_all / all_gather are the collectives'
    semantics) bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import compression as tcomp  # noqa: E402

from torch_dist_workers import compressed_rank, run_ranks  # noqa: E402

RTOL = 1e-6


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,num_shards", [(1234, 0, 1), (0, 7, 2),
                                                  (5, 123, 4)])
def test_synthetic_batches_equal_jax_byte_for_byte(seed, step, num_shards):
    for shard in range(num_shards):
        kw = dict(shard_index=shard, num_shards=num_shards, seed=seed,
                  mean_doc_len=24)
        want = jpipe.SyntheticTokens(500, 96, 8, **kw).batch(step)
        got = tpipe.SyntheticTokens(500, 96, 8, **kw).batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes()
        toks, labels = got["tokens"], got["labels"]
        assert toks.shape == labels.shape == (8 // num_shards, 96)
        np.testing.assert_array_equal(labels[:, :-1], toks[:, 1:])
        assert (labels[:, -1] == -1).all()


def test_make_batch_equals_jax():
    for step in (0, 3):
        want = jpipe.make_batch(1000, 64, 4, step=step, seed=9)
        got = tpipe.make_batch(1000, 64, 4, step=step, seed=9)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES = {"w": (8, 16), "stack": (2, 3, 5), "b": (16,), "embed": (32, 8)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def test_cosine_schedule_equals_jax():
    for base, warm, total in [(3e-4, 100, 10_000), (1e-2, 3, 10),
                              (3e-3, 0, 50)]:
        want = jadamw.cosine_schedule(base, warm, total)
        got = tadamw.cosine_schedule(base, warm, total)
        for step in [0, 1, 2, 3, 4, 9, 10, 11, 50, 99, 100, 101, 5000,
                     20_000]:
            np.testing.assert_allclose(got(step),
                                       float(want(jnp.int32(step))),
                                       rtol=RTOL)


def test_clip_by_global_norm_equals_jax():
    rng = np.random.default_rng(0)
    for scale, max_norm in [(1.0, 1.0), (0.01, 1.0), (3.0, 0.5)]:
        g = _tree(rng, scale)
        want, wnorm = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got, norm = tadamw.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(norm), float(wnorm), rtol=RTOL)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=0)


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_ten_steps_equal_jax(clip_norm):
    """The same params and per-step grads through both optimizers; the
    schedule warms up over 3 steps of 10, so both phases run."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(10)]
    lr_j = jadamw.cosine_schedule(1e-2, 3, 10)
    lr_t = tadamw.cosine_schedule(1e-2, 3, 10)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jadamw.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = tadamw.adamw_init(tp)
    for g in grads:
        jp, jst, jm = jadamw.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jst, jp, lr_fn=lr_j,
            clip_norm=clip_norm)
        tp, tst, tm = tadamw.adamw_update(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, tst, tp,
            lr_fn=lr_t, clip_norm=clip_norm)
        assert tst.step == int(jst.step)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (tst.m[k], jst.m[k]),
                              (tst.v[k], jst.v[k])):
                assert got.dtype == torch.float32
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=RTOL,
                    atol=RTOL * float(np.abs(want).max()))


def test_adamw_updates_in_place_and_decays_by_mask():
    """The parameter and moment tensors are written in place; a leaf
    outside ``decay`` takes no weight decay (zero grads: only decay moves
    a parameter)."""
    p = {"a": torch.ones(4, 4), "n": torch.ones(4)}
    st = tadamw.adamw_init(p)
    ids = {k: v.data_ptr() for k, v in p.items()}
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    out, st2, _ = tadamw.adamw_update(zeros, st, p, lr_fn=lambda s: 0.5,
                                      decay={"a": False, "n": True})
    assert {k: v.data_ptr() for k, v in out.items()} == ids
    assert st2.m["a"].data_ptr() == st.m["a"].data_ptr()
    assert torch.equal(p["a"], torch.ones(4, 4))
    torch.testing.assert_close(p["n"], torch.full((4,), 1 - 0.5 * 0.1))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_int8_equals_jax():
    rng = np.random.default_rng(2)
    for x in (rng.normal(size=257).astype(np.float32),
              np.zeros(8, np.float32),
              np.array([0.5, -1.5, 2.5, 127.0], np.float32)):
        wq, ws = jcomp.quantize_int8(jnp.asarray(x))
        q, s = tcomp.quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        assert float(s) == float(ws)
        np.testing.assert_array_equal(
            tcomp.dequantize_int8(q, s).numpy(),
            np.asarray(jcomp.dequantize_int8(wq, ws)))


def test_compressed_psum_mean_two_gloo_ranks_equal_reference(tmp_path):
    rng = np.random.default_rng(3)
    n, L = 2, 96
    xs = rng.normal(size=(n, L)).astype(np.float32)
    errs = (0.01 * rng.normal(size=(n, L))).astype(np.float32)
    got = run_ranks(compressed_rank, n, tmp_path, xs, errs, timeout=120.0)
    ref = jax.vmap(lambda x, e: jcomp.compressed_psum_mean(x, "i", e),
                   axis_name="i")
    m1, e1 = ref(jnp.asarray(xs), jnp.asarray(errs))
    m2, e2 = ref(jnp.asarray(xs) * 0.5, e1)
    for r in range(n):
        arrays, refused = got[r]
        for g, w in zip(arrays, (m1[r], e1[r], m2[r], e2[r])):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert refused, "a length the 2 ranks do not divide was not refused"
    np.testing.assert_array_equal(got[0][0][0], got[1][0][0])  # one mean
    # the int8 wire format is lossy, the error feedback carries the rest
    assert np.abs(got[0][0][0] - xs.mean(0)).max() < 0.05
