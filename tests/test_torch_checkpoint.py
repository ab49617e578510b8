"""The port's checkpoints (``repro_torch.checkpoint.checkpoint``) on torch
trees: checksums, verify, corrupt-step quarantine, the save / async_save
unification; generator and Python-number leaves; and the layout shared
with the JAX package's ``repro.checkpoint.checkpoint``: the same keys for
the same structure, the same manifest for the same arrays, and each
package's ``verify`` passing on the other's directory."""
import json
import os
import threading
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core import engine  # noqa: E402


def _tree(seed=0, n=7):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.integers(0, 5, (4, n),
                                               dtype=np.int32)),
            "w": torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))}


def test_manifest_carries_checksums_and_verify_passes(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, _tree(), extra={"engine": "mgpmh"})
    man = ckpt.read_manifest(d, 3)
    assert set(man["checksums"]) == set(man["keys"]) == {"x", "w"}
    assert all(isinstance(v, int) for v in man["checksums"].values())
    assert man["extra"] == {"engine": "mgpmh"}
    assert ckpt.verify(d, 3) == []


def test_verify_detects_array_and_manifest_damage(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _tree())
    npz = os.path.join(d, "step_00000001", "arrays.npz")
    size = os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff" * 32)
    assert ckpt.verify(d, 1) != []
    ckpt.save(d, 2, _tree())
    man_path = os.path.join(d, "step_00000002", "manifest.json")
    man = json.load(open(man_path))
    man["keys"].append("ghost")
    json.dump(man, open(man_path, "w"))
    assert any("mismatch" in p for p in ckpt.verify(d, 2))
    with open(man_path, "w") as f:
        f.write("{ not json")
    assert any("manifest" in p for p in ckpt.verify(d, 2))


def test_latest_good_step_skips_and_quarantines_corrupt(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        ckpt.save(d, s, _tree(seed=s))
    npz = os.path.join(d, "step_00000003", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        f.write(b"\x00" * 64)
    assert ckpt.latest_good_step(d) == 2
    assert ckpt.latest_good_step(d, quarantine=True) == 2
    assert os.path.isdir(os.path.join(d, "step_00000003.corrupt"))
    assert not os.path.isdir(os.path.join(d, "step_00000003"))
    assert ckpt.latest_good_step(d) == 2


def test_latest_step_skips_partial_dirs(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, _tree())
    os.makedirs(os.path.join(d, "step_00000009"))
    with open(os.path.join(d, "step_00000009", "manifest.json"), "w") as f:
        f.write("{}")
    os.makedirs(os.path.join(d, "step_00000008"))
    open(os.path.join(d, "step_00000008", "arrays.npz"), "wb").close()
    with open(os.path.join(d, "step_00000008", "manifest.json"), "w") as f:
        f.write("not json at all")
    assert ckpt.latest_step(d) == 5
    assert ckpt.latest_step(str(tmp_path / "nope")) is None


def test_save_and_async_save_write_identical_checkpoints(tmp_path):
    t = _tree(seed=42)
    d1, d2 = str(tmp_path / "sync"), str(tmp_path / "async")
    ckpt.save(d1, 7, t, extra={"k": 1})
    ckpt.async_save(d2, 7, t, extra={"k": 1})
    ckpt.wait_pending()
    m1, m2 = ckpt.read_manifest(d1, 7), ckpt.read_manifest(d2, 7)
    assert m1["checksums"] == m2["checksums"] and m1["extra"] == m2["extra"]
    r1, r2 = ckpt.restore(d1, 7, t), ckpt.restore(d2, 7, t)
    for k in t:
        assert torch.equal(r1[k], r2[k])


def test_async_save_snapshots_before_the_caller_moves_on(tmp_path):
    """The host copy is taken on the caller's thread: an in-place update
    right after ``async_save`` does not reach the checkpoint."""
    t = _tree(seed=1)
    want = t["w"].clone()
    ckpt.async_save(str(tmp_path / "ck"), 1, t)
    t["w"].add_(1.0)
    ckpt.wait_pending()
    assert torch.equal(ckpt.restore(str(tmp_path / "ck"), 1, t)["w"], want)


def test_concurrent_same_step_saves_leave_one_valid_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    trees = [_tree(seed=s) for s in range(8)]
    threads = [threading.Thread(target=ckpt.save, args=(d, 1, t))
               for t in trees]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ckpt.verify(d, 1) == []
    got = ckpt.restore(d, 1, trees[0])
    assert any(torch.equal(got["w"], t["w"]) for t in trees)
    assert not [p for p in os.listdir(d) if ".tmp" in p]


def test_async_save_pending_is_bounded(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(12):
        ckpt.async_save(d, s, _tree(seed=s))
        assert len(ckpt._PENDING) <= ckpt._MAX_PENDING
    ckpt.wait_pending()
    assert ckpt._PENDING == [] and ckpt.latest_good_step(d) == 11


def test_restore_missing_key_raises_and_keeps_stored_shape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        ckpt.restore(d, 1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    ckpt.save(d, 2, {"k": torch.zeros((8, 2), dtype=torch.int64)})
    out = ckpt.restore(d, 2, {"k": torch.zeros((4, 2), dtype=torch.int32)})
    assert out["k"].shape == (8, 2) and out["k"].dtype == torch.int32


# -- generators and Python numbers ------------------------------------------------

@pytest.mark.parametrize("name", ["mgpmh", "min-gibbs"])
def test_generator_and_int_leaves_round_trip_bit_exact(tmp_path, name):
    """A state's generator goes back into the template's generator: the
    restored state continues with the same draws as the saved one; int and
    float leaves come back as Python numbers."""
    g = engine.make_workload("hetero-pairs-24", device="cpu").graph
    eng = engine.make(name, g, sweep=4, device="cpu")
    st = eng.init(3, 4)
    for _ in range(3):
        st = eng.sweep(st)
    tree = (st, {"count": 12, "split": float("inf"), "calls": 7})
    ckpt.save(str(tmp_path / "ck"), 1, tree)
    man = ckpt.read_manifest(str(tmp_path / "ck"), 1)
    assert man["dtypes"]["0/gen"] == "uint8"
    assert man["dtypes"]["1/count"] == "int64"
    assert man["dtypes"]["1/split"] == "float64"
    like = (eng.init(99, 4), {"count": 0, "split": 0.0, "calls": 0})
    st2, extra = ckpt.restore(str(tmp_path / "ck"), 1, like)
    assert st2.gen is like[0].gen
    assert extra == {"count": 12, "split": float("inf"), "calls": 7}
    assert isinstance(extra["count"], int)
    a, b = st, st2
    for _ in range(3):
        a, b = eng.sweep(a), eng.sweep(b)
    for f in ("x", "cache", "accepts"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_adaptive_state_round_trip(tmp_path):
    """AdaptiveState holds a telemetry carry with host ints and a float
    (head, count, split) and a call counter: all survive."""
    g = engine.make_workload("hetero-pairs-24", device="cpu").graph
    eng = engine.make("gibbs", g, device="cpu",
                      schedule=engine.AdaptiveScan(sweep_len=4,
                                                   refresh_every=2))
    st = eng.init(0, 4)
    for _ in range(3):
        st = eng.sweep(st)
    ckpt.save(str(tmp_path / "ck"), 1, st)
    back = ckpt.restore(str(tmp_path / "ck"), 1, eng.init(5, 4))
    assert back.calls == st.calls == 3
    assert (back.tel.head, back.tel.count, back.tel.split) == (
        st.tel.head, st.tel.count, st.tel.split)
    a, b = st, back
    for _ in range(4):
        a, b = eng.sweep(a), eng.sweep(b)
    assert torch.equal(a.x, b.x) and torch.equal(a.cdf, b.cdf)


# -- the layout shared with the JAX package ----------------------------------------

class _NT(NamedTuple):
    x: object
    key: object
    nested: object


def test_keys_equal_jax_flatten_for_the_same_structure():
    port = (_NT(x=torch.zeros(2), key=torch.zeros(1),
                nested={"b": torch.zeros(1), "a": (torch.zeros(1), None)}),
            torch.zeros(3), None)
    jtree = (_NT(x=jnp.zeros(2), key=jnp.zeros(1),
                 nested={"b": jnp.zeros(1), "a": (jnp.zeros(1), None)}),
             jnp.zeros(3), None)
    assert sorted(ckpt.flatten(port)) == sorted(jckpt._flatten(jtree))


def _arrays():
    rng = np.random.default_rng(3)
    return {"x": rng.integers(0, 10, (16, 24)).astype(np.int32),
            "marg": rng.random((16, 24, 3)).astype(np.float32),
            "gen": rng.integers(0, 256, 5056).astype(np.uint8),
            "count": np.asarray(40, np.int64)}


def test_manifests_equal_and_verify_across_packages(tmp_path):
    arrays = _arrays()
    dp, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save(dp, 4, arrays, extra={"outer_step": 4})
    jckpt.save(dj, 4, arrays, extra={"outer_step": 4})
    mp, mj = ckpt.read_manifest(dp, 4), jckpt.read_manifest(dj, 4)
    for field in ("step", "keys", "shapes", "dtypes", "checksums", "extra"):
        assert mp[field] == mj[field], field
    assert ckpt.verify(dj, 4) == [] and jckpt.verify(dp, 4) == []
    back = ckpt.restore(dj, 4, {k: np.zeros_like(v)
                                for k, v in arrays.items()})
    for k, v in arrays.items():
        assert np.array_equal(back[k], v) and back[k].dtype == v.dtype
