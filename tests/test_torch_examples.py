"""The paper's remaining entry points in the port, on the CPU:
``core.init_chains`` against ``Engine.init``'s layout, and each example
(``examples/torch_*.py``) through its ``main`` at a tiny size with
``--device cpu``: it runs to the end and prints the reference example's
quantities (finite errors that fall, acceptance rates, the adaptive-scan
summary, a training loss)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

from repro_torch.core import engine, init_chains, make_potts_graph  # noqa
from repro_torch.core import samplers  # noqa: E402
from repro_torch.core.samplers import ChainState  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("start", ["constant", "random"])
def test_init_chains_has_engine_init_layout(start):
    """Chains stacked from a single-chain init_fn: Engine.init's fields,
    shapes, dtypes and device, the state owning the generator; on the CPU
    the same values as Engine.init from the same seed (one stream, drawn
    in chain order)."""
    g = make_potts_graph(4, 2.0, 3, device="cpu")
    eng = engine.make("gibbs", g, sweep=4, device="cpu")
    want = eng.init(torch.Generator().manual_seed(3), 5, start=start)
    gen = torch.Generator().manual_seed(3)
    got = init_chains(gen, g, 5,
                      lambda gn, gr: samplers.init_state(gn, gr, 1,
                                                         start=start))
    assert isinstance(got, ChainState) and got.gen is gen
    for field in ("x", "cache", "accepts"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.device == b.device and torch.equal(a, b), field
    # an unbatched single-chain state (x of shape (n,)) stacks the same way
    flat = init_chains(torch.Generator().manual_seed(3), g, 5, lambda gn, gr:
                       ChainState(samplers.init_state(gn, gr, 1, start=start)
                                  .x[0], torch.zeros(()), gn,
                                  torch.zeros((), dtype=torch.int32)))
    assert torch.equal(flat.x, want.x)
    # the engine's sweep takes the stacked state
    out = eng.sweep(got)
    assert out.x.shape == (5, g.n)


def test_quickstart(capsys):
    res = _example("torch_quickstart").main(["--device", "cpu", "--iters",
                                             "1600"])
    out = capsys.readouterr().out
    assert "MGPMH    marginal error:" in out and "acceptance rate" in out
    for tr in (res["mgpmh"], res["gibbs"]):
        err = tr.error.numpy()
        assert np.isfinite(err).all() and err[-1] < err[0]
    assert 0.5 < res["acceptance"] <= 1.0


def test_ising_min_gibbs(capsys):
    errors = _example("torch_ising_min_gibbs").main(
        ["--device", "cpu", "--iters", "320"])
    out = capsys.readouterr().out
    assert "Ising n=64" in out and "min lam= 4.0Psi^2" in out
    assert set(errors) == {"gibbs", "min 0.25", "min 1.0", "min 4.0"}
    for err in errors.values():
        assert err.shape == (8,) and np.isfinite(err).all()
        assert err[-1] < err[0]


def test_potts_mgpmh(capsys):
    out = _example("torch_potts_mgpmh").main(["--device", "cpu", "--iters",
                                              "640"])
    text = capsys.readouterr().out
    assert "mgpmh lam=4.0L^2" in text and "double l2=2.0Psi^2" in text
    for mult in (1.0, 2.0, 4.0):
        err, acc = out[f"mgpmh {mult}"]
        assert np.isfinite(err).all() and 0.0 < acc <= 1.0
    assert all(np.isfinite(out[f"double {m}"]).all() for m in (1.0, 2.0))


def test_adaptive_scan(capsys):
    res = _example("torch_adaptive_scan").main(
        ["--device", "cpu", "--snapshots", "4", "--pilot-calls", "2"])
    out = capsys.readouterr().out
    assert "uniform scan" in out and "adaptive scan" in out
    assert "lambda auto-tuner: lam=4@" in out
    assert res["autotune"] and res["autotune"][0]["lam"] == 4.0


def _small_lm():
    """The LM example with the ~100M config cut, for the CPU, to one layer
    and a 512-token vocabulary (its 32000 spend seconds drawing the
    embeddings alone)."""
    mod = _example("torch_train_lm")
    mod.CONFIG = dataclasses.replace(mod.CONFIG, vocab_size=512,
                                     num_layers=1)
    return mod


LM_ARGS = ["--device", "cpu", "--steps", "2", "--global-batch", "2",
           "--seq", "32"]


def test_train_lm(capsys, tmp_path, monkeypatch):
    """By default the example writes no checkpoint anywhere."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    loss, hist = _small_lm().main(LM_ARGS)
    out = capsys.readouterr().out
    assert "params: " in out and "final loss:" in out
    assert np.isfinite(loss) and hist[-1]["step"] == 2
    assert list(tmp_path.iterdir()) == []


def test_train_lm_rerun_resumes_at_its_end(capsys, tmp_path):
    """A rerun into the same --ckpt-dir resumes at --steps, runs no step
    and ends cleanly with no final loss to print."""
    mod, ck = _small_lm(), str(tmp_path / "ck")
    loss, _ = mod.main(LM_ARGS + ["--ckpt-dir", ck])
    assert np.isfinite(loss) and "final loss:" in capsys.readouterr().out
    loss, hist = mod.main(LM_ARGS + ["--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert loss is None and hist == []
    assert "resumed from step 2" in out and "final loss:" not in out
