"""Training the SSM and hybrid families in the port, on the CPU against the
JAX package: the selective scan's plain backward (the CPU route of
``ops.selective_scan_bwd``, the plain version of the backward kernel in
``kernels/csrc/selective_scan.cu``), ``mamba_block``'s gradients through
``SelectiveScan``, and ``make_train_step`` / ``launch.train`` on the
falcon-mamba and hymba smoke configs.  (``tests/test_torch_train.py``
holds these configs' loss and every gradient against ``jax.grad`` of the
reference's ``loss_fn``, their decay masks and FLOPs; the backward kernel
itself is held against the plain version on the card in
``tests/test_torch_ssm.py``.)

Tolerances, each sized from the distances measured at these inputs:
  * ``SCAN_GRAD_RTOL``: the plain backward (sequential in t) against
    ``jax.grad`` of the reference's associative scan (a tree of partial
    products), both float32, relative Frobenius error per gradient;
  * ``F64_TOL``: the plain backward against float64 autograd of the plain
    forward, both float64, max abs error over the gradient's largest
    magnitude: the formulas agree to rounding;
  * ``BLOCK_GRAD_RTOL``: ``mamba_block``'s gradients against JAX's on the
    same bf16 weights (cast from the same float32 leaves) and input: the
    bf16 GEMMs round their sums in another order, a bf16 ulp here and
    there (tests/test_torch_ssm.py OUT_TOL), which the backward carries;
  * the train step: ``tests/test_torch_train.py``'s ``STEP_RTOL``,
    ``LOSS_RTOL`` and ``GRAD_RTOL``, derived there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

from test_torch_ssm import (SCAN_SHAPES, WIDTHS, _block_params,  # noqa: E402
                            _jax_scan, _scan_inputs)
from test_torch_train import (CHUNK, GRAD_RTOL, LOSS_RTOL,  # noqa: E402
                              STEP_RTOL, _batch, _jax_params, _port_model,
                              _port_opt, _rel, _stacked, _tree)

GRADS = ("ddt", "dx", "dz", "dB", "dC", "dA", "dD")
# measured at SCAN_SHAPES: at most 4.1e-7 (dA); the bound keeps about seven
# times that
SCAN_GRAD_RTOL = 3e-6
# measured at SCAN_SHAPES: at most 7.9e-16 of the largest magnitude
F64_TOL = 1e-13
# measured over six seeds at WIDTHS: at most 8.4e-3 (conv's gradient; the
# input's at most 3.7e-3); the bound keeps about three times that
BLOCK_GRAD_RTOL = 2.5e-2


def _dy(shape, seed=11):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@jax.jit
def _jax_scan_vjp(ins, dy):
    return jax.vjp(_jax_scan, *ins)[1](dy)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_plain_scan_backward_near_jax_grad(shape):
    """All seven gradients of the plain backward against ``jax.grad`` of the
    reference's scan (``src/repro/models/ssm.py:61-72``) on the same
    float32 inputs and output gradient."""
    bsz, S, di, N = shape
    ins = _scan_inputs(sum(shape), *shape)
    dy = _dy((bsz, S, di))
    want = _jax_scan_vjp(tuple(map(jnp.asarray, ins)), jnp.asarray(dy))
    got = ops.selective_scan_bwd(*map(torch.from_numpy, ins),
                                 torch.from_numpy(dy))
    for name, g, w, x in zip(GRADS, got, want, ins):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape, name
        rel = _rel(g.numpy(), np.asarray(w))
        assert rel < SCAN_GRAD_RTOL, (name, rel)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_plain_scan_backward_equals_float64_autograd(shape):
    """The hand-derived formulas of the plain backward against autograd
    through the plain forward (``selective_scan_ref``), both in float64:
    equal to rounding."""
    bsz, S, di, N = shape
    ins = [torch.from_numpy(a.astype(np.float64))
           for a in _scan_inputs(sum(shape) + 1, *shape)]
    dy = torch.from_numpy(_dy((bsz, S, di), seed=12).astype(np.float64))
    leaves = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(tref.selective_scan_ref(*leaves), leaves, dy)
    got = tref.selective_scan_bwd_ref(*ins, dy)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= F64_TOL * max(float(w.abs().max()), 1.0), (name, err)


def test_plain_scan_backward_dtypes_and_strided_z():
    """The gradients come back in their inputs' dtypes (dz in z's bf16)
    whatever z's strides; a bf16 dy is the float32 one rounded."""
    ins = [torch.from_numpy(a) for a in _scan_inputs(5, 2, 9, 16, 8)]
    z16 = torch.cat([ins[2], ins[2]], -1).to(torch.bfloat16)[..., 16:]
    dy = torch.from_numpy(_dy((2, 9, 16))).to(torch.bfloat16)
    got = ops.selective_scan_bwd(*ins[:2], z16, *ins[3:], dy)
    want = ops.selective_scan_bwd(*ins[:2], z16.float().contiguous(),
                                  *ins[3:], dy.float())
    assert got[2].dtype == torch.bfloat16 and got[2].is_contiguous()
    assert torch.equal(got[2], want[2].to(torch.bfloat16))
    for name, g, w, x in zip(GRADS, got, want, ins):
        if name != "dz":
            assert g.dtype == x.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("widths", WIDTHS)
def test_mamba_block_gradients_near_jax(widths):
    """``mamba_block``'s gradients with respect to its bf16 input and all
    nine float32 leaves (cast as the model casts them: two or more
    dimensions to bf16) against ``jax.grad`` of the reference's
    ``mamba_block`` on the same numpy inputs, weights and output
    gradient."""
    d, di, N, K, r = widths
    p = _block_params(13, *widths)
    x = np.random.default_rng(14).normal(size=(2, 24, d)).astype(np.float32)
    dout = _dy((2, 24, d), seed=15)

    def jloss(p32, xb):
        pc = {k: v.astype(jnp.bfloat16) if v.ndim >= 2 else v
              for k, v in p32.items()}
        out = jssm.mamba_block(xb, pc, n_state=N, conv_kernel=K)
        return jnp.sum(out.astype(jnp.float32) * dout)
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(jnp.bfloat16))

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    pc = {k: v.to(torch.bfloat16) if v.dim() >= 2 else v
          for k, v in tp.items()}
    out = tssm.mamba_block(tx, pc, n_state=N, conv_kernel=K)
    (out.float() * torch.from_numpy(dout)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    rel = _rel(tx.grad.float().numpy(),
               np.asarray(jgx.astype(jnp.float32)))
    assert rel < BLOCK_GRAD_RTOL, ("x", rel)
    for name in tssm.Mamba.LEAVES:
        g = tp[name].grad
        assert g.dtype == torch.float32, name
        rel = _rel(g.numpy(), np.asarray(jgp[name]))
        assert rel < BLOCK_GRAD_RTOL, (name, rel)


def test_hymba_train_step_near_jax():
    """tests/test_torch_train.py's train-step test on hymba-smoke (mamba
    and attention heads in parallel, then the MLP): two steps, each from
    the reference's own params and AdamW state, loss, grad_norm and lr near
    JAX's and each leaf's update within ``STEP_RTOL`` of JAX's.  The
    embedding's rows first seen in the second step's batch start from zero
    moments there, and move by lr sign(g) as every entry does in a first
    step (measured: 0.099 at the second step, against 0.080 on tinyllama's
    four-sequence batch), so the embedding keeps the first step's bound.
    Measured on the other leaves: at most 0.18 at the first step (ln2), 0.044
    at the second (dt_bias); loss within 2.7e-4, grad_norm within 2.8e-4."""
    name = "hymba-1.5b"
    jcfg, jp = _jax_params(name)
    cfg = treg.get_arch(name, smoke=True)
    sched = dict(base_lr=1e-2, warmup=2, total_steps=10, loss_chunk=CHUNK)
    jstep = jax.jit(jsteps.make_train_step(jcfg, **sched))
    step = tsteps.make_train_step(cfg, **sched)
    jopt = jadamw.adamw_init(jp)
    for seed in (5, 9):
        toks, labels = _batch(jcfg, seed=seed, batch=2)
        jp2, jopt2, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
        model = _port_model(name, jp)
        model, opt, m = step(model, _port_opt(name, jopt),
                             {"tokens": toks, "labels": labels})
        assert opt.step == int(jopt2.step)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_RTOL)
        old = tckpt.flatten(_tree(jp))
        for path, want in tckpt.flatten(_tree(jp2)).items():
            p0 = old[path].astype(np.float64)
            got = _stacked(model, cfg, path, attr=None) - p0
            rel = _rel(got, want - p0)
            bound = STEP_RTOL[opt.step > 1 and path != "embed"]
            assert rel < bound, (opt.step, path, rel)
        assert all(p.grad is None for p in model.parameters())
        jp, jopt = jp2, jopt2


def test_hymba_train_resume_after_failure_is_bit_exact(tmp_path, capsys):
    """A crashed hymba-smoke run resumes from its checkpoint and ends with
    the same loss, parameters and AdamW state as an uninterrupted run, bit
    for bit (the scan's and the attention's plain backwards are
    deterministic)."""
    cfg = treg.get_arch("hymba-1.5b", smoke=True)
    kw = dict(steps=4, global_batch=2, seq=16, ckpt_every=2, lr=1e-3,
              log_every=4, device="cpu")
    ck1, ck2 = str(tmp_path / "a"), str(tmp_path / "b")
    loss_ref, _ = ttrain.train(cfg, ckpt_dir=ck1, **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train(cfg, ckpt_dir=ck2, fail_at_step=3, **kw)
    assert tckpt.latest_step(ck2) == 2
    loss_resumed, _ = ttrain.train(cfg, ckpt_dir=ck2, **kw)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert loss_resumed == loss_ref
    states = []
    for ck in (ck1, ck2):
        model = tT.init_params(cfg, seed=0, device="cpu", master=True)
        opt = ttrain._restore(ck, 4, model)
        states.append((dict(model.named_parameters()), opt))
    (pa, oa), (pb, ob) = states
    assert oa.step == ob.step == 4
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        assert torch.equal(oa.m[k], ob.m[k]) and torch.equal(oa.v[k],
                                                             ob.v[k]), k


def test_train_cli_falcon_mamba_smoke(tmp_path, capsys):
    ttrain.main(["--arch", "falcon-mamba-7b", "--smoke", "--steps", "2",
                 "--global-batch", "2", "--seq", "32", "--ckpt-dir",
                 str(tmp_path / "ck"), "--ckpt-every", "1", "--device",
                 "cpu"])
    out = capsys.readouterr().out
    assert "[train] step     2 loss=" in out and "[train] done" in out
    assert tckpt.latest_step(str(tmp_path / "ck")) == 2
