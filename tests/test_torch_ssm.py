"""The port's Mamba-1 block (``models/ssm.py``) and its selective-scan kernel
(``kernels/selective_scan.py``) on the CPU against the JAX package — and,
on a machine with a CUDA card, the kernel against its plain version.

  * the plain scan (``ref.selective_scan_ref``, the CPU route of
    ``ops.selective_scan``) against a ``jax.lax.associative_scan`` of the
    same float32 inputs, with the reference's C contraction, D skip and
    gate (``src/repro/models/ssm.py:61-72``);
  * ``_ssm_params``, ``mamba_block`` and 24 ``mamba_decode_step``s against
    the JAX functions on the same bf16 weights and inputs (numpy from a
    seed), at the smoke configs' SSM widths and at N=16 with a d_inner
    that is not a power of two;
  * ``init_ssm_cache``'s layout; the wrappers' refusals (state sizes they
    are not built for, z's and dy's dtype and layout, CPU tensors) before
    any launch;
  * the kernel's layout (``scan_layout``, lanes a channel chosen from the
    shape) at every shape the card runs it at: valid, the fewest lanes
    that reach the launch target, every built instance reached, the
    model layers' warps a scheduler; the backward's (``scan_bwd_layout``:
    four or two states a lane by shape, 16-step chunks), the forward's
    checkpoints and the backward's scratch;
  * the plain forward's checkpoints (every 16th state) against a float64
    recurrence, and the plain backward handed them giving the same
    gradients as without;
  * ``SelectiveScan`` (the scan with its gradient) on the CPU: the plain
    backward's gradients, and no graph without grad;
  * (gpu) the kernel against its plain version at ragged shapes and the
    layout's edges, bit-equal between launches, z read in place from the
    input projection; the library's layout equal to ``scan_layout``'s;
    the backward kernel against its plain version at the model layers'
    shapes and ragged ones, bit-equal between launches, its layout equal
    to ``scan_bwd_layout``'s, and ``mamba_block``'s backward through it.

The backward's plain version against ``jax.grad`` and float64 autograd,
and training the SSM and hybrid families, are in
``tests/test_torch_ssm_train.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as tscan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

try:    # the JAX reference; a machine with the card may have no JAX, and
    # runs only the gpu tests below, which do not read it
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

# (bsz, S, d_inner, N): one tile of steps and less, several tiles, S = 1,
# a ragged d_inner
SCAN_SHAPES = [(2, 24, 32, 8), (1, 64, 16, 16), (3, 1, 8, 8),
               (2, 200, 24, 16)]
# The plain scan (sequential in t) against the associative scan (a tree of
# partial products): both float32, other association orders.  Measured at
# SCAN_SHAPES: max abs diff 1.4e-6 (|y| up to 32), relative to |y| + 1e-3
# at most 7.8e-5.  The bound keeps about seven times that margin.
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# (d_model, d_inner, N, conv_kernel, dt_rank): the SSM branch of the
# falcon-mamba and hymba smoke configs (the same widths), and N=16 with a
# d_inner that is not a power of two (as hymba-1.5b's 3200)
WIDTHS = [(128, 256, 8, 4, 16), (64, 96, 16, 4, 8)]
# Port vs JAX on the same bf16 weights.  _ssm_params: float32 GEMMs of the
# same bf16 weights, softplus's formula apart (measured: dt within 1.7e-7
# relative, B, C, A equal).  The bf16 GEMMs (x @ w_in, y @ w_out) round
# their sums in another order, so a bf16 value here and there lands one ulp
# apart and travels on.  Measured over 8 seeds at both WIDTHS: mamba_block
# and decode outputs (|y| up to ~1.6) max abs diff 0.00195, one bf16 ulp
# of a value in [0.25, 0.5); the decode's float32 state within 3.6e-3 of
# |state| + 1e-3; the bf16 conv history one ulp at most.  The bounds keep
# about twice that.
PARAMS_TOL = dict(rtol=1e-6, atol=1e-7)
OUT_TOL = dict(rtol=2.0 ** -7, atol=4e-3)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)
STATE_TOL = dict(rtol=1e-2, atol=1e-5)


def _scan_inputs(seed, bsz, S, di, N):
    """float32 dt (softplus around the models' -4.6 bias), x, z, B, C,
    A < 0 (log(1..N) scaled per entry), D."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(-2.6, 1.0, (bsz, S, di))))
    A = -np.arange(1, N + 1)[None, :] * rng.uniform(0.5, 1.5, (di, N))
    arrays = (dt, rng.normal(size=(bsz, S, di)),
              rng.normal(size=(bsz, S, di)), rng.normal(size=(bsz, S, N)),
              rng.normal(size=(bsz, S, N)), A, rng.normal(size=(di,)))
    return tuple(a.astype(np.float32) for a in arrays)


def _jax_scan(dt, x, z, B, C, A, D):
    """The reference's scan (``mamba_block``, ``:63-72``) on given
    inputs, in float32 (no final cast)."""
    decay = jnp.exp(dt[..., None] * A[None, None])
    drive = (dt * x)[..., None] * B[:, :, None, :]

    def combine(a, b):
        (da, ua), (db, ub) = a, b
        return da * db, ua * db + ub

    _, h = jax.lax.associative_scan(combine, (decay, drive), axis=1)
    y = jnp.einsum("bsdn,bsn->bsd", h, C) + x * D
    return y * jax.nn.silu(z)


@needs_jax
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_plain_scan_equals_associative_scan(shape):
    ins = _scan_inputs(sum(shape), *shape)
    want = np.asarray(_jax_scan(*map(jnp.asarray, ins)))
    got = ops.selective_scan(*map(torch.from_numpy, ins))
    assert got.dtype == torch.float32        # z's dtype
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


def test_plain_scan_casts_to_z_dtype_and_reads_strided_views():
    ins = [torch.from_numpy(a) for a in _scan_inputs(3, 2, 10, 16, 8)]
    want = tref.selective_scan_ref(*ins)
    dt, x, z, B, C, A, D = ins
    # z as the gate half of an input projection, B and C as views of one
    zz = torch.cat([torch.zeros_like(z), z], -1)[..., 16:]
    bc = torch.cat([B, C], -1)
    got = ops.selective_scan(dt, x, zz, bc[..., :8], bc[..., 8:], A, D)
    # the CPU's vector paths for strided and contiguous operands may sum
    # in other orders: float32 rounding apart
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    y16 = ops.selective_scan(dt, x, z.to(torch.bfloat16), B, C, A, D)
    assert y16.dtype == torch.bfloat16
    ref16 = (tref.selective_scan_ref(dt, x, z.to(torch.bfloat16).float(),
                                     B, C, A, D)).to(torch.bfloat16)
    assert torch.equal(y16, ref16)


def _block_params(seed, d, di, N, K, r):
    """The reference's leaves at the given widths: random w_in, conv,
    w_x, w_dt, w_out (std fan_in^-0.5), conv_bias N(0, 0.1), A_log =
    log(1..N), dt_bias -4.6, D one; numpy float32."""
    rng = np.random.default_rng(seed)
    fan = {"w_in": (d, (d, 2 * di)), "conv": (K, (K, di)),
           "w_x": (di, (di, r + 2 * N)), "w_dt": (r, (r, di)),
           "w_out": (di, (di, d))}
    p = {k: rng.normal(size=shape) / f ** 0.5
         for k, (f, shape) in fan.items()}
    p["conv_bias"] = 0.1 * rng.normal(size=(di,))
    p["A_log"] = np.log(np.arange(1, N + 1))[None, :].repeat(di, 0)
    p["dt_bias"] = np.full((di,), -4.6)
    p["D"] = np.ones((di,))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    """The leaves as the reference computes with them (``_cast_params``:
    two or more dimensions in bf16), for JAX and for the port."""
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) if v.ndim >= 2
          else jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) if v.ndim >= 2
          else torch.from_numpy(v) for k, v in p.items()}
    return jp, tp


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@needs_jax
@pytest.mark.parametrize("widths", WIDTHS)
def test_ssm_params_equal_jax(widths):
    d, di, N, K, r = widths
    jp, tp = _both(_block_params(1, *widths))
    xc = np.random.default_rng(2).normal(size=(2, 24, di)).astype(
        np.float32)
    want = jssm._ssm_params(jnp.asarray(xc), jp, N)
    got = tssm._ssm_params(torch.from_numpy(xc), tp, N)
    for name, g, w in zip(("dt", "B", "C", "A"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PARAMS_TOL,
                                   err_msg=name)


@needs_jax
@pytest.mark.parametrize("widths", WIDTHS)
def test_mamba_block_equals_jax(widths):
    d, di, N, K, r = widths
    jp, tp = _both(_block_params(3, *widths))
    x = np.random.default_rng(4).normal(size=(2, 24, d)).astype(np.float32)
    want = jssm.mamba_block(jnp.asarray(x).astype(jnp.bfloat16), jp,
                            n_state=N, conv_kernel=K)
    got = tssm.mamba_block(torch.from_numpy(x).to(torch.bfloat16), tp,
                           n_state=N, conv_kernel=K)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 24, d)
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **OUT_TOL)


@needs_jax
@pytest.mark.parametrize("widths", WIDTHS)
def test_mamba_decode_step_equals_jax(widths):
    """24 steps from an empty cache (conv in bf16, state in float32, as
    the model's decode cache keeps them)."""
    d, di, N, K, r = widths
    jp, tp = _both(_block_params(5, *widths))
    x = np.random.default_rng(6).normal(size=(2, 24, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jc = jssm.init_ssm_cache(2, di, K, N)
    jc = jssm.SSMCache(jc.conv.astype(jnp.bfloat16), jc.state)
    tc = tssm.SSMCache(torch.zeros((2, K - 1, di), dtype=torch.bfloat16),
                       torch.zeros((2, di, N)))
    for s in range(24):
        jo, jc = jssm.mamba_decode_step(jx[:, s:s + 1], jp, jc, n_state=N,
                                        conv_kernel=K)
        to, tc = tssm.mamba_decode_step(tx[:, s:s + 1], tp, tc, n_state=N,
                                        conv_kernel=K)
        assert to.dtype == torch.bfloat16 and tuple(to.shape) == (2, 1, d)
        assert tc.conv.dtype == torch.bfloat16
        assert tc.state.dtype == torch.float32
        np.testing.assert_allclose(to.float().numpy(), _f32(jo), **OUT_TOL)
        np.testing.assert_allclose(tc.conv.float().numpy(), _f32(jc.conv),
                                   **BF16_ULP)
        np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state),
                                   **STATE_TOL)


@needs_jax
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_cache_layout_equals_jax(dtype):
    want = jssm.init_ssm_cache(3, 40, 4, 16, dtype=getattr(jnp, dtype))
    got = tssm.init_ssm_cache(3, 40, 4, 16, dtype=getattr(torch, dtype),
                              device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not bool(g.any())


def test_mamba_decode_step_takes_one_token():
    p = {k: torch.from_numpy(v) for k, v in
         _block_params(0, 16, 32, 8, 4, 4).items()}
    cache = tssm.init_ssm_cache(1, 32, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        tssm.mamba_decode_step(torch.zeros((1, 2, 16)), p, cache, n_state=8)


def test_mamba_module_holds_the_reference_leaves():
    cfg = treg.get_arch("falcon-mamba-7b", smoke=True)
    m = tssm.Mamba(cfg, device="cpu")
    assert tuple(n for n, _ in m.named_parameters()) == tssm.Mamba.LEAVES
    for name, p in m.named_parameters():
        assert tuple(p.shape) == tssm.Mamba.shapes(cfg)[name]
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2
                           else torch.float32), name
    master = tssm.Mamba(cfg, device="cpu", master=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in master.parameters())
    assert all(w.dtype == (torch.bfloat16 if w.dim() >= 2
                           else torch.float32)
               for w in master.weights().values())


# ---------------------------------------------------------------------------
# the kernel's wrapper: refusals before any launch
# ---------------------------------------------------------------------------

def _kernel_args(bsz=2, S=5, di=12, N=8):
    dt, x, z, B, C, A, D = (torch.from_numpy(a) for a in
                            _scan_inputs(0, bsz, S, di, N))
    return [dt, x, z.to(torch.bfloat16), B, C, A, D]


@pytest.mark.parametrize("N", [4, 12, 32])
def test_scan_kernel_refuses_state_sizes_it_is_not_built_for(N):
    with pytest.raises(ValueError, match=f"state size N={N}"):
        tscan.selective_scan_cuda(*_kernel_args(N=N))


def test_scan_kernel_refusals():
    args = _kernel_args()
    before = tscan.selective_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.selective_scan_cuda(*args)
    bad = list(args)
    bad[2] = args[2].float()
    with pytest.raises(ValueError, match="z must be torch.bfloat16"):
        tscan.selective_scan_cuda(*bad)
    bad[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="evenly spaced rows"):
        tscan.selective_scan_cuda(*bad)
    bad = list(args)
    bad[3] = torch.cat([args[3], args[4]], -1)[..., :8]   # a strided view
    with pytest.raises(ValueError, match="B must be contiguous"):
        tscan.selective_scan_cuda(*bad)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        tscan.selective_scan_cuda(*bad)
    with pytest.raises(ValueError, match="batch 65536"):
        tscan.selective_scan_cuda(*_kernel_args(bsz=65536, S=1, di=2))
    with pytest.raises(ValueError, match="d_inner 13 is odd"):
        tscan.selective_scan_cuda(*_kernel_args(di=13))
    bad = list(args)
    bad[2] = torch.cat([args[2], args[2]], -1)[..., 11:23]  # odd offset
    with pytest.raises(ValueError, match="4-byte aligned"):
        tscan.selective_scan_cuda(*bad)
    assert tscan.selective_scan_cuda.launches == before
    # the gate half of an input projection is taken in place
    zz = torch.cat([args[2], args[2]], -1)[..., 12:]
    assert tscan._row_stride(zz, 5, 12) == 24


def test_scan_bwd_kernel_refusals():
    """The backward wrapper checks its inputs as the forward's does, dy,
    and the checkpoints (the forward's shape, float32, contiguous, 16-byte
    aligned, as B and C), before any launch."""
    args = _kernel_args(S=40)
    dy = torch.zeros((2, 40, 12), dtype=torch.bfloat16)
    ck = torch.zeros((2, 2, 12, 8))
    before = tscan.selective_scan_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.selective_scan_bwd_cuda(*args, dy, ck)
    with pytest.raises(ValueError, match="state size N=4"):
        tscan.selective_scan_bwd_cuda(*_kernel_args(N=4), dy, ck)
    with pytest.raises(ValueError, match="d_inner 13 is odd"):
        tscan.selective_scan_bwd_cuda(*_kernel_args(di=13), dy, ck)
    bad = list(args)
    bad[2] = args[2].float()
    with pytest.raises(ValueError, match="z must be torch.bfloat16"):
        tscan.selective_scan_bwd_cuda(*bad, dy, ck)
    for wrong in (dy.float(), dy[:, :4],
                  dy.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="dy must be contiguous"):
            tscan.selective_scan_bwd_cuda(*args, wrong, ck)
    with pytest.raises(ValueError, match="dy must start 4-byte aligned"):
        tscan.selective_scan_bwd_cuda(
            *args, torch.zeros(961, dtype=torch.bfloat16)[1:].view(2, 40, 12),
            ck)
    for wrong in (ck[:, :1], ck.double(), ck.transpose(2, 3)):
        with pytest.raises(ValueError, match="ckpt must"):
            tscan.selective_scan_bwd_cuda(*args, dy, wrong)
    with pytest.raises(ValueError, match="ckpt must start 16-byte aligned"):
        tscan.selective_scan_bwd_cuda(
            *args, dy, torch.zeros(385)[1:].view(2, 2, 12, 8))
    bad = list(args)
    bad[3] = torch.zeros(641)[1:].view(2, 40, 8)
    with pytest.raises(ValueError, match="B must start 16-byte aligned"):
        tscan.selective_scan_bwd_cuda(*bad, dy, ck)
    assert tscan.selective_scan_bwd_cuda.launches == before


def test_selective_scan_function_takes_the_plain_backward_on_the_cpu():
    """With grad on, mamba_block's scan is ``SelectiveScan``: its gradients
    are the plain backward's (``ops.selective_scan_bwd``) for the bf16
    output's gradient, bit for bit, each in its input's dtype; without
    grad no graph is built."""
    ins = [torch.from_numpy(a) for a in _scan_inputs(7, 2, 20, 16, 8)]
    ins[2] = torch.cat([ins[2], ins[2]], -1).to(torch.bfloat16)[..., 16:]
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    y = tssm.SelectiveScan.apply(*leaves)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ops.selective_scan(*ins))
    dy = torch.from_numpy(np.random.default_rng(8).normal(
        size=tuple(y.shape)).astype(np.float32)).to(torch.bfloat16)
    y.backward(dy)
    want = ops.selective_scan_bwd(*ins, dy)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, w)
    p = {k: torch.from_numpy(v).to(torch.bfloat16) if v.ndim >= 2
         else torch.from_numpy(v)
         for k, v in _block_params(0, 16, 32, 8, 4, 4).items()}
    with torch.no_grad():
        out = tssm.mamba_block(torch.zeros((1, 4, 16), dtype=torch.bfloat16),
                               p, n_state=8)
    assert out.grad_fn is None


def _f64_states(dt, x, B, A):
    """h_t of every step by a float64 recurrence in numpy: (bsz, S, di,
    N)."""
    dt, x, B, A = (np.asarray(a, np.float64) for a in (dt, x, B, A))
    h = np.zeros((dt.shape[0], dt.shape[2], A.shape[1]))
    out = np.empty((dt.shape[1], *h.shape))
    for t in range(dt.shape[1]):
        h = (np.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :])
        out[t] = h
    return out.transpose(1, 0, 2, 3)


@pytest.mark.parametrize("S", [1, 16, 17, 40, 48])
def test_plain_scan_checkpoints(S):
    """``selective_scan_ref(..., checkpoints=True)``: the same y, and the
    states after steps 15, 31, ... before the last step, equal to a float64
    recurrence (float64 inputs: to its rounding; float32: within float32's
    rounding of the recurrence); the plain backward gives the same
    gradients, bit for bit, whether or not it is handed them."""
    shape = (2, S, 12, 8)
    ins = [torch.from_numpy(a) for a in _scan_inputs(S, *shape)]
    ins[2] = ins[2].to(torch.bfloat16)
    want = _f64_states(*(ins[k].numpy() for k in (0, 1, 3, 5)))
    steps = list(range(15, S - 1, 16))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        cast = [t if k == 2 else t.to(dtype) for k, t in enumerate(ins)]
        y, ck = tref.selective_scan_ref(*cast, checkpoints=True)
        assert torch.equal(y, tref.selective_scan_ref(*cast))
        assert ck.dtype == dtype and tuple(ck.shape) == (
            2, (S - 1) // 16, 12, 8) == (2, len(steps), 12, 8)
        np.testing.assert_allclose(ck.numpy(), want[:, steps], rtol=tol,
                                   atol=tol)
    dy = torch.from_numpy(np.random.default_rng(S).normal(
        size=shape[:3]).astype(np.float32)).to(torch.bfloat16)
    plain = ops.selective_scan_bwd(*ins, dy)
    given = ops.selective_scan_bwd(*ins, dy, ck)
    for g, w in zip(given, plain):
        assert torch.equal(g, w)
    # a checkpoint off by one step moves the gradients: the backward reads
    # them where the forward wrote them
    if steps:
        off = ops.selective_scan_bwd(
            *ins, dy, torch.from_numpy(want[:, [t - 1 for t in steps]])
            .float())
        assert not torch.equal(off[0], plain[0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# the plain version and the kernel on the card: the same products and sums
# of the state in the same order but the exponentials (ex2.approx against
# expf, a few float32 ulps) and the sum over n (pairwise in a lane, then a
# tree across lanes, against PyTorch's order): one bf16 rounding of y can
# land on the other side (one ulp, 2^-7 relative at most), near-zero y off
# by float32 rounding of its terms
CARD_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
# (bsz, S, d_inner, N): S = 1, S not a multiple of the time tile, d_inner
# not a multiple of the 32-channel block, N = 8 and 16, the smoke width,
# hymba-1.5b's d_inner; then the layout's edges (chip_smoke.py
# SCAN_SHAPES): S one past a tile (32 steps at 16 and 8 lanes, 16 at 4),
# d_inner off the block at every lane count of both N, hymba-1.5b's B=1
# layer
CARD_SHAPES = [(2, 1, 64, 16), (1, 100, 64, 16), (2, 70, 100, 16),
               (3, 130, 200, 8), (2, 24, 256, 8), (1, 257, 3200, 16),
               (1, 33, 64, 16), (3, 33, 3000, 16), (5, 17, 3394, 16),
               (17, 5, 2002, 16), (34, 3, 2000, 16), (2, 21, 4002, 8),
               (3, 6, 6002, 8), (9, 4, 4002, 8), (40, 3, 2002, 8),
               (1, 4096, 3200, 16)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


_CS = _chip_smoke()
LAYOUT_SHAPES = sorted(set(CARD_SHAPES) | set(_CS.SCAN_SHAPES))
# the lanes the kernel aims to launch: 14 warps on each of the H100's 132
# SMs (csrc/selective_scan.cu kTargetLanes)
TARGET_LANES = 14 * 132 * 32


@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
def test_scan_layout_is_valid_and_the_fewest_lanes(shape):
    bsz, S, di, N = shape
    lay = tscan.scan_layout(*shape)
    L = lay["lanes"]
    assert L in (1, 2, 4, 8, 16) and N % L == 0
    assert lay["states_per_lane"] * L == N
    assert lay["threads"] == 32 * L == lay["channels"] * L
    assert lay["blocks"] == -(-di // 32) * bsz
    assert lay["tile"] == (32 if L >= 8 else 16)
    # the fewest lanes that reach the target, else N
    assert L == N or bsz * di * L >= TARGET_LANES
    assert L == 1 or bsz * di * (L // 2) < TARGET_LANES
    assert lay["warps_per_scheduler"] == pytest.approx(
        lay["blocks"] * L / (4 * 132))


def test_scan_layout_reaches_every_instance_and_fills_the_card():
    """Every built instance (N = 16 at 1-16 lanes, N = 8 at 1-8) is reached
    by some shape the card runs; the model layers launch at least 3.5 warps
    a scheduler (falcon-mamba-7b's at 8 lanes: 16 lanes, 7.8 warps, ran
    slower on the H100, PERF.md row 11)."""
    reached = {(sh[3], tscan.scan_layout(*sh)["lanes"]) for sh in CARD_SHAPES}
    assert reached == {(16, L) for L in (1, 2, 4, 8, 16)} | {
        (8, L) for L in (1, 2, 4, 8)}
    for shape in _CS.SCAN_MODEL_SHAPES.values():
        assert tscan.scan_layout(*shape)["warps_per_scheduler"] >= 3.5
    assert tscan.scan_layout(1, 4096, 8192, 16)["lanes"] == 8
    assert tscan.scan_layout(8, 2048, 3200, 16)["lanes"] == 4
    with pytest.raises(ValueError, match="state size N=4"):
        tscan.scan_layout(1, 8, 64, 4)


# (bsz, S, d_inner, N) of the backward on the card: each model layer
# (falcon-mamba-7b's, hymba-1.5b's at B=8 and B=1), S = 1, S off the
# 16-step chunk, S = 16 and 48 (no chunk partial), d_inner off the
# 32-channel block at both layouts (two and four states a lane) and both
# N, N = 8 and 16: chip_smoke.py's SCAN_BWD_SHAPES
BWD_CARD_SHAPES = _CS.SCAN_BWD_SHAPES


@pytest.mark.parametrize("shape", BWD_CARD_SHAPES)
def test_scan_bwd_layout_and_scratch(shape):
    """The backward's layout: four contiguous states a lane where that
    launches 7 warps an SM, else two; 32 channels a block, 16-step chunks
    (the forward's checkpoint interval), its shared memory within a third
    of the H100's 228 KB an SM (three blocks an SM); the forward's
    checkpoints (every chunk's end but the last) and the scratch for each
    channel block's dB and dC rows and each batch row's dA and dD."""
    bsz, S, di, N = shape
    lay = tscan.scan_bwd_layout(*shape)
    states = lay["states_per_lane"]
    assert states == (4 if bsz * di * (N // 4) >= 7 * 132 * 32 else 2)
    assert (lay["lanes"], lay["channels"], lay["threads"], lay["tile"]) \
        == (N // states, 32, 32 * N // states, 16)
    assert lay["warps_per_scheduler"] == pytest.approx(
        -(-di // 32) * bsz * N / states / (4 * 132))
    assert lay["chunks"] == -(-S // 16)
    assert lay["channel_blocks"] == -(-di // 32)
    assert lay["smem"] + 1024 <= 228 * 1024 // 3
    assert lay["ckpt"] == bsz * ((S - 1) // 16) * di * N
    assert lay["part_bc"] == lay["channel_blocks"] * 2 * bsz * S * N
    assert lay["part_ad"] == bsz * di * (N + 1)
    with pytest.raises(ValueError, match="state size N=4"):
        tscan.scan_bwd_layout(bsz, S, di, 4)


def test_scan_bwd_layout_at_the_model_layers():
    """Four states a lane at falcon-mamba-7b's layer (7.8 warps an SM) and
    hymba-1.5b's B=8 layer; two at hymba's B=1 layer, where four would
    launch 3.0 warps an SM; both layouts and both N reached by
    SCAN_BWD_SHAPES."""
    lay = {name: tscan.scan_bwd_layout(*shape)
           for name, shape in _CS.SCAN_TIMED.items()}
    assert [lay[k]["states_per_lane"] for k in _CS.SCAN_TIMED] == [4, 4, 2]
    assert lay["falcon-mamba-7b"]["warps_per_scheduler"] * 4 > 7
    assert {(sh[3], tscan.scan_bwd_layout(*sh)["states_per_lane"])
            for sh in BWD_CARD_SHAPES} == {(16, 4), (16, 2), (8, 4), (8, 2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_scan_kernel_equals_plain_on_the_card(cuda, shape):
    bsz, S, di, N = shape
    dt, x, z, B, C, A, D = (torch.from_numpy(a).to(cuda) for a in
                            _scan_inputs(sum(shape), *shape))
    # z read in place as the gate half of an input projection
    z = torch.cat([z, z], -1).to(torch.bfloat16)[..., di:]
    before = tscan.selective_scan_cuda.launches
    got = ops.selective_scan(dt, x, z, B, C, A, D)
    again = ops.selective_scan(dt, x, z, B, C, A, D)
    assert tscan.selective_scan_cuda.launches - before == 2
    want = tref.selective_scan_ref(dt, x, z, B, C, A, D)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (bsz, S, di)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL)


@pytest.mark.gpu
def test_library_layout_equals_scan_layout(cuda):
    for shape in LAYOUT_SHAPES:
        built = tscan.kernel_layout(*shape)
        lay = tscan.scan_layout(*shape)
        assert built == {k: lay[k] for k in built}, shape


# The backward kernel against the plain float32 backward, relative
# Frobenius error per gradient.  Both run the same recurrences in float32,
# but the kernel's exponentials are ex2.approx (a few ulps off expf) and
# its sums over states and channels are butterflies and ordered partial
# sums against PyTorch's order; dz is a bf16 rounding of a product of such
# values, which lands one ulp apart here and there.  Measured on the H100
# at BWD_CARD_SHAPES: the float32 gradients at most 2.3e-6 (dA), dz at
# most 2.6e-5; the bounds keep about eight times that.
BWD_CARD_TOL = {"float32": 2e-5, "dz": 2e-4}
# mamba_block's gradients on the card against the CPU's: the block's bf16
# GEMMs round their sums in other orders on the two devices (a bf16 ulp
# here and there), and those values travel on through the backward.
# Measured on the H100 over four seeds at this width and the smoke
# configs': at most 6.9e-4 (A_log); the bound keeps about seven times that
MAMBA_GRAD_TOL = 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_CARD_SHAPES)
def test_scan_bwd_kernel_equals_plain_on_the_card(cuda, shape):
    bsz, S, di, N = shape
    dt, x, z, B, C, A, D = (torch.from_numpy(a).to(cuda) for a in
                            _scan_inputs(sum(shape), *shape))
    z = torch.cat([z, z], -1).to(torch.bfloat16)[..., di:]
    dy = torch.from_numpy(np.random.default_rng(1).normal(
        size=(bsz, S, di)).astype(np.float32)).to(cuda, torch.bfloat16)
    ins = (dt, x, z, B, C, A, D)
    before = tscan.selective_scan_bwd_cuda.launches
    got = ops.selective_scan_bwd(*ins, dy)
    again = ops.selective_scan_bwd(*ins, dy)
    assert tscan.selective_scan_bwd_cuda.launches - before == 2
    want = tref.selective_scan_bwd_ref(*ins, dy)
    torch.cuda.synchronize()
    for name, g, a, w, t in zip(("ddt", "dx", "dz", "dB", "dC", "dA", "dD"),
                                got, again, want, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert torch.equal(g, a), name
        assert bool(torch.isfinite(g).all()), name
        rel = float((g.float() - w.float()).norm()
                    / w.float().norm().clamp_min(1e-30))
        assert rel < BWD_CARD_TOL["dz" if name == "dz" else "float32"], (
            name, rel)


@pytest.mark.gpu
def test_library_bwd_layout_equals_scan_bwd_layout(cuda):
    for shape in BWD_CARD_SHAPES:
        built = tscan.kernel_bwd_layout(*shape)
        lay = tscan.scan_bwd_layout(*shape)
        assert built == {k: lay[k] for k in built}, shape


@pytest.mark.gpu
def test_mamba_block_backward_on_the_card(cuda):
    """mamba_block's gradients on the card (the scan's forward kernel once,
    its backward kernel once) near the CPU's (the plain versions), on the
    same bf16 weights and inputs: within the bf16 rounding of the block's
    GEMMs, which the two devices sum in other orders."""
    d, di, N, K, r = 64, 96, 16, 4, 8
    p = _block_params(9, d, di, N, K, r)
    x = np.random.default_rng(10).normal(size=(2, 40, d)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        tp = {k: (torch.from_numpy(v).to(dev, torch.bfloat16) if v.ndim >= 2
                  else torch.from_numpy(v).to(dev)).requires_grad_()
              for k, v in p.items()}
        tx = torch.from_numpy(x).to(dev, torch.bfloat16).requires_grad_()
        f0, b0 = (tscan.selective_scan_cuda.launches,
                  tscan.selective_scan_bwd_cuda.launches)
        out = tssm.mamba_block(tx, tp, n_state=N, conv_kernel=K)
        out.float().square().sum().backward()
        if dev != "cpu":
            assert (tscan.selective_scan_cuda.launches - f0,
                    tscan.selective_scan_bwd_cuda.launches - b0) == (1, 1)
        grads.append([tx.grad.float().cpu()] + [tp[k].grad.float().cpu()
                                                 for k in tssm.Mamba.LEAVES])
    for name, g, w in zip(("x",) + tssm.Mamba.LEAVES, *grads):
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert rel < MAMBA_GRAD_TOL, (name, rel)
