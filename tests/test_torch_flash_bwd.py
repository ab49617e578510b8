"""The flash-attention gradient of the port, without the JAX package: the
plain backward (``ref.flash_attention_bwd_ref``) against autograd through
the plain forward on the CPU, the ``FlashAttention`` function's routing and
refusals, and, on a machine with a CUDA card, the hand-written backward
kernel (``csrc/flash_attention_bwd.cu``) against its plain version, also
beside other work on the card.  (The JAX comparison, ``jax.grad`` of the
JAX package's attention, is in ``tests/test_torch_train.py``.)

Card tolerance, per tensor, as a relative Frobenius error against the
float32 plain backward on the same bf16 inputs: the kernel rounds P and dS
to bf16 for their products and its outputs to bf16 (each 2^-9 relative);
those roundings, emulated in float32 on the CPU at four of the shapes
below, give 2.2e-3 to 2.5e-3 (the output rounding alone 1.66e-3).
``BWD_REL_TOL`` allows four times that for the tensor cores' other
summation order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

BWD_REL_TOL = 1e-2
# (B, Sq, Sk, H, KVH, hd, window, causal): tests/test_torch_flash.py's
# shapes (causal, sliding window, ragged, bidirectional Sq != Sk, tiles
# wholly outside the window, danube's hd 120, gemma3's hd 256)
SHAPES = [
    (2, 128, 128, 4, 2, 64, 0, True),
    (1, 256, 256, 2, 1, 64, 64, True),
    (2, 100, 100, 4, 4, 32, 0, True),
    (1, 64, 192, 2, 2, 64, 0, False),
    (1, 128, 128, 2, 2, 128, 32, True),
    (1, 384, 384, 2, 2, 64, 64, True),
    (1, 136, 136, 4, 2, 120, 48, True),
    (1, 96, 160, 2, 1, 256, 0, False),
]
# on the card: every head dim of the kernel, ragged and bidirectional
# (Sq != Sk, neither a multiple of the 64-row tiles), a causal Sk > Sq
# (key tiles no query sees), rows with no valid key, and tinyllama-1.1b's
# training attention at a short length
CARD_SHAPES = SHAPES + [(1, 200, 333, 4, 2, hd, 0, False)
                        for hd in (16, 32, 64, 120, 128, 256)] + [
    (1, 70, 300, 4, 2, 64, 0, True),
    (1, 150, 20, 2, 1, 16, 5, True),
    (2, 512, 512, 32, 4, 64, 0, True),
]
# hd 256, where the dK/dV consumers share 64 keys (one sums dV, the other
# dK) and dQ streams 32-key tiles: gemma3-12b's local and global layers
# cut to S=512 (the local window, 1024, then masks nothing: also a window
# of 128, across several 64-key items), ragged bidirectional, a causal
# Sk > Sq, rows with no valid key, G = 1 and G = 2
HD256_SHAPES = [
    (1, 512, 512, 16, 8, 256, 1024, True),
    (1, 512, 512, 16, 8, 256, 0, True),
    (1, 512, 512, 16, 8, 256, 128, True),
    (1, 200, 333, 4, 2, 256, 0, False),
    (1, 96, 400, 4, 2, 256, 0, True),
    (1, 150, 20, 2, 1, 256, 5, True),
    (2, 300, 300, 4, 4, 256, 40, True),
    (1, 260, 260, 4, 2, 256, 0, True),
]
# the wgmma kernels' schedule: many 128-key items per query tile (G = 8
# query heads on one KV head, Sq = Sk = 1024) at both padded head dims, a
# causal Sk > Sq, a window narrower than a 128-key item, and Sq, Sk that
# are multiples of neither 64 nor 128 (with a window, and bidirectional)
LOAD_SHAPES = [
    (1, 1024, 1024, 8, 1, 64, 0, True),
    (1, 1024, 1024, 8, 1, 128, 0, True),
    (1, 96, 400, 4, 2, 64, 0, True),
    (2, 300, 300, 4, 1, 64, 40, True),
    (1, 190, 450, 4, 2, 32, 100, True),
    (1, 200, 333, 4, 2, 120, 0, False),
]


def _inputs(B, Sq, Sk, H, KVH, hd, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype) for s in ((B, Sq, H, hd), (B, Sk, KVH, hd),
                                      (B, Sk, KVH, hd), (B, Sq, H, hd)))


def _rel(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,window,causal", SHAPES)
def test_plain_backward_equals_autograd_through_the_plain_forward(
        B, Sq, Sk, H, KVH, hd, window, causal):
    """float32: the explicit recomputation against autograd through
    ``flash_attention_ref`` (another order of sums and the max's zero
    gradient: rtol 1e-5 of each tensor's largest entry)."""
    q, k, v, dout = _inputs(B, Sq, Sk, H, KVH, hd, Sq + hd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tref.flash_attention_ref(*leaves, window=window, causal=causal)
    want = torch.autograd.grad(out, leaves, dout)
    got = tref.flash_attention_bwd_ref(q, k, v, out.detach(), dout,
                                       window=window, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_function_routes_through_the_plain_backward_on_the_cpu():
    """``models.attention.flash_attention`` is differentiable where a grad
    is wanted, its gradient the plain backward's bits, and prefill (no
    grad) calls the forward alone."""
    q, k, v, dout = _inputs(1, 72, 72, 4, 2, 16, 3, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.flash_attention(*leaves, 24, causal=True)
    got = torch.autograd.grad(out, leaves, dout)
    want = tref.flash_attention_bwd_ref(q, k, v, out.detach(), dout,
                                        window=24, causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    with torch.no_grad():
        plain = tattn.flash_attention(*leaves, 24, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_rows_without_a_valid_key_get_zero_gradient():
    """Sk = 2, window 3, causal: rows i >= 4 see no key; their dq is zero
    and they add nothing to dk or dv."""
    q, k, v, dout = _inputs(1, 8, 2, 2, 1, 16, 5)
    out = tref.flash_attention_ref(q, k, v, window=3, causal=True)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, dout, window=3,
                                         causal=True)
    assert torch.equal(dq[:, 4:], torch.zeros_like(dq[:, 4:]))
    dq4, dk4, dv4 = ops.flash_attention_bwd(
        q[:, :4], k, v, out[:, :4], dout[:, :4], window=3, causal=True)
    torch.testing.assert_close(dk, dk4, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(dv, dv4, rtol=1e-6, atol=1e-7)


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, dout = _inputs(1, 8, 8, 2, 1, 16, 0, torch.bfloat16)
    lse2 = torch.zeros((1, 2, 8))
    tflash.flash_attention_bwd_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention_bwd_cuda(q, k, v, q, dout, lse2)
    with pytest.raises(ValueError, match="takes bfloat16"):
        tflash.flash_attention_bwd_cuda(q.float(), k.float(), v.float(),
                                        q.float(), dout.float(), lse2)
    q24, kv24 = (torch.zeros(s, dtype=torch.bfloat16)
                 for s in ((1, 8, 2, 24), (1, 8, 1, 24)))
    with pytest.raises(ValueError, match="head dim 24 is not supported"):
        tflash.flash_attention_bwd_cuda(q24, kv24, kv24, q24, q24, lse2)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        kv3 = torch.zeros((1, 8, 3, 16), dtype=torch.bfloat16)
        tflash.flash_attention_bwd_cuda(q, kv3, kv3, q, dout, lse2)
    with pytest.raises(ValueError, match="lse2 must have shape"):
        tflash.flash_attention_bwd_cuda(q, k, v, q, dout, lse2[:, :1])
    assert tflash.flash_attention_bwd_cuda.launches == 0
    with pytest.raises(ValueError, match="lse=True takes bfloat16"):
        qf = torch.zeros((1, 8, 2, 16))
        tflash.flash_attention_cuda(qf, qf[:, :, :1], qf[:, :, :1], lse=True)


def test_backward_scratch_pads_rows_to_whole_dq_items():
    """The (lse2, D) scratch holds Sq rounded up to the dQ kernel's
    128-row items (it reads whole items' rows)."""
    assert [tflash._bwd_rows(s) for s in (1, 127, 128, 129, 2048, 8191)] \
        == [128, 128, 128, 256, 2048, 8192]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,window,causal",
                         CARD_SHAPES + HD256_SHAPES)
def test_backward_kernel_equals_plain_version(cuda, B, Sq, Sk, H, KVH, hd,
                                              window, causal):
    """The backward kernel on the forward kernel's row statistics (lse2),
    the same bits on a second launch; the forward's output the same bits
    with and without lse2."""
    q, k, v, dout = (t.to(cuda) for t in _inputs(
        B, Sq, Sk, H, KVH, hd, 11 * Sq + hd, torch.bfloat16))
    out = tflash.flash_attention_cuda(q, k, v, window=window, causal=causal)
    out2, lse2 = tflash.flash_attention_cuda(q, k, v, window=window,
                                             causal=causal, lse=True)
    assert torch.equal(out, out2), "lse=True changed the forward's output"
    want = tref.flash_attention_bwd_ref(q, k, v, out, dout, window=window,
                                        causal=causal)
    before = tflash.flash_attention_bwd_cuda.launches
    got = tflash.flash_attention_bwd_cuda(q, k, v, out, dout, lse2,
                                          window=window, causal=causal)
    again = tflash.flash_attention_bwd_cuda(q, k, v, out, dout, lse2,
                                            window=window, causal=causal)
    assert tflash.flash_attention_bwd_cuda.launches - before == 2
    torch.cuda.synchronize()
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, a), f"d{name}: two launches differ"
        assert bool(torch.isfinite(g).all()), f"d{name} not finite"
        assert _rel(g, w) < BWD_REL_TOL, (f"d{name}", _rel(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,window,causal", LOAD_SHAPES)
def test_backward_kernel_same_bits_beside_other_work(cuda, B, Sq, Sk, H, KVH,
                                                      hd, window, causal):
    """The persistent kernels' schedule (items from a work counter, in any
    order over the SMs) leaves the sums' order fixed: within the tolerance
    of the plain version, and the same bits on a second launch and on a
    third made while another stream runs large matrix products."""
    q, k, v, dout = (t.to(cuda) for t in _inputs(
        B, Sq, Sk, H, KVH, hd, 7 * Sk + hd, torch.bfloat16))
    out, lse2 = tflash.flash_attention_cuda(q, k, v, window=window,
                                            causal=causal, lse=True)
    want = tref.flash_attention_bwd_ref(q, k, v, out, dout, window=window,
                                        causal=causal)
    bwd = lambda: tflash.flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out, dout, lse2, window=window, causal=causal)
    first, second = bwd(), bwd()
    a = torch.randn((8192, 8192), device=cuda).to(torch.bfloat16)
    side = torch.cuda.Stream(cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        for _ in range(4):
            a = a @ a.T * 8192 ** -0.5
    third = bwd()
    torch.cuda.synchronize()
    for name, f, s, th, w in zip("qkv", first, second, third, want):
        assert torch.equal(f, s), f"d{name}: two launches differ"
        assert torch.equal(f, th), f"d{name}: a launch beside a matmul differs"
        assert bool(torch.isfinite(f).all()), f"d{name} not finite"
        assert _rel(f, w) < BWD_REL_TOL, (f"d{name}", _rel(f, w))


@pytest.mark.gpu
def test_backward_kernel_from_a_fresh_thread(cuda):
    """autograd runs the backward on a thread of its own, which may have
    made no CUDA call before the kernel's: the launch makes the device's
    context current there before it encodes its tensor maps."""
    import threading
    q, k, v, dout = (t.to(cuda) for t in _inputs(
        1, 130, 130, 4, 2, 64, 2, torch.bfloat16))
    out, lse2 = tflash.flash_attention_cuda(q, k, v, causal=True, lse=True)
    want = tflash.flash_attention_bwd_cuda(q, k, v, out, dout, lse2)
    got = []
    thread = threading.Thread(target=lambda: got.append(
        tflash.flash_attention_bwd_cuda(q, k, v, out, dout, lse2)))
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    torch.cuda.synchronize()
    assert len(got) == 1, "the launch on a fresh thread raised"
    for g, w in zip(got[0], want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_forward_row_statistics_equal_the_plain_log_sum_exp(cuda):
    """The forward kernel's lse2: each row's log2-sum-exp of the scores
    times hd^-0.5 log2(e) (+inf where no key is valid), against float32
    on the same bf16 inputs (the kernel's ex2 is approximate: 1e-4)."""
    B, Sq, Sk, H, KVH, hd, w = 1, 150, 150, 4, 2, 64, 20
    q, k, v, _ = (t.to(cuda) for t in _inputs(B, Sq, Sk, H, KVH, hd, 9,
                                              torch.bfloat16))
    _, lse2 = tflash.flash_attention_cuda(q, k, v, window=w, causal=True,
                                          lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(H // KVH, dim=2))
    i, j = torch.arange(Sq, device=cuda)[:, None], torch.arange(
        Sk, device=cuda)[None, :]
    s = (s * hd ** -0.5 * 1.4426950408889634).masked_fill(
        ~((i >= j) & (i - j < w)), -torch.inf)
    want = torch.logsumexp(s * np.log(2.0), dim=-1) / np.log(2.0)
    torch.testing.assert_close(lse2, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_function_on_the_card_launches_the_backward_kernel(cuda):
    q, k, v, dout = (t.to(cuda) for t in _inputs(
        2, 130, 130, 8, 2, 64, 1, torch.bfloat16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tflash.flash_attention_bwd_cuda.launches
    out = tattn.flash_attention(*leaves, 0, causal=True)
    got = torch.autograd.grad(out, leaves, dout)
    assert tflash.flash_attention_bwd_cuda.launches - before == 1
    want = tref.flash_attention_bwd_ref(q, k, v, out.detach(), dout,
                                        window=0, causal=True)
    for g, w in zip(got, want):
        assert _rel(g, w) < BWD_REL_TOL
    with pytest.raises(ValueError, match="takes bfloat16"):
        tattn.flash_attention(*(t.float().requires_grad_()
                                for t in (q, k, v)), 0, causal=True)
