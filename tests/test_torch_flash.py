"""The port's flash attention on the CPU against the JAX package — and, on a
machine with a CUDA card, the hand-written kernel against its plain version.

  * ``ops.flash_attention`` (CPU route: the plain version) equals the JAX
    Pallas kernel (``repro.kernels.ops.flash_attention``, interpret mode)
    at the shapes of ``tests/test_kernels.py`` plus one with key tiles
    wholly outside the window, float32, the JAX test's tolerance;
  * the model-level ``models.attention.flash_attention`` on bf16 inputs
    against the JAX model's jnp oracle, at a stated bf16 tolerance;
  * rows with no valid key are zeros; the CUDA wrapper refuses CPU
    tensors and head dims it is not built for (per dtype) instead of
    falling back;
  * (gpu) the kernel equals its plain version on the card, float32 at the
    same shapes (bf16 where float32 has no template), bf16 at model shapes
    and at ragged bidirectional shapes of every padded head dim, the same
    bits on a second launch.
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

try:    # the JAX reference; a machine with the card may have no JAX, and
    # runs only the gpu tests below, which do not read it
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import attention as jattn
except ImportError:
    jnp = None

# (B, Sq, Sk, H, KVH, hd, window, causal): tests/test_kernels.py:117-123,
# plus Sq = Sk = 384 with window 64, where whole 128-key tiles lie outside
# the window, and the head dims of h2o-danube-3-4b (120) and gemma3-12b
# (256), short
SHAPES = [
    (2, 128, 128, 4, 2, 64, 0, True),
    (1, 256, 256, 2, 1, 64, 64, True),     # sliding window
    (2, 100, 100, 4, 4, 32, 0, True),      # ragged
    (1, 64, 192, 2, 2, 64, 0, False),      # bidirectional, Sq != Sk
    (1, 128, 128, 2, 2, 128, 32, True),
    (1, 384, 384, 2, 2, 64, 64, True),     # tiles outside the window
    (1, 136, 136, 4, 2, 120, 48, True),    # danube's hd, window, ragged
    (1, 96, 160, 2, 1, 256, 0, False),     # gemma3's hd, Sq != Sk
]
# bf16 model-level shapes (B, S, H, KVH, hd, window): the smoke configs'
# head layouts and windows, one ragged length, and the full configs' head
# dims 120 (danube, windowed) and 256 (gemma3)
MODEL_SHAPES = [
    (2, 64, 8, 2, 16, 0),                  # tinyllama-smoke
    (2, 100, 4, 2, 32, 64),                # danube-smoke window, ragged
    (1, 96, 4, 2, 32, 32),                 # gemma3-smoke local layer
    (1, 120, 4, 1, 120, 40),               # h2o-danube-3-4b head dim
    (1, 72, 2, 1, 256, 0),                 # gemma3-12b head dim
]
# ragged bidirectional bf16 shapes on the card, one per head dim and so
# every padded template (64, 128, 256): Sq != Sk, neither a multiple of
# the 128-row tiles, so the tensor maps' zero fill and the clipped stores
# are exercised
RAGGED_BF16 = [(1, 200, 333, 4, 2, hd, 0, False)
               for hd in (16, 32, 64, 120, 128, 256)]
# bf16: the port rounds its output to bf16 (2^-9 relative) where the JAX
# oracle returns float32, and p is rounded to bf16 against another running
# max (the row's, or the kernel's per key tile, here; per 1024-key chunk
# there); both are well inside this bound for outputs of size ~1
BF16_RTOL, BF16_ATOL = 2e-2, 2e-2


def _inputs(B, Sq, Sk, H, KVH, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KVH, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KVH, hd)).astype(np.float32))


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,window,causal", SHAPES)
def test_plain_flash_equals_jax_pallas_kernel(B, Sq, Sk, H, KVH, hd, window,
                                              causal):
    q, k, v = _inputs(B, Sq, Sk, H, KVH, hd, Sq + Sk + H)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        causal=causal))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("B,S,H,KVH,hd,window", MODEL_SHAPES)
def test_model_flash_attention_bf16_equals_jax_oracle(B, S, H, KVH, hd,
                                                      window):
    q, k, v = _inputs(B, S, S, H, KVH, hd, 7 * S + hd)
    want = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), window
    ).astype(jnp.float32))
    got = tattn.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_rows_without_a_valid_key_are_zero():
    """Sk = 2, window 3, causal: rows i >= 4 see no key (i - j < 3 fails
    for j <= 1).  The TPU kernel leaves them to its padding; the port
    writes zeros, and the other rows are the exact softmax."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 2, 1, 16, 3))
    out = ops.flash_attention(q, k, v, window=3, causal=True)
    assert torch.equal(out[:, 4:], torch.zeros_like(out[:, 4:]))
    s = torch.einsum("qhd,khd->hqk", q[0], k[0].expand(2, 2, 16)) \
        * 16 ** -0.5
    mask = torch.tensor([[i >= j and i - j < 3 for j in range(2)]
                         for i in range(4)])
    p = torch.softmax(s[:, :4].masked_fill(~mask, -torch.inf), dim=-1)
    want = torch.einsum("hqk,kd->qhd", p, v[0, :, 0])
    torch.testing.assert_close(out[0, :4], want, rtol=1e-5, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors_and_other_head_dims():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 16, 0))
    tflash.flash_attention_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention_cuda(q, k, v)
    q24 = torch.zeros((1, 8, 2, 24))
    kv24 = torch.zeros((1, 8, 1, 24))
    with pytest.raises(ValueError, match="head dim 24 is not supported"):
        tflash.flash_attention_cuda(q24, kv24, kv24)
    with pytest.raises(ValueError, match="head dim 24 is not supported"):
        tflash.flash_attention_cuda(q24.bfloat16(), kv24.bfloat16(),
                                    kv24.bfloat16())
    for hd in (120, 256):         # bf16 only: float32 names its dtype
        qf, kvf = torch.zeros((1, 8, 2, hd)), torch.zeros((1, 8, 1, hd))
        with pytest.raises(ValueError, match=f"head dim {hd} is not "
                           f"supported by the flash-attention kernel for "
                           f"torch.float32"):
            tflash.flash_attention_cuda(qf, kvf, kvf)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        tflash.flash_attention_cuda(q, torch.zeros((1, 8, 3, 16)),
                                    torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert tflash.flash_attention_cuda.launches == 0


def test_cuda_wrapper_grid_limit_is_float32_only():
    # float32 puts H on a grid axis (at most 65535); the persistent bf16
    # grid is 1-D, so such a head count reaches the device check
    H = 65536
    q, kv = torch.zeros((1, 1, H, 16)), torch.zeros((1, 1, 1, 16))
    tflash.flash_attention_cuda.launches = 0
    with pytest.raises(ValueError, match="must be at most 65535"):
        tflash.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention_cuda(q.bfloat16(), kv.bfloat16(),
                                    kv.bfloat16())
    assert tflash.flash_attention_cuda.launches == 0


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
def test_flash_kernel_equals_plain_version(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    f32_dims = tflash.HEAD_DIMS[torch.float32]
    cases = [(s, torch.float32 if s[5] in f32_dims else torch.bfloat16)
             for s in SHAPES] + [
        ((B, S, S, H, KVH, hd, w, True), torch.bfloat16)
        for B, S, H, KVH, hd, w in MODEL_SHAPES + [(1, 300, 8, 2, 128, 0)]
    ] + [(s, torch.bfloat16) for s in RAGGED_BF16]
    for (B, Sq, Sk, H, KVH, hd, window, causal), dtype in cases:
        q, k, v = (torch.from_numpy(a).to(cuda, dtype)
                   for a in _inputs(B, Sq, Sk, H, KVH, hd, Sq + hd))
        before = tflash.flash_attention_cuda.launches
        got = ops.flash_attention(q, k, v, window=window, causal=causal)
        again = ops.flash_attention(q, k, v, window=window, causal=causal)
        want = tref.flash_attention_ref(q, k, v, window=window,
                                        causal=causal)
        torch.cuda.synchronize()
        assert tflash.flash_attention_cuda.launches == before + 2
        assert torch.equal(got, again)            # no float atomics
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("lse", [False, True])
def test_flash_kernel_from_a_fresh_thread(cuda, hd, lse):
    """A thread that has made no CUDA call has no current context: the
    bf16 launch makes the device's current there before it encodes its
    tensor maps, and returns the main thread's bits (each case on a new
    thread: after its first launch a thread's context is current)."""
    import threading
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _inputs(1, 130, 130, 4, 2, hd, 5 + hd))
    want = tflash.flash_attention_cuda(q, k, v, window=0, causal=True,
                                       lse=lse)
    got, errors = [], []

    def run():
        try:
            got.append(tflash.flash_attention_cuda(q, k, v, window=0,
                                                   causal=True, lse=lse))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive(), "the launch on a fresh thread hung"
    torch.cuda.synchronize()
    assert not errors, f"the launch on a fresh thread raised: {errors[0]}"
    for g, w in zip(got[0] if lse else got, want if lse else [want]):
        assert torch.equal(g, w)
