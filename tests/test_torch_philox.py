"""The port's Philox4x32-10 (``repro_torch.kernels.philox``): the generator
behind the in-kernel-RNG sweep kernels and their plain versions.

  * the Random123 known-answer vectors of Philox4x32-10;
  * the stream layout (key, counter, word) against a pure-Python Philox;
  * the uniforms' range and grid (exact multiples of 2^-24);
  * distinct (stream, chain, sub-step) give distinct streams.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import philox  # noqa: E402

M32 = 0xFFFFFFFF


def _philox_py(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c = list(ctr)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & M32
            k1 = (k1 + 0xBB67AE85) & M32
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & M32]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((M32,) * 4, (M32, M32), "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_known_answer_vectors(ctr, key, want):
    got = philox.philox4x32_10(ctr, key)
    assert " ".join(f"{int(w):08x}" for w in got) == want
    assert " ".join(f"{w:08x}" for w in _philox_py(ctr, key)) == want


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, -5])
def test_stream_layout_matches_pure_python(seed):
    C, S, L, stream = 3, 2, 7, 6
    u = philox.uniforms(torch.tensor([seed], dtype=torch.int32), stream, C,
                        S, L)
    assert u.shape == (C, S, L) and u.dtype == torch.float32
    for c in range(C):
        for s in range(S):
            for lane in range(L):
                bits = _philox_py((lane // 4, s, c, 0),
                                  (seed & M32, stream))[lane % 4]
                assert float(u[c, s, lane]) == (bits >> 8) * 2.0 ** -24


def test_uniforms_lie_on_the_24_bit_grid_in_unit_interval():
    u = philox.uniforms(12345, 2, 16, 8, 301).double()
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    scaled = u * 2 ** 24
    assert torch.equal(scaled, torch.floor(scaled))
    assert abs(float(u.mean()) - 0.5) < 0.01            # 38528 draws
    g = philox.to_gumbel(torch.tensor([0.0, 0.5, 1 - 2 ** -24]))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(float(g[1]), -np.log(np.log(2.0)), rtol=1e-6)
    assert float(philox.to_log_uniform(torch.tensor([0.0]))) < -40


def test_distinct_stream_chain_substep_give_distinct_streams():
    seed = torch.tensor([7], dtype=torch.int32)
    rows = {}
    for stream in range(8):
        u = philox.uniforms(seed, stream, 4, 3, 64)
        for c in range(4):
            for s in range(3):
                rows[(stream, c, s)] = tuple(u[c, s].tolist())
    assert len(set(rows.values())) == len(rows) == 8 * 4 * 3
    other = philox.uniforms(torch.tensor([8], dtype=torch.int32), 0, 4, 3, 64)
    assert not torch.equal(other, philox.uniforms(seed, 0, 4, 3, 64))
    # a wider call extends a narrower one: lanes do not depend on L or C
    wide = philox.uniforms(seed, 5, 6, 3, 100)
    assert torch.equal(wide[:4, :, :64], philox.uniforms(seed, 5, 4, 3, 64))


@pytest.mark.parametrize("chain0,C", [(0, 6), (2, 3), (5, 1)])
def test_chain_offset_draws_the_rows_of_a_larger_call(chain0, C):
    """Rows chain0 .. chain0 + C - 1 drawn alone equal those rows of one
    call over all chains: counter word 2 is the call's chain row."""
    seed = torch.tensor([-3], dtype=torch.int32)
    full = philox.uniforms(seed, [1, 4], 6, 2, 9)
    part = philox.uniforms(seed, [1, 4], C, 2, 9, chain0=chain0)
    assert torch.equal(part, full[:, chain0:chain0 + C])
    bits = _philox_py((6 // 4, 1, chain0, 0), ((-3) & M32, 4))[6 % 4]
    assert float(part[1, 0, 1, 6]) == (bits >> 8) * 2.0 ** -24


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, -9])
def test_local_gibbs_streams_follow_the_layout(seed):
    """The local sweep's streams (``LOCAL_GIBBS_STREAMS``): u_sub lane t is
    the raw 32-bit word t % 4 at counter (t // 4, s, c, 0) under key
    (seed mod 2^32, 0); gumbel lane u the uniform of stream 1's word."""
    st = philox.LOCAL_GIBBS_STREAMS
    assert st == dict(u_sub=0, gumbel=1)
    C, S, B, D = 2, 3, 9, 5
    sd = torch.tensor([seed], dtype=torch.int32)
    raw = philox.words(sd, st["u_sub"], C, S, B)
    u = philox.uniforms(sd, st["gumbel"], C, S, D)
    assert raw.dtype == torch.int64 and raw.shape == (C, S, B)
    for c in range(C):
        for s in range(S):
            for t in range(B):
                assert int(raw[c, s, t]) == _philox_py(
                    (t // 4, s, c, 0), (seed & M32, 0))[t % 4]
            for lane in range(D):
                bits = _philox_py((lane // 4, s, c, 0),
                                  (seed & M32, 1))[lane % 4]
                assert float(u[c, s, lane]) == (bits >> 8) * 2.0 ** -24
    # Floyd's draw k = (bits * (r + 1)) >> 32 stays in [0, r]
    r = torch.arange(B) + 40
    k = (raw * (r + 1)) >> 32
    assert bool(((k >= 0) & (k <= r)).all())
