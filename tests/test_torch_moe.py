"""The port's MoE family (``models/moe.py`` and the transformer's MoE
plumbing) on the CPU against the JAX package, on numpy inputs from a seed.

  * ``router_topk``: the expert ids equal the reference's wherever the
    k-th and (k+1)-th probabilities lie more than NEAR_TIE apart, weights
    and probabilities within float32 rounding, and an exact tie broken
    toward the lower index as ``jax.lax.top_k`` breaks it;
  * the combine bit-equal to the reference's bf16 scatter-add (k adds
    rounded one by one, which a float32 sum rounded once is not);
  * ``moe_ffn`` against the reference's on the same bf16 inputs and
    weights at mixtral-smoke (E=4, k=2) and deepseek-smoke (E=8, k=2, one
    shared expert), with a router skewed so that one expert overflows its
    capacity: the same dropped assignments exactly;
  * the whole model through ``params_from_jax`` (mixtral-smoke, and
    deepseek-smoke with GQA attention, which has the dense prefix and the
    shared experts): prefill logits, hidden states and 24 decode steps
    against the reference's;
  * the port's decode against its own forward at capacity factor 16 (no
    drops), end to end and layer by layer, by the reference's MoE rule;
  * ``param_count`` / ``active_param_count`` equal the reference's;
    training a MoE config is refused;
  * (gpu) mixtral-smoke on the card against the CPU.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

try:    # the JAX reference; a machine with the card may have no JAX, and
    # runs only the gpu test below, which does not read it
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.launch import steps as jsteps
    from repro.models import moe as jmoe
    from repro.models import transformer as jT
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

B, S = 2, 24
# router probabilities closer than this may rank the other way in the two
# packages (another float32 summation order in the logits)
NEAR_TIE = 1e-5
# moe_ffn, port against the reference on the same bf16 inputs: the two
# round silu at other places (module docstring of test_torch_models.py), so
# ~60% of the outputs differ by a bf16 ulp or two.  Measured (three seeds,
# outputs up to |y| 4.7): max abs diff <= 0.0234, mean <= 0.0026; the
# bounds keep about twice that.
FFN_MAX, FFN_MEAN = 0.05, 0.005
# The reference's MoE criterion (tests/test_models.py:92-99): the 0.9
# quantile over positions of the log-softmax max abs diff < 0.15, argmax
# agreement >= 0.9.
MOE_QUANTILE, LOGIT_TOL, ARGMAX_AGREE = 0.9, 0.15, 0.9
# the whole model, port against the reference: forward hidden states (bf16,
# after the final norm), per position the max abs diff over (B, d), held by
# the MoE rule, its 0.9 quantile over positions.  Measured on the two smoke
# configs: quantile 0.0469 in both, mean 0.0115 / 0.0098; one position of
# mixtral-smoke differs by 0.587, where the second layer's router has a
# near-tie (its 2nd and 3rd probabilities 5.2e-7 apart) and the packages
# pick other experts.  The bounds keep about twice the measured distance
# (tests/test_torch_models.py:59-76 holds the dense families so).
HIDDEN_QUANTILE, HIDDEN_MEAN = 0.1, 0.025
# decode_gap_by_layer's bound (tests/test_torch_models.py, LAYER_GAP_TOL)
LAYER_GAP_TOL = 0.1
DROPLESS = 16.0          # the reference's own decode test's capacity factor


def _cfg(name, reg=treg, **kw):
    """A smoke config of registry ``reg`` by name, with ``kw`` replaced;
    "deepseek-gqa" is deepseek-smoke with GQA attention (head dim 32), the
    attention the port has: it keeps the dense prefix and the shared
    experts."""
    if name == "deepseek-gqa":
        name = "deepseek-v2-lite-16b"
        kw = dict(name="deepseek-smoke-gqa", attention="gqa", head_dim=32,
                  **kw)
    return dataclasses.replace(reg.get_arch(name, smoke=True), **kw)


def _cfgs(name):
    """(port config, reference config) of a smoke config by name."""
    return _cfg(name), _cfg(name, jreg)


def _bf16(a):
    """float32 numpy values that are bf16 numbers."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _per_pos(a, b):
    """log-softmax max abs diff at each position of (B, S, V) logits."""
    la = torch.log_softmax(torch.as_tensor(np.array(a)), -1)
    lb = torch.log_softmax(torch.as_tensor(np.array(b)), -1)
    return (la - lb).abs().amax(dim=(0, 2)).numpy()


def _agree(a, b):
    return float(np.mean(np.argmax(np.asarray(a), -1)
                         == np.argmax(np.asarray(b), -1)))


def _moe_criterion(a, b):
    per_pos = _per_pos(a, b)
    q = float(np.quantile(per_pos, MOE_QUANTILE))
    agree = _agree(a, b)
    assert q < LOGIT_TOL and agree >= ARGMAX_AGREE, (q, agree, per_pos)
    return q, agree


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (64, 6)])
def test_router_topk_equals_jax(E, k):
    rng = np.random.default_rng(E + k)
    T, d = 256, 128
    x = _bf16(rng.normal(size=(T, d)))
    w = _bf16(rng.normal(size=(d, E)) / d ** 0.5)
    jw, jids, jprobs = (np.asarray(a) for a in jmoe.router_topk(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), k))
    tw, tids, tprobs = tmoe.router_topk(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), k)
    assert tw.dtype == torch.float32 and tids.dtype == torch.int32
    np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=1e-5, atol=1e-7)
    ranked = -np.sort(-jprobs, axis=-1)
    clear = ranked[:, k - 1] - ranked[:, k] > NEAR_TIE
    near = int((~clear).sum())
    print(f"E={E} k={k}: {near} of {T} tokens at a near-tie")
    np.testing.assert_array_equal(tids.numpy()[clear], jids[clear])
    np.testing.assert_allclose(tw.numpy()[clear], jw[clear], rtol=1e-5,
                               atol=1e-7)


@needs_jax
def test_router_topk_breaks_ties_toward_the_lower_index():
    """Exact ties: a zero token (every probability 1/E) and a router with
    equal columns on dyadic values (exact float32 logits).  The ids are
    the reference's, the lower index first."""
    E, k, d = 8, 3, 16
    rng = np.random.default_rng(7)
    x = rng.integers(-4, 5, size=(32, d)).astype(np.float32) / 8
    x[0] = 0.0
    w = rng.integers(-4, 5, size=(d, E)).astype(np.float32) / 8
    w[:, 5] = w[:, 2]
    w[:, 6] = w[:, 2]
    jids = np.asarray(jmoe.router_topk(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w, jnp.bfloat16), k)[1])
    _, tids, probs = tmoe.router_topk(torch.from_numpy(x).bfloat16(),
                                      torch.from_numpy(w).bfloat16(), k)
    np.testing.assert_array_equal(tids.numpy(), jids)
    assert tids[0].tolist() == [0, 1, 2]
    tied = probs[:, 2] == probs[:, 5]
    assert bool(tied.all()) and bool((probs[:, 5] == probs[:, 6]).all())
    for row in tids.tolist():       # 2, 5, 6 in that order when they meet
        picked = [e for e in row if e in (2, 5, 6)]
        assert picked == sorted(picked)


# ---------------------------------------------------------------------------
# the combine
# ---------------------------------------------------------------------------

def _jax_combine(contrib):
    T, k, d = contrib.shape
    tok_of = jnp.arange(T * k) // k
    return np.asarray(jnp.zeros((T, d), jnp.bfloat16).at[tok_of].add(
        jnp.asarray(contrib.reshape(T * k, d), jnp.bfloat16)).astype(
        jnp.float32))


@needs_jax
@pytest.mark.parametrize("k", [2, 3, 6])
def test_combine_is_the_reference_scatter_add(k):
    """Bit for bit on bf16 values: random ones at k, and at k = 3 the
    values (1, 2^-8, 2^-8), which a float32 sum rounded once takes to
    1.0078 and the reference's adds, each rounded, to 1.0."""
    rng = np.random.default_rng(k)
    contrib = _bf16(rng.normal(size=(64, k, 32)) * rng.choice(
        [1.0, 2.0 ** -8, 2.0 ** 6], size=(64, k, 1)))
    contrib[0, :, 0] = 0.0
    contrib[0, 0, 0] = -0.0         # 0 + -0 is +0 there
    if k == 3:
        contrib[1, :, 0] = [1.0, 2.0 ** -8, 2.0 ** -8]
    want = _jax_combine(contrib)
    got = tmoe.combine(torch.from_numpy(contrib).bfloat16()).float().numpy()
    assert got.tobytes() == want.tobytes()
    if k == 3:
        assert got[1, 0] == 1.0
        once = torch.from_numpy(contrib[1:2, :, :1]).sum(1).bfloat16()
        assert float(once) == 1.0078125      # what the port must not do


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _moe_inputs(cfg, seed, skew):
    """bf16 x (B, S, d) and the layer's weights; ``skew`` steers every
    token's first choice to expert 0 (x[..., 0] = 4, router[0, 0] = 4), so
    that expert overflows its capacity."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    x = rng.normal(size=(B, S, d))
    p = {"router": rng.normal(size=(d, E)) / d ** 0.5,
         "w_gate": rng.normal(size=(E, d, f)) / d ** 0.5,
         "w_up": rng.normal(size=(E, d, f)) / d ** 0.5,
         "w_down": rng.normal(size=(E, f, d)) / f ** 0.5}
    if cfg.shared_experts:
        fs = cfg.shared_experts * f
        p.update(shared_gate=rng.normal(size=(d, fs)) / d ** 0.5,
                 shared_up=rng.normal(size=(d, fs)) / d ** 0.5,
                 shared_down=rng.normal(size=(fs, d)) / fs ** 0.5)
    if skew:
        x[..., 0] = 4.0
        p["router"][0, 0] = 4.0
    return _bf16(x), {k: _bf16(v) for k, v in p.items()}


def _jax_slots(ids, E, cap):
    """The reference moe_ffn's (slot, keep), its lines 140-149 in jnp."""
    flat_ids = jnp.asarray(ids).reshape(-1)
    onehot_e = jax.nn.one_hot(flat_ids, E, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot_e, axis=0) - onehot_e
    pos = jnp.take_along_axis(pos_in_e, flat_ids[:, None], 1)[:, 0]
    keep = pos < cap
    return np.asarray(jnp.where(keep, flat_ids * cap + pos, E * cap)), \
        np.asarray(keep)


@needs_jax
@pytest.mark.parametrize("skew", [False, True], ids=["spread", "overflow"])
@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_moe_ffn_equals_jax(name, skew):
    cfg, _ = _cfgs(name)
    E, k = cfg.num_experts, cfg.top_k
    x, p = _moe_inputs(cfg, 0, skew)
    want = np.asarray(jmoe.moe_ffn(
        jnp.asarray(x, jnp.bfloat16),
        {n: jnp.asarray(v, jnp.bfloat16) for n, v in p.items()},
        top_k=k, capacity_factor=1.25).astype(jnp.float32))
    tp = {n: torch.from_numpy(v).bfloat16() for n, v in p.items()}
    tx = torch.from_numpy(x).bfloat16()
    got = tmoe.moe_ffn(tx, tp, top_k=k, capacity_factor=1.25)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape

    # the dispatch: the same ids, so the same slots and the same drops
    xt = x.reshape(-1, cfg.d_model)
    jids = np.asarray(jmoe.router_topk(jnp.asarray(xt, jnp.bfloat16),
                                       jnp.asarray(p["router"],
                                                   jnp.bfloat16), k)[1])
    _, tids, _ = tmoe.router_topk(tx.reshape(-1, cfg.d_model),
                                  tp["router"], k)
    np.testing.assert_array_equal(tids.numpy(), jids)
    cap = tmoe.capacity(B * S, k, E, 1.25)
    assert cap == max(k, int(1.25 * B * S * k / E))
    slot, keep = tmoe.dispatch_slots(tids, E, cap)
    jslot, jkeep = _jax_slots(jids, E, cap)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    dropped = int((~keep).sum())
    print(f"{name} {'overflow' if skew else 'spread'}: cap {cap}, "
          f"{dropped} of {keep.numel()} assignments dropped")
    if skew:
        assert dropped == B * S - cap      # expert 0 keeps its first cap

    diff = np.abs(got.float().numpy() - want)
    print(f"  max abs diff {diff.max():.5f}, mean {diff.mean():.6f} "
          f"(|y| <= {np.abs(want).max():.3f})")
    assert diff.max() < FFN_MAX and diff.mean() < FFN_MEAN


# ---------------------------------------------------------------------------
# the whole model, against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The reference's prefill logits, forward logits and hidden states,
    24 decode steps' logits and positions, on its init_params weights
    (seed 0)."""
    _, cfg = _cfgs(name)
    params = jT.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    prefill = jax.jit(jsteps.make_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(toks)})
    hidden = jax.jit(functools.partial(jT.forward, cfg, remat=False))(
        params, jnp.asarray(toks))
    serve = jax.jit(jsteps.make_serve_step(cfg))
    cache = jT.init_cache(cfg, B, S)
    logits, pos = [], []
    for s in range(S):
        lg, cache = serve(params, jnp.asarray(toks[:, s:s + 1]), cache)
        logits.append(np.asarray(lg))
        pos.append([np.asarray(e["kv"]["pos"]) for e in
                    cache.get("dense_prefix", []) + cache["slots"]])
    return dict(tree=jax.tree_util.tree_map(np.asarray, params),
                tokens=toks, prefill=np.asarray(prefill),
                hidden=np.asarray(hidden.astype(jnp.float32)),
                logits=np.stack(logits, 1), pos=pos)


@needs_jax
@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-gqa"])
def test_moe_model_equals_jax(name):
    ref = _jax_run(name)
    cfg, _ = _cfgs(name)
    model = tT.params_from_jax(cfg, ref["tree"], device="cpu")
    assert len(model.dense_prefix) == cfg.first_dense_layers
    assert len(model.layers) == cfg.scan_layers
    toks = torch.from_numpy(ref["tokens"])

    logits = tsteps.make_prefill_step(cfg)(model, {"tokens": toks})
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == ref["prefill"].shape
    q, agree = _moe_criterion(logits[:, None], ref["prefill"][:, None])
    print(f"{name} prefill: log-softmax diff {q:.4f}, agreement {agree}")

    hidden = tT.forward(cfg, model, toks)
    diff = np.abs(hidden.float().numpy() - ref["hidden"])
    q = float(np.quantile(diff.max(axis=(0, 2)), MOE_QUANTILE))
    print(f"{name} hidden: quantile {q:.4f}, max {diff.max():.4f}, mean "
          f"{diff.mean():.5f}")
    assert q < HIDDEN_QUANTILE and diff.mean() < HIDDEN_MEAN

    cache = tT.init_cache(cfg, B, S, device="cpu")
    assert len(cache.get("dense_prefix", [])) == cfg.first_dense_layers
    serve = tsteps.make_serve_step(cfg)
    dec = []
    for s in range(S):
        lg, cache = serve(model, toks[:, s:s + 1], cache)
        dec.append(lg.numpy())
        kv = [e["kv"] for e in cache.get("dense_prefix", [])
              + cache["slots"]]
        for entry, want in zip(kv, ref["pos"][s], strict=True):
            np.testing.assert_array_equal(entry["pos"].numpy(), want)
    q, agree = _moe_criterion(np.stack(dec, 1), ref["logits"])
    print(f"{name} decode: log-softmax diff quantile {q:.4f}, agreement "
          f"{agree:.3f}")


@needs_jax
def test_params_from_jax_takes_the_moe_and_prefix_leaves():
    """The router's bits are the reference's bf16 cast; the prefix layer's
    leaves come from the reference's list; a tree without a MoE leaf, or
    with an MLP in the MoE stack, is refused."""
    cfg, _ = _cfgs("deepseek-gqa")
    tree = _jax_run("deepseek-gqa")["tree"]
    model = tT.params_from_jax(cfg, tree, device="cpu")
    moe = model.layers[1].moe
    assert moe.router.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        moe.router.float().numpy(),
        np.asarray(jnp.asarray(tree["layers"]["moe"]["router"][1, 0])
                   .astype(jnp.bfloat16).astype(jnp.float32)))
    prefix = model.dense_prefix[0]
    assert prefix.moe is None and prefix.mlp is not None
    assert tuple(prefix.mlp.w_down.shape) == (cfg.d_ff, cfg.d_model)
    np.testing.assert_array_equal(prefix.ln2.numpy(),
                                  tree["dense_prefix"][0]["ln2"])
    moe_leaves = {k: v for k, v in tree["layers"]["moe"].items()
                  if k != "shared_up"}
    missing = {**tree, "layers": {**tree["layers"], "moe": moe_leaves}}
    with pytest.raises(ValueError,
                       match=r"missing \['layers/moe/shared_up'\]"):
        tT.params_from_jax(cfg, missing, device="cpu")
    extra = {**tree, "layers": {**tree["layers"],
                                "mlp": tree["dense_prefix"][0]["mlp"]}}
    with pytest.raises(ValueError, match=r"extra \['layers/mlp/w_down'"):
        tT.params_from_jax(cfg, extra, device="cpu")


# ---------------------------------------------------------------------------
# the port against itself: decode against forward, no drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-gqa"])
def test_moe_decode_matches_forward(name):
    """The reference's own MoE test (tests/test_models.py:62-99): capacity
    factor 16, B=1 S=24, its quantile criterion."""
    cfg = _cfg(name, moe_capacity_factor=DROPLESS)
    model = tT.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (1, S)))
    fwd = (tT.forward(cfg, model, toks) @ model.head()).float()
    cache = tT.init_cache(cfg, 1, S, device="cpu")
    dec = torch.stack([tT.decode_step(cfg, model, toks[:, s:s + 1],
                                      cache)[0] for s in range(S)], 1)
    q, agree = _moe_criterion(fwd.numpy(), dec.numpy())
    print(f"{name}: quantile {q:.4f}, max "
          f"{_per_pos(fwd, dec).max():.4f}, agreement {agree:.3f}")


@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-gqa"])
def test_moe_decode_matches_forward_layer_by_layer(name):
    cfg = _cfg(name, moe_capacity_factor=DROPLESS)
    model = tT.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (1, S)))
    gaps, maxes = tT.decode_gap_by_layer(cfg, model, toks)
    print(f"{name}: gaps {gaps}, largest over positions {maxes}")
    assert len(gaps) == len(maxes) == cfg.num_layers
    assert max(gaps) < LAYER_GAP_TOL, gaps
    assert all(0 < g <= m for g, m in zip(gaps, maxes))
    # the dense prefix is held by its max, the MoE stack by the quantile
    assert gaps[:cfg.first_dense_layers] == maxes[:cfg.first_dense_layers]


def test_moe_prefill_runs_flash_in_every_layer(monkeypatch):
    """The prefix layer and every MoE layer attend through
    ops.flash_attention (on the card the kernel) and run moe_ffn once."""
    from repro_torch.kernels import ops
    attends, ffns = [], []
    real_attend, real_ffn = ops.flash_attention, tmoe.moe_ffn
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: attends.
                        append(kw) or real_attend(*a, **kw))
    monkeypatch.setattr(tmoe, "moe_ffn", lambda x, *a, **kw: ffns.append(
        (x.shape, kw)) or real_ffn(x, *a, **kw))
    cfg = _cfg("deepseek-gqa")
    model = tT.init_params(cfg, device="cpu")
    tsteps.make_prefill_step(cfg)(model, {"tokens": torch.ones(
        (2, 8), dtype=torch.int64)})
    assert len(attends) == cfg.num_layers
    assert ffns == [((2, 8, cfg.d_model), dict(
        top_k=cfg.top_k, capacity_factor=cfg.moe_capacity_factor))] \
        * cfg.scan_layers


# ---------------------------------------------------------------------------
# counts, init, refusals
# ---------------------------------------------------------------------------

MIXTRAL_24 = "mixtral-8x7b, 24 of 32 layers"


@needs_jax
@pytest.mark.parametrize("name", ["mixtral-8x7b", "mixtral-smoke",
                                  MIXTRAL_24, "deepseek-gqa"])
def test_param_counts_equal_jax(name):
    if name == MIXTRAL_24:
        cfg, jcfg = (dataclasses.replace(reg.get_arch("mixtral-8x7b"),
                                         num_layers=24)
                     for reg in (treg, jreg))
    elif name == "mixtral-8x7b":
        cfg, jcfg = treg.get_arch(name), jreg.get_arch(name)
    else:
        cfg, jcfg = _cfgs("mixtral-8x7b" if name == "mixtral-smoke"
                          else name)
    assert tT.param_count(cfg) == jT.param_count(jcfg)
    assert tT.active_param_count(cfg) == jT.active_param_count(jcfg)
    assert tT.model_flops_per_token(cfg, 4096, "prefill") == \
        jT.model_flops_per_token(jcfg, 4096, "prefill")
    if name == MIXTRAL_24:      # the chip run's cut (chip_smoke.py 7m)
        assert tT.param_count(cfg) == 35_092_631_552
        assert tT.active_param_count(cfg) == 9_725_480_960


def test_moe_init_follows_the_reference_fan_in():
    """init_params draws each MoE leaf with std fan_in^-0.5 as the
    reference's _init_moe: router, w_gate, w_up, shared_gate, shared_up
    from d; w_down from moe_d_ff; shared_down from shared_experts *
    moe_d_ff; the prefix MLP's w_down from d_ff."""
    cfg = _cfg("deepseek-gqa", d_model=256, moe_d_ff=512, shared_experts=2,
               d_ff=1024)
    model = tT.init_params(cfg, seed=0, device="cpu")
    moe = model.layers[0].moe
    for name, fan in tT.MoE.fan_in(cfg).items():
        std = float(getattr(moe, name).float().std())
        # a normal truncated at 3 sigma has std 0.9866 sigma
        assert abs(std / (0.9866 * fan ** -0.5) - 1) < 0.05, (name, std)
    std = float(model.dense_prefix[0].mlp.w_down.float().std())
    assert abs(std / (0.9866 * cfg.d_ff ** -0.5) - 1) < 0.05


def test_training_a_moe_config_is_refused():
    cfg = treg.get_arch("mixtral-8x7b", smoke=True)
    with pytest.raises(NotImplementedError,
                       match="mixtral-smoke.*ROADMAP.md Queue 1 item "
                             "10b-train"):
        tsteps.make_train_step(cfg)
    model = tT.init_params(cfg, device="cpu", master=True)
    toks = torch.ones((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="10b-train"):
        tT.loss_fn(cfg, model, {"tokens": toks, "labels": toks})


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
def test_moe_on_the_card(cuda):
    """mixtral-smoke on the card (flash kernel, cuBLAS expert products)
    against the same weights on the CPU by the MoE criterion; the first
    layer's router ids equal away from near-ties; a second prefill gives
    the same bits."""
    cfg = treg.get_arch("mixtral-8x7b", smoke=True)
    cpu_model = tT.init_params(cfg, seed=1, device="cpu")
    model = copy.deepcopy(cpu_model).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (B, S)))
    before = tflash.flash_attention_cuda.launches
    with torch.no_grad():
        fwd = (tT.forward(cfg, model, toks.to(cuda)) @ model.head()).float()
    assert tflash.flash_attention_cuda.launches - before == cfg.num_layers
    want = (tT.forward(cfg, cpu_model, toks) @ cpu_model.head()).float()
    _moe_criterion(fwd.cpu().numpy(), want.numpy())

    h = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B * S, cfg.d_model)).astype(np.float32)).bfloat16()
    router = cpu_model.layers[0].moe.router
    _, ids, probs = tmoe.router_topk(h, router, cfg.top_k)
    _, gids, _ = tmoe.router_topk(h.to(cuda), router.to(cuda), cfg.top_k)
    ranked = probs.sort(-1, descending=True).values
    clear = ranked[:, cfg.top_k - 1] - ranked[:, cfg.top_k] > NEAR_TIE
    assert torch.equal(gids.cpu()[clear], ids[clear])

    prefill = tsteps.make_prefill_step(cfg)
    a = prefill(model, {"tokens": toks.to(cuda)})
    b = prefill(model, {"tokens": toks.to(cuda)})
    assert torch.equal(a, b)
