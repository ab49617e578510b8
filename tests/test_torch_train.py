"""The port's training slice on the CPU against the JAX package: loss,
gradients, the train step, the attention gradient, and the trainer's
end-to-end behaviour (the counterparts of ``tests/test_system.py:15-41``).

Tolerances, each derived from a distance the port already holds:
  * the loss: both packages run the same bf16 forward on the same weights
    (``params_from_jax``), which ``tests/test_torch_models.py`` holds to a
    hidden-state distance of ~1.4% of its magnitude (mean 0.011 on ~0.8);
    a mean NLL averages those differences: measured 1.0e-4 to 2.3e-4
    relative on the four dense smoke configs (3.5e-5 on falcon-mamba's,
    6.7e-5 on hymba's), bound ``LOSS_RTOL`` 1e-3;
  * every parameter gradient, as a relative Frobenius error per leaf (the
    reference's stacked (G, P, ...) leaf against the port's layers stacked
    the same way): the backward runs through the same bf16 activations, so
    it inherits that ~1.4%: measured 0.6% to 2.5% on the four configs,
    at most 1.4% on falcon-mamba's (w_dt) and 2.1% on hymba's (D; the
    scan's plain backward against ``jax.grad`` of the associative scan),
    bound ``GRAD_RTOL`` 5e-2;
  * a train step's update p_new - p_old, per leaf, relative Frobenius
    against the reference's from the same params and AdamW state
    (``STEP_RTOL``).  From zero moments AdamW moves each entry by
    lr (sign(g) + wd p), so a gradient entry within the packages' ~2.5%
    gradient distance of zero flips its sign and moves the update by
    2 lr: measured 0.08 to 0.18 on the smoke tinyllama (final_norm, 256
    entries, the most), bound 0.3.  From nonzero moments m / sqrt(v) is
    continuous in g and the update inherits the gradient distance:
    measured 0.005 to 0.028, and 0.080 for embed, whose rows first seen
    in that step's batch move by a sign again; bound 0.1.  No update at
    all is 1.0 off, a wrong gradient about 1.4;
  * the attention gradient (the plain backward against ``jax.grad`` of the
    JAX package's jnp attention, bf16 inputs): the JAX scan rounds q *
    scale and P to bf16 (and its cotangents at each cast), the port's
    plain backward keeps P and dS in float32 and rounds only its outputs:
    measured 0.21% to 0.42% relative per tensor at the flash test shapes,
    bound ``ATTN_RTOL`` 2e-2.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

LOSS_RTOL, GRAD_RTOL, ATTN_RTOL = 1e-3, 5e-2, 2e-2
STEP_RTOL = (0.3, 0.1)           # the first train step's update, then later
B, S, CHUNK = 2, 32, 8           # loss_chunk < S: four chunks
# gemma3: period 6, tied, windows; falcon-mamba: mamba layers alone;
# hymba: attention and mamba heads in parallel
ARCHS = ["tinyllama-1.1b", "gemma3-12b", "falcon-mamba-7b", "hymba-1.5b"]


def _batch(cfg, seed=4, batch=B):
    """tokens and next-token labels with a run of -1 (ignored) labels."""
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (batch, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)],
                            axis=1)
    labels[:, 5:9] = -1
    return toks, labels


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    cfg = jreg.get_arch(name, smoke=True)
    return cfg, jT.init_params(cfg, jax.random.PRNGKey(0))


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(name, params):
    return tT.params_from_jax(treg.get_arch(name, smoke=True),
                              _tree(params), device="cpu", master=True)


def _stacked(model, cfg, path, attr="grad"):
    """The port's tensors (``.grad`` or the parameter) under the
    reference's flattened ``path``, layer leaves stacked (G, P, ...)."""
    named = dict(model.named_parameters())
    get = (lambda n: getattr(named[n], attr).detach().numpy()) if attr \
        else (lambda n: named[n].detach().numpy())
    if not path.startswith("layers/"):
        return get(path)
    leaf, P = path[len("layers/"):].replace("/", "."), cfg.period
    return np.stack([np.stack([get(f"layers.{g * P + p}.{leaf}")
                               for p in range(P)])
                     for g in range(cfg.num_groups)])


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - np.asarray(want, np.float64))
                 / max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_every_gradient_near_jax(name):
    jcfg, params = _jax_params(name)
    toks, labels = _batch(jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jT.loss_fn(jcfg, p, b, loss_chunk=CHUNK)))(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    cfg = treg.get_arch(name, smoke=True)
    model = _port_model(name, params)
    got = tT.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks).long(),
                                  "labels": torch.from_numpy(labels).long()},
                     loss_chunk=CHUNK)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(loss),
                               rtol=LOSS_RTOL)
    got.backward()
    want = tckpt.flatten(_tree(grads))
    assert sum(w.size for w in want.values()) == sum(
        p.numel() for p in model.parameters())
    for path, w in want.items():
        g = _stacked(model, cfg, path)
        assert g.dtype == np.float32 and g.shape == w.shape, path
        assert _rel(g, w) < GRAD_RTOL, (path, _rel(g, w))


def test_loss_chunks_and_ignored_labels():
    """One chunk and four give the same loss (the chunks' sums in order),
    and a label of -1 adds nothing: the loss over the kept labels alone."""
    cfg = treg.get_arch("tinyllama-1.1b", smoke=True)
    model = tT.init_params(cfg, seed=2, device="cpu", master=True)
    toks, labels = (torch.from_numpy(a).long() for a in _batch(cfg, seed=7))
    with torch.no_grad():
        four = tT.loss_fn(cfg, model, {"tokens": toks, "labels": labels},
                          loss_chunk=CHUNK)
        one = tT.loss_fn(cfg, model, {"tokens": toks, "labels": labels},
                         loss_chunk=S)
        h = tT.forward(cfg, model, toks)
        logits = (h @ model.head()).float()
        keep = labels >= 0
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels.clamp(min=0)[..., None])[..., 0]
    torch.testing.assert_close(four, one, rtol=1e-6, atol=0)
    torch.testing.assert_close(four, nll[keep].mean(), rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="multiple of"):
        tT.loss_fn(cfg, model, {"tokens": toks[:, :31], "labels":
                                labels[:, :31]}, loss_chunk=CHUNK)


def test_master_and_serve_forms_share_the_forward():
    """The float32 master form casts per call to the serve form's stored
    bf16: the same hidden states, bit for bit; only the master form takes
    gradients, and ``remat_policy`` 'save_tp_out' is refused by name."""
    cfg = treg.get_arch("tinyllama-1.1b", smoke=True)
    serve = tT.init_params(cfg, seed=3, device="cpu")
    master = tT.init_params(cfg, seed=3, device="cpu", master=True)
    assert all(not p.requires_grad for p in serve.parameters())
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in master.parameters())
    toks = torch.from_numpy(_batch(cfg)[0]).long()
    with torch.no_grad():
        a = tT.forward(cfg, serve, toks)
        b = tT.forward(cfg, master, toks)
        c = tT.forward(cfg, master, toks, remat=True)
    assert torch.equal(a, b) and torch.equal(b, c)
    tp = dataclasses.replace(cfg, remat_policy="save_tp_out")
    with pytest.raises(NotImplementedError, match="save_tp_out"):
        tT.Transformer(tp, device="cpu", master=True)(toks, remat=True)


def test_decay_mask_follows_the_reference_leaves():
    """The reference decays leaves of two or more dimensions, its layer
    leaves stacked (G, P, ...): every layer parameter, embed and lm_head,
    but not final_norm."""
    for name in ARCHS + ["starcoder2-7b"]:
        jcfg, params = _jax_params(name)
        ndim = {k: v.ndim for k, v in tckpt.flatten(_tree(params)).items()}
        model = _port_model(name, params)
        for pname, decayed in tT.decay_mask(model).items():
            path = ("layers/" + pname.split(".", 2)[2].replace(".", "/")
                    if pname.startswith("layers.") else pname)
            assert decayed == (ndim[path] >= 2), pname


def test_flops_and_active_params_equal_jax():
    for name in ("tinyllama-1.1b", "gemma3-12b", "h2o-danube-3-4b",
                 "falcon-mamba-7b", "hymba-1.5b"):
        jcfg, tcfg = jreg.get_arch(name), treg.get_arch(name)
        assert tT.active_param_count(tcfg) == jT.active_param_count(jcfg)
        for seq, kind in ((2048, "train"), (4096, "prefill"),
                          (100_000, "train")):
            assert tT.model_flops_per_token(tcfg, seq, kind) == pytest.approx(
                jT.model_flops_per_token(jcfg, seq, kind), rel=1e-12)


def _port_opt(name, jopt):
    """The reference's AdamW state as the port's: m and v under the port's
    parameter names (``params_from_jax`` maps the trees, float32 as is)."""
    cfg = treg.get_arch(name, smoke=True)

    def by_name(tree):
        model = tT.params_from_jax(cfg, _tree(tree), device="cpu",
                                   master=True)
        return {k: p.detach() for k, p in model.named_parameters()}
    return tadamw.AdamWState(step=int(jopt.step), m=by_name(jopt.m),
                             v=by_name(jopt.v))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_near_jax(microbatches):
    """Two steps, each from the reference's own params and AdamW state:
    the first from zero moments (its update lr (sign(g) + wd p)), the
    second from the first's m and v, where m / sqrt(v) is no longer a sign
    and the clipped gradient's scale counts.  loss, grad_norm and lr near
    JAX's, and each leaf's update p_new - p_old within ``STEP_RTOL`` of
    JAX's, relative Frobenius."""
    name = "tinyllama-1.1b"
    jcfg0, jp = _jax_params(name)
    jcfg = dataclasses.replace(jcfg0, microbatches=microbatches)
    cfg = dataclasses.replace(treg.get_arch(name, smoke=True),
                              microbatches=microbatches)
    sched = dict(base_lr=1e-2, warmup=2, total_steps=10, loss_chunk=CHUNK)
    jstep = jax.jit(jsteps.make_train_step(jcfg, **sched))
    step = tsteps.make_train_step(cfg, **sched)
    jopt = jadamw.adamw_init(jp)
    for seed in (5, 9):
        toks, labels = _batch(jcfg, seed=seed, batch=4)
        jp2, jopt2, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
        model = _port_model(name, jp)
        model.cfg = cfg
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
            assert rel < STEP_RTOL[opt.step > 1], (opt.step, path, rel)
        assert all(p.grad is None for p in model.parameters())
        jp, jopt = jp2, jopt2


def test_microbatches_sum_float32_gradients_one_at_a_time():
    """Two microbatches: the loss and the gradients are the mean of the
    halves' (the second half's gradient added to the first's in float32,
    then divided by 2), bit for bit."""
    cfg = treg.get_arch("tinyllama-1.1b", smoke=True)
    toks, labels = (torch.from_numpy(a).long()
                    for a in _batch(cfg, seed=6, batch=4))
    grads, losses = [], []
    for half in (slice(0, 2), slice(2, 4)):
        model = tT.init_params(cfg, seed=8, device="cpu", master=True)
        loss = tT.loss_fn(cfg, model, {"tokens": toks[half],
                                       "labels": labels[half]},
                          loss_chunk=CHUNK)
        loss.backward()
        losses.append(loss.detach())
        grads.append({k: p.grad for k, p in model.named_parameters()})
    seen, decay = {}, {}
    real = tadamw.adamw_update

    def spy(g, *a, **kw):
        seen.update({k: v.clone() for k, v in g.items()})
        decay.update(kw["decay"])
        return real(g, *a, **kw, clip_norm=None)
    model = tT.init_params(cfg, seed=8, device="cpu", master=True)
    cfg2 = dataclasses.replace(cfg, microbatches=2)
    model.cfg = cfg2
    tsteps.adamw_update, saved = spy, tsteps.adamw_update
    try:
        _, _, m = tsteps.make_train_step(cfg2, loss_chunk=CHUNK)(
            model, tadamw.adamw_init(model), {"tokens": toks,
                                              "labels": labels})
    finally:
        tsteps.adamw_update = saved
    assert torch.equal(m["loss"], (losses[0] + losses[1]) / 2)
    assert decay == tT.decay_mask(model)       # the reference's decay leaves
    for k, g in seen.items():
        assert torch.equal(g, (grads[0][k] + grads[1][k]) / 2), k


# ---------------------------------------------------------------------------
# the attention gradient
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KVH, hd, window, causal): tests/test_torch_flash.py's
ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 64, 0, True),
    (1, 256, 256, 2, 1, 64, 64, True),
    (2, 100, 100, 4, 4, 32, 0, True),
    (1, 64, 192, 2, 2, 64, 0, False),
    (1, 128, 128, 2, 2, 128, 32, True),
    (1, 384, 384, 2, 2, 64, 64, True),
    (1, 136, 136, 4, 2, 120, 48, True),
    (1, 96, 160, 2, 1, 256, 0, False),
]


def _attn_inputs(B, Sq, Sk, H, KVH, hd, window, causal):
    """q, k, v and the output gradient, float32 numpy, from a seed."""
    rng = np.random.default_rng(Sq + hd)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KVH, hd), (B, Sk, KVH, hd),
                      (B, Sq, H, hd))]


@functools.lru_cache(maxsize=None)
def _jax_attention_grads():
    """``jax.grad`` of the JAX jnp attention at every ``ATTN_SHAPES``
    entry, all in one compiled function (one compile, not eight):
    (dq, dk, dv) float32 numpy per shape."""
    def grads(shape, q, k, v, dout):
        window, causal = shape[6], shape[7]

        def f(q_, k_, v_):
            out = jattn.flash_attention(q_, k_, v_, window, causal=causal,
                                        kv_chunk=64)
            return jnp.sum(out.astype(jnp.float32)
                           * dout.astype(jnp.float32))
        return [g.astype(jnp.float32)
                for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]
    inputs = [[jnp.asarray(a, jnp.bfloat16) for a in _attn_inputs(*s)]
              for s in ATTN_SHAPES]
    out = jax.jit(lambda xs: [grads(s, *x)
                              for s, x in zip(ATTN_SHAPES, xs)])(inputs)
    return [[np.asarray(g) for g in gs] for gs in out]


@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=["-".join(map(str, s)) for s in ATTN_SHAPES])
def test_plain_attention_backward_near_jax_grad(shape):
    window, causal = shape[6], shape[7]
    want = _jax_attention_grads()[ATTN_SHAPES.index(shape)]
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _attn_inputs(*shape))
    out = ops.flash_attention(q, k, v, window=window, causal=causal)
    got = ops.flash_attention_bwd(q, k, v, out, dout, window=window,
                                  causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        rel = _rel(g.float().numpy(), w)
        assert rel < ATTN_RTOL, (f"d{name}", rel)


# ---------------------------------------------------------------------------
# the trainer end to end (tests/test_system.py:15-41)
# ---------------------------------------------------------------------------

def test_train_loop_loss_decreases(tmp_path):
    cfg = treg.get_arch("tinyllama-1.1b", smoke=True)
    loss, hist = ttrain.train(cfg, steps=30, global_batch=4, seq=64,
                              ckpt_dir=str(tmp_path / "ck"), ckpt_every=10,
                              lr=3e-3, log_every=5, device="cpu")
    first = hist[0]["loss"]
    assert loss < first, (first, loss)
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]


def _final_state(ckpt_dir, cfg):
    """(params by name, AdamW state) of the newest checkpoint."""
    model = tT.init_params(cfg, seed=0, device="cpu", master=True)
    step = tckpt.latest_step(ckpt_dir)
    opt = ttrain._restore(ckpt_dir, step, model)
    return dict(model.named_parameters()), opt, step


def test_train_resume_after_failure_is_bit_exact(tmp_path, capsys):
    """A crashed run resumes from its checkpoint and ends with the same
    loss, parameters and AdamW state as an uninterrupted run, bit for bit
    (the reference holds its loss to rel 1e-3)."""
    cfg = treg.get_arch("tinyllama-1.1b", smoke=True)
    kw = dict(steps=20, global_batch=4, seq=64, ckpt_every=10, lr=1e-3,
              log_every=20, device="cpu")
    ck1, ck2 = str(tmp_path / "a"), str(tmp_path / "b")
    loss_ref, _ = ttrain.train(cfg, ckpt_dir=ck1, **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train(cfg, ckpt_dir=ck2, fail_at_step=15, **kw)
    assert tckpt.latest_step(ck2) == 10
    loss_resumed, _ = ttrain.train(cfg, ckpt_dir=ck2, **kw)
    assert "[train] resumed from step 10" in capsys.readouterr().out
    assert loss_resumed == loss_ref
    pa, oa, sa = _final_state(ck1, cfg)
    pb, ob, sb = _final_state(ck2, cfg)
    assert sa == sb == 20 and oa.step == ob.step == 20
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        assert torch.equal(oa.m[k], ob.m[k]) and torch.equal(oa.v[k],
                                                             ob.v[k]), k


def test_train_cli_on_the_cpu(tmp_path, capsys):
    ttrain.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "2",
                 "--global-batch", "2", "--seq", "32", "--ckpt-dir",
                 str(tmp_path / "ck"), "--ckpt-every", "1", "--device",
                 "cpu"])
    out = capsys.readouterr().out
    assert "[train] step     2 loss=" in out and "[train] done" in out
    assert tckpt.latest_step(str(tmp_path / "ck")) == 2
    assert tckpt.latest_step(str(tmp_path / "ck" / "opt")) == 2


def test_gemma3_training_cut_holds_the_reference_parameter_count():
    """``chip_smoke.py`` phase 12e's configuration (gemma3-12b at full
    width, depth cut to one period of its window pattern), from shapes
    alone: the port's parameter count equals the JAX package's for the
    same replaced config (an abstract init, nothing allocated or
    compiled), the layers hold five windowed layers and one global one,
    and the count is the ~2.35B the phase's memory reckoning takes."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tcfg = dataclasses.replace(treg.get_arch(cs.GEMMA_ARCH),
                               num_layers=cs.GEMMA_LAYERS)
    jcfg = dataclasses.replace(jreg.get_arch(cs.GEMMA_ARCH),
                               num_layers=cs.GEMMA_LAYERS)
    shapes = tT._param_shapes(tcfg)
    assert shapes["layers/attn/wq"][:2] == (1, 6)        # one group of 6
    assert "lm_head" not in shapes                       # tied embeddings
    n = tT.param_count(tcfg)
    assert n == jT.param_count(jcfg)
    assert 2.30e9 < n < 2.40e9
    windows = [tcfg.window_pattern[i % tcfg.period]
               for i in range(tcfg.num_layers)]
    assert windows == [1024] * 5 + [0]
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim,
            tcfg.d_ff, tcfg.vocab_size) == (3840, 16, 8, 256, 15360, 262144)
