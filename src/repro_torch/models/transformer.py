"""The dense GQA, SSM, hybrid and MoE transformer families — init,
forward, loss, decode — in PyTorch: the counterpart of
``repro/models/transformer.py``.

Covers every dense config of the registry (tinyllama-1.1b,
h2o-danube-3-4b, gemma3-12b, starcoder2-7b: swiglu or gelu MLP, any
``window_pattern``, tied or untied embeddings), the SSM family
(falcon-mamba-7b: mamba layers, no attention, no MLP), the hybrid one
(hymba-1.5b: attention and mamba heads in parallel, then the MLP) and the
MoE family with GQA attention (mixtral-8x7b: ``models/moe.py`` in place of
the MLP; shared experts and a dense prefix as DeepSeek's, which itself
needs MLA).  The other families (MLA, encoder-decoder, VLM stub) raise
``NotImplementedError``.  Every ported family but MoE trains
(``loss_fn``); MoE serves only.

Design notes
------------
* **Modules.** ``Transformer`` holds ``embed``, the ``dense_prefix``
  layers (``cfg.first_dense_layers``, each with an ``MLP`` of ``d_ff`` and
  window ``window_pattern[0]``), one ``Layer`` per layer of the stack
  (``cfg.scan_layers``: ``ln1``; ``attn`` = ``Attention`` when the family
  has attention; ``ssm`` = ``ssm.Mamba`` and, when parallel, ``ln_ssm``;
  ``ln2`` and ``moe`` = ``MoE`` in a MoE config, else ``ln2`` and ``mlp``
  = ``MLP`` when ``d_ff > 0``), ``final_norm`` and, untied, ``lm_head``.
  Weights keep the JAX package's layout (``x @ w``, w of shape (d_in,
  d_out)), so ``params_from_jax`` is a copy.  Stack layer ``g * P + p``
  is the reference's stacked leaf ``[g, p]`` (P =
  ``len(cfg.window_pattern)``) and has window ``window_pattern[p]``;
  prefix layer i is its ``dense_prefix[i]``.
* **The mix**, as the reference's ``_layer``: attention alone, mamba
  alone, or for ``parallel_ssm`` ``(attn + ssm) * 0.5`` summed in bf16;
  an SSM-only layer returns after the mixer.
* **Mixed precision**, as the reference's ``_cast_params``: weights of two
  or more dimensions compute in bf16, 1-D norm scales and biases in
  float32, the residual stream is bf16, and logits are the bf16 product
  widened to float32 (the SSM branch's own promotions: ``models/ssm.py``).
  Two forms of the same model: the **serve form** stores those weights in
  bf16 (cast once at load: the same bits as the reference's per-call
  cast), every parameter with ``requires_grad=False``; the **master form**
  (``master=True``, the trainer's) stores every parameter in float32 with
  ``requires_grad=True`` and casts per call, so its gradients are float32,
  as the reference's.
* **Training** (``loss_fn``): the chunked next-token cross entropy with
  each chunk rematerialised, over a forward whose every group of
  ``len(window_pattern)`` layers is rematerialised
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
  scan body; ``remat_policy`` "full").  The attention gradient is the
  flash backward kernel (``models/attention.py``, ``FlashAttention``),
  the selective scan's the scan's backward kernel (``models/ssm.py``,
  ``SelectiveScan``); each kernel's forward runs twice a step (the
  forward and its rematerialisation), its backward once.
* **Decode caches**, laid out as the reference's, per slot p: attention
  ring buffers of ``min(window, seq)`` slots with an absolute-position
  array (``pos``) for masking, ``k``/``v`` (G, B, KVH, S_w, hd) and
  ``pos`` (G, S_w); the SSM's ``conv`` (G, B, K-1, d_inner) in the compute
  dtype and ``state`` (G, B, d_inner, N) float32; per prefix layer an
  entry of ``dense_prefix``, ``k``/``v`` (B, KVH, S_w, hd) and ``pos``
  (S_w,).  The MoE layer's decode is ``moe_ffn`` at T = B tokens, with the
  capacity of that T.  ``decode_step`` writes
  them in place (the reference returns a new tree) and returns the same
  dict; ``length`` is a Python int.
* **Vocab padding.** Embedding / lm-head pad the vocab to a multiple of
  128, so shapes and logits equal the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (COMPUTE_DTYPE, compute_weight as _compute,
                     new_weight as _weight, rms_norm, rope,
                     truncated_normal_init)

__all__ = ["Transformer", "init_params", "params_from_jax", "forward",
           "loss_fn", "init_cache", "decode_step", "param_count",
           "active_param_count", "model_flops_per_token", "decay_mask",
           "decode_gap_by_layer", "check_trainable", "MOE_GAP_QUANTILE",
           "COMPUTE_DTYPE"]


def _pad_vocab(v: int) -> int:
    return ((v + 127) // 128) * 128


# the attention each ported family runs
_PORTED = {"dense": "gqa", "ssm": "none", "hybrid": "gqa", "moe": "gqa"}


def _require_ported(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    family = None
    if cfg.attention == "mla":
        family = "MLA"
    elif cfg.encoder_layers:
        family = "encoder-decoder"
    elif cfg.num_image_tokens:
        family = "VLM"
    elif _PORTED.get(cfg.family) != cfg.attention:
        family = f"{cfg.family} / {cfg.attention}"
    if family is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {family} family is not ported yet (ROADMAP.md "
            f"Queue 1 item 10: the port runs the dense GQA, SSM, hybrid "
            f"and GQA MoE families)")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a config the port serves but does not train yet."""
    _require_ported(cfg)
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: training the MoE family is not ported yet "
            f"(ROADMAP.md Queue 1 item 10b-train); it serves only")


def _param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The reference's parameter tree, flattened to '/'-joined paths, with
    the stacked (G, P, ...) layer shapes."""
    _require_ported(cfg)
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G, P, vp, f = cfg.num_groups, cfg.period, _pad_vocab(cfg.vocab_size), \
        cfg.d_ff
    attn = {"attn/wq": (d, H * hd), "attn/wk": (d, KVH * hd),
            "attn/wv": (d, KVH * hd), "attn/wo": (H * hd, d)}
    mlp = {"mlp/w_up": (d, f), "mlp/w_down": (f, d)}
    if cfg.mlp_type == "swiglu":
        mlp["mlp/w_gate"] = (d, f)
    layer = {"ln1": (d,)}
    if cfg.is_moe or f > 0:          # mamba-only layers carry no ffn
        layer["ln2"] = (d,)
    if cfg.has_attention:
        layer.update(attn)
    if cfg.has_ssm:
        layer.update({f"ssm/{k}": v
                      for k, v in ssm_lib.Mamba.shapes(cfg).items()})
        if cfg.parallel_ssm:
            layer["ln_ssm"] = (d,)
    if cfg.is_moe:
        layer.update({f"moe/{k}": v for k, v in MoE.shapes(cfg).items()})
    elif f > 0:
        layer.update(mlp)
    shapes = {"embed": (vp, d), "final_norm": (d,),
              **{f"layers/{k}": (G, P, *v) for k, v in layer.items()}}
    for i in range(cfg.first_dense_layers):
        shapes.update({f"dense_prefix/{i}/{k}": v for k, v in
                       {"ln1": (d,), "ln2": (d,), **attn, **mlp}.items()})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, vp)
    return shapes


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the model, from shapes alone (nothing allocated)."""
    return sum(math.prod(s) for s in _param_shapes(cfg).values())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token: all of them, less a MoE config's
    inactive experts (E - top_k of them in every stack layer, three
    d x moe_d_ff matrices each), as the reference counts."""
    inactive = 0
    if cfg.is_moe:
        inactive = ((cfg.num_experts - cfg.top_k) * 3 * cfg.d_model
                    * cfg.moe_d_ff * cfg.scan_layers)
    return param_count(cfg) - inactive


def model_flops_per_token(cfg: ModelConfig, seq_len: int,
                          kind: str = "train") -> float:
    """MODEL_FLOPS: 6 N_active per token for train, 2 N_active for
    forward, plus the attention term 6 (2 forward) L H hd S_eff, S_eff the
    mean over the window pattern of min(window, S) (the reference's
    formula)."""
    N = active_param_count(cfg)
    mult = 6.0 if kind == "train" else 2.0
    eff = sum(min(w if w > 0 else seq_len, seq_len)
              for w in cfg.window_pattern) / cfg.period
    return mult * N + mult * cfg.num_layers * cfg.num_heads * cfg.head_dim \
        * eff


# ===========================================================================
# Modules
# ===========================================================================

def _mlp_apply(cfg: ModelConfig, h, p):
    if cfg.mlp_type == "swiglu":
        m = F.silu(h @ p["w_gate"]) * (h @ p["w_up"])
    else:        # jax.nn.gelu defaults to the tanh approximation
        m = F.gelu(h @ p["w_up"], approximate="tanh")
    return m @ p["w_down"]


class Attention(nn.Module):
    """GQA projections: wq (d, H*hd), wk/wv (d, KVH*hd), wo (H*hd, d)."""

    def __init__(self, cfg: ModelConfig, device=None, master: bool = False):
        super().__init__()
        d, H, KVH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        self.cfg = cfg
        self.wq = _weight((d, H * hd), COMPUTE_DTYPE, device, master)
        self.wk = _weight((d, KVH * hd), COMPUTE_DTYPE, device, master)
        self.wv = _weight((d, KVH * hd), COMPUTE_DTYPE, device, master)
        self.wo = _weight((H * hd, d), COMPUTE_DTYPE, device, master)

    def weights(self) -> Dict[str, torch.Tensor]:
        return {"wq": _compute(self.wq), "wk": _compute(self.wk),
                "wv": _compute(self.wv), "wo": _compute(self.wo)}

    def forward(self, h, rope_cs, window: int, causal: bool = True):
        cfg = self.cfg
        out, _ = attn_lib.gqa_attend(
            h, self.weights(), num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            window=window, rope_cos=rope_cs[0], rope_sin=rope_cs[1],
            causal=causal)
        return out


class MLP(nn.Module):
    """swiglu (w_gate, w_up, w_down) or gelu (w_up, w_down)."""

    def __init__(self, cfg: ModelConfig, device=None, master: bool = False):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        if cfg.mlp_type == "swiglu":
            self.w_gate = _weight((d, f), COMPUTE_DTYPE, device, master)
        self.w_up = _weight((d, f), COMPUTE_DTYPE, device, master)
        self.w_down = _weight((f, d), COMPUTE_DTYPE, device, master)

    def forward(self, h):
        return _mlp_apply(self.cfg, h, {k: _compute(w) for k, w
                                        in self.named_parameters()})


class MoE(nn.Module):
    """The MoE ffn (``models/moe.py``): router (d, E), w_gate / w_up (E, d,
    moe_d_ff), w_down (E, moe_d_ff, d) and, with shared experts,
    shared_gate / shared_up (d, shared_experts * moe_d_ff) and shared_down
    (shared_experts * moe_d_ff, d)."""

    def __init__(self, cfg: ModelConfig, device=None, master: bool = False):
        super().__init__()
        self.cfg = cfg
        for name, shape in self.shapes(cfg).items():
            setattr(self, name, _weight(shape, COMPUTE_DTYPE, device, master))

    @staticmethod
    def shapes(cfg: ModelConfig) -> Dict[str, tuple]:
        d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
                  "w_down": (E, f, d)}
        if cfg.shared_experts > 0:
            fs = cfg.shared_experts * f
            shapes.update(shared_gate=(d, fs), shared_up=(d, fs),
                          shared_down=(fs, d))
        return shapes

    @staticmethod
    def fan_in(cfg: ModelConfig) -> Dict[str, int]:
        """Each leaf's fan-in, as the reference's ``_init_moe``."""
        d = cfg.d_model
        return {"router": d, "w_gate": d, "w_up": d, "w_down": cfg.moe_d_ff,
                "shared_gate": d, "shared_up": d,
                "shared_down": cfg.shared_experts * cfg.moe_d_ff}

    def forward(self, h):
        cfg = self.cfg
        return moe_lib.moe_ffn(
            h, {k: _compute(w) for k, w in self.named_parameters()},
            top_k=cfg.top_k, capacity_factor=cfg.moe_capacity_factor)


class Layer(nn.Module):
    """Pre-norm block: x + mix(norm(x)), then + ffn(norm(x)) where the
    layer has one (the MLP, or in a MoE config's stack the MoE).  The mix
    is attention, mamba, or (``parallel_ssm``) the mean of attention on
    norm(x) and mamba on its own norm.  ``dense=True``: a dense-prefix
    layer (attention and an MLP of ``d_ff``)."""

    def __init__(self, cfg: ModelConfig, window: int, device=None,
                 master: bool = False, dense: bool = False):
        super().__init__()
        self.cfg, self.window = cfg, window
        d = cfg.d_model
        moe = cfg.is_moe and not dense
        has_ffn = moe or cfg.d_ff > 0
        self.ln1 = _weight((d,), torch.float32, device, master)
        self.attn = (Attention(cfg, device, master) if cfg.has_attention
                     else None)
        self.ssm = (ssm_lib.Mamba(cfg, device, master)
                    if cfg.has_ssm and not dense else None)
        self.ln_ssm = (_weight((d,), torch.float32, device, master)
                       if self.ssm is not None and cfg.parallel_ssm else None)
        self.ln2 = (_weight((d,), torch.float32, device, master)
                    if has_ffn else None)
        self.mlp = MLP(cfg, device, master) if has_ffn and not moe else None
        self.moe = MoE(cfg, device, master) if moe else None

    def _mix(self, x, attend, scan):
        """x + the mixer's output; ``attend(h)`` and ``scan(h)`` run the
        branches on their normed inputs."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        mix = attend(h) if self.attn is not None else None
        if self.ssm is not None:
            hs = (rms_norm(x, self.ln_ssm, cfg.norm_eps)
                  if self.ln_ssm is not None else h)
            s = scan(hs)
            mix = s if mix is None else mix + s
            if cfg.parallel_ssm:
                mix = mix * 0.5
        return x + mix

    def _ffn(self, x):
        if self.ln2 is None:             # ssm-only layer: no ffn
            return x
        ffn = self.moe if self.moe is not None else self.mlp
        return x + ffn(rms_norm(x, self.ln2, self.cfg.norm_eps))

    def forward(self, x, rope_cs):
        x = self._mix(x, lambda h: self.attn(h, rope_cs, self.window),
                      self.ssm)
        return self._ffn(x)

    def decode(self, x, entry, q_pos: int):
        """One token; ``entry`` is this layer's view of its slot of the
        cache ({k, v, pos} under "kv", {conv, state} under "ssm"),
        written in place."""
        x = self._mix(
            x, lambda h: _decode_gqa(self.cfg, h, self.attn.weights(),
                                     entry["kv"], self.window, q_pos),
            lambda h: self.ssm.decode(h, entry["ssm"]))
        return self._ffn(x)


def _run_group(layers, x, rope_cs):
    for layer in layers:
        x = layer(x, rope_cs)
    return x


class Transformer(nn.Module):
    """The dense GQA, SSM, hybrid or MoE model; parameters are allocated
    empty on ``device`` and filled by ``init_params`` (from a seed) or
    ``params_from_jax``.  ``master=True`` gives the trainer's float32 form
    (module docstring)."""

    def __init__(self, cfg: ModelConfig, device=None, master: bool = False):
        super().__init__()
        _require_ported(cfg)
        device = resolve_device(device)
        self.cfg, self.master = cfg, master
        vp = _pad_vocab(cfg.vocab_size)
        self.embed = _weight((vp, cfg.d_model), COMPUTE_DTYPE, device, master)
        self.dense_prefix = nn.ModuleList(
            Layer(cfg, cfg.window_pattern[0], device, master, dense=True)
            for _ in range(cfg.first_dense_layers))
        self.layers = nn.ModuleList(
            Layer(cfg, cfg.window_pattern[i % cfg.period], device, master)
            for i in range(cfg.scan_layers))
        self.final_norm = _weight((cfg.d_model,), torch.float32, device,
                                  master)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.d_model, vp), COMPUTE_DTYPE, device,
                                   master)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        """The (d, vocab_padded) output projection, bf16."""
        return _compute(self.embed.T if self.cfg.tie_embeddings
                        else self.lm_head)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The bf16 embeddings of ``tokens`` (rows gathered, then cast: the
        values of the reference's cast-then-gather; the master form's
        gradient scatters in float32)."""
        return F.embedding(tokens, self.embed).to(COMPUTE_DTYPE)

    def forward(self, tokens: torch.Tensor, remat: bool = False
                ) -> torch.Tensor:
        """tokens (B, S) int -> final hidden states (B, S, d), bf16.
        ``remat``: rematerialise each group of ``len(window_pattern)``
        layers in the backward (``remat_policy`` "full"); only the group
        boundaries are kept."""
        cfg = self.cfg
        if remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"{cfg.name}: remat_policy {cfg.remat_policy!r} is not "
                f"ported (the port rematerialises whole groups, 'full'; "
                f"ROADMAP.md Queue 1 item 10)")
        x = self.embed_tokens(tokens)
        rope_cs = (_rope_tables(cfg, torch.arange(x.shape[1],
                                                  device=x.device))
                   if cfg.has_attention else None)
        x = _run_group(self.dense_prefix, x, rope_cs)
        P = cfg.period
        for g0 in range(0, len(self.layers), P):
            group = self.layers[g0:g0 + P]
            if remat:
                x = checkpoint(_run_group, group, x, rope_cs,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _run_group(group, x, rope_cs)
        return rms_norm(x, self.final_norm, cfg.norm_eps)


# ===========================================================================
# Parameters
# ===========================================================================

def _layer_leaves(layer: Layer, prefix: str) -> Dict[str, torch.Tensor]:
    """A layer's parameters under the reference's paths below ``prefix``
    ('layers' for the stack, 'dense_prefix/<i>' for a prefix layer)."""
    out = {f"{prefix}/{name}": p for name in ("ln1", "ln2", "ln_ssm")
           if (p := getattr(layer, name)) is not None}
    for sub in ("attn", "ssm", "mlp", "moe"):
        if getattr(layer, sub) is not None:
            for name, p in getattr(layer, sub).named_parameters():
                out[f"{prefix}/{sub}/{name}"] = p
    return out


def _all_layer_leaves(model: Transformer):
    """(path, parameter, index into the reference's leaf) of every layer
    parameter: [g, p] for stack layer g * P + p, () for a prefix layer."""
    for i, layer in enumerate(model.dense_prefix):
        for path, p in _layer_leaves(layer, f"dense_prefix/{i}").items():
            yield path, p, ()
    for i, layer in enumerate(model.layers):
        for path, p in _layer_leaves(layer, "layers").items():
            yield path, p, divmod(i, model.cfg.period)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                master: bool = False) -> Transformer:
    """A model with the reference's initialisation drawn from ``seed``:
    norm scales and ``conv_bias`` zero, the SSM's ``A_log`` = log(1..N)
    over every channel, ``dt_bias`` -4.6 and ``D`` one, every other weight
    std * N(0, 1) truncated to [-3, 3] with std = fan_in^-0.5
    (``init_params`` in the reference; jax.random gives other numbers from
    the same seed).  Drawn on ``device`` (the card
    unless told otherwise) in float32, one leaf at a time, then cast (the
    serve form) or kept (``master=True``): both forms of one seed compute
    with the same bf16 weights."""
    model = Transformer(cfg, device, master)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, hd, f = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": H * hd, "w_gate": d,
              "w_up": d, "w_down": f, "embed": d, "lm_head": d,
              "w_in": d, "conv": cfg.conv_kernel, "w_x": cfg.d_inner,
              "w_dt": cfg.dt_rank, "w_out": cfg.d_inner}
    moe_fan_in = MoE.fan_in(cfg)

    def fill(p: torch.Tensor, name: str, moe: bool = False):
        if name == "A_log":
            p.copy_(torch.log(torch.arange(
                1, cfg.ssm_state + 1, dtype=torch.float32, device=dev)
            ).expand(p.shape))
        elif name == "dt_bias":
            p.fill_(-4.6)
        elif name == "D":
            p.fill_(1.0)
        elif p.dim() == 1:          # norm scales, conv_bias
            p.zero_()
        else:
            p.copy_(truncated_normal_init(
                gen, p.shape, (moe_fan_in if moe else fan_in)[name],
                dtype=p.dtype, device=dev))

    with torch.no_grad():
        fill(model.embed, "embed")
        for path, p, _ in _all_layer_leaves(model):
            fill(p, path.rsplit("/", 1)[-1], "/moe/" in path)
        fill(model.final_norm, "final_norm")
        if not cfg.tie_embeddings:
            fill(model.lm_head, "lm_head")
    return model


def _flatten(tree, prefix="") -> Dict[str, Any]:
    """Nested dicts and lists (the reference's ``dense_prefix``) -> leaves
    under '/'-joined paths, a list item under its index."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def params_from_jax(cfg: ModelConfig, tree, device=None,
                    master: bool = False) -> Transformer:
    """The port's model holding the reference's parameters (the serve
    form, or the float32 master form with ``master=True``).

    ``tree``: the reference's ``init_params`` tree as nested dicts of numpy
    arrays (stack leaves (G, P, ...), stack layer g * P + p is leaf [g, p];
    ``dense_prefix`` a list of per-layer dicts).  Raises ValueError for a missing or extra leaf or a wrong
    shape.  In the serve form, weights of two or more dimensions are cast to
    bf16 here, as the reference casts them per call."""
    want = _param_shapes(cfg)
    leaves = _flatten(tree)
    missing, extra = sorted(set(want) - set(leaves)), sorted(
        set(leaves) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"model: missing {missing}, extra {extra}")
    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in leaves.items()}
    for k, shape in want.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{cfg.name}: leaf {k} has shape "
                             f"{arrays[k].shape}, expected {shape}")
    model = Transformer(cfg, device, master)

    def put(p: torch.Tensor, a: np.ndarray):
        p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))   # a copy

    with torch.no_grad():
        put(model.embed, arrays["embed"])
        put(model.final_norm, arrays["final_norm"])
        if not cfg.tie_embeddings:
            put(model.lm_head, arrays["lm_head"])
        for path, param, index in _all_layer_leaves(model):
            put(param, arrays[path][index])
    return model


# ===========================================================================
# Forward
# ===========================================================================

def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin (S, hd/2) float32 for positions (S,)."""
    return rope(positions, cfg.head_dim, cfg.rope_theta)


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """Final hidden states (B, S, d) in COMPUTE_DTYPE; tokens (B, S) on the
    model's device.  ``remat`` as ``Transformer.forward``."""
    _check_cfg(cfg, params)
    return params(tokens, remat=remat)


def decay_mask(params: Transformer) -> Dict[str, bool]:
    """Which parameters take AdamW's decoupled weight decay, by name: the
    reference decays leaves of two or more dimensions, and its layer leaves
    are stacked (G, P, ...), so every layer parameter (the norm scales
    too) is decayed and only ``final_norm`` is not."""
    return {name: p.dim() >= 2 or name.startswith("layers.")
            for name, p in params.named_parameters()}


def _chunk_loss(h: torch.Tensor, labels: torch.Tensor,
                lm_head: torch.Tensor):
    """(sum of the masked next-token NLL, count of labels >= 0) of one
    sequence chunk; the (B, chunk, vocab) float32 logits live only here."""
    logits = (h @ lm_head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((lse - gold) * mask).sum(), mask.sum()


def loss_fn(cfg: ModelConfig, params: Transformer, batch: Dict[str, Any],
            loss_chunk: int = 2048) -> torch.Tensor:
    """Next-token cross entropy (a 0-d float32 tensor), computed in
    sequence chunks so the (S, V) logits never materialise whole: each
    chunk's logits are rematerialised in the backward, as the reference
    ``jax.checkpoint``s each; the forward rematerialises each layer group.
    batch: tokens (B, S), labels (B, S) with -1 = ignore.  Dense GQA, SSM
    and hybrid families; a MoE config raises (``check_trainable``)."""
    check_trainable(cfg)
    if batch.get("frontend_embeds") is not None:
        raise NotImplementedError(
            f"{cfg.name}: frontend embeddings (VLM / audio) are not ported "
            f"yet (ROADMAP.md Queue 1 item 10)")
    h = forward(cfg, params, batch["tokens"], remat=True)
    labels = batch["labels"]
    B, S, _ = h.shape
    n_chunks = max(1, S // loss_chunk)
    size = S // n_chunks
    if size * n_chunks != S:
        raise ValueError(f"sequence length {S} is not a multiple of its "
                         f"{n_chunks} loss chunks (loss_chunk={loss_chunk})")
    lm_head = params.head()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        part = slice(c * size, (c + 1) * size)
        nll, n = checkpoint(_chunk_loss, h[:, part], labels[:, part],
                            lm_head, use_reentrant=False,
                            preserve_rng_state=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _check_cfg(cfg: ModelConfig, params: Transformer) -> None:
    if params.cfg != cfg:
        raise ValueError(f"model was built for {params.cfg.name}, called "
                         f"with {cfg.name}")


# ===========================================================================
# Decode
# ===========================================================================

def _cache_len(cfg: ModelConfig, slot: int, seq_len: int) -> int:
    w = cfg.window_pattern[slot]
    return min(w, seq_len) if w > 0 else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=COMPUTE_DTYPE, device=None) -> Dict[str, Any]:
    """Empty decode cache: ``length`` 0 and, per slot p, ``kv`` with k/v
    (G, B, KVH, S_w, hd) (ring buffer of the slot's window) and ``pos``
    (G, S_w) int32 where the family has attention, and ``ssm`` with
    ``conv`` (G, B, K-1, d_inner) in ``dtype`` and ``state`` (G, B,
    d_inner, N) float32 where it has mamba layers; with a dense prefix,
    ``dense_prefix``, one {"kv": {k, v (B, KVH, S_w, hd), pos (S_w,)}} per
    prefix layer at slot 0's window — the reference's layout.  On the card
    unless told otherwise."""
    _require_ported(cfg)
    dev = resolve_device(device)
    G, KVH, hd = cfg.num_groups, cfg.num_kv_heads, cfg.head_dim
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
    slots: List[Dict[str, Any]] = []
    for slot in range(cfg.period):
        entry: Dict[str, Any] = {}
        if cfg.has_attention:
            Sw = _cache_len(cfg, slot, seq_len)
            entry["kv"] = {"k": zeros((G, batch, KVH, Sw, hd), dtype),
                           "v": zeros((G, batch, KVH, Sw, hd), dtype),
                           "pos": zeros((G, Sw), torch.int32)}
        if cfg.has_ssm:
            entry["ssm"] = {
                "conv": zeros((G, batch, cfg.conv_kernel - 1, cfg.d_inner),
                              dtype),
                "state": zeros((G, batch, cfg.d_inner, cfg.ssm_state),
                               torch.float32)}
        slots.append(entry)
    cache = {"length": 0, "slots": slots}
    if cfg.first_dense_layers:
        Sw = _cache_len(cfg, 0, seq_len)
        cache["dense_prefix"] = [
            {"kv": {"k": zeros((batch, KVH, Sw, hd), dtype),
                    "v": zeros((batch, KVH, Sw, hd), dtype),
                    "pos": zeros((Sw,), torch.int32)}}
            for _ in range(cfg.first_dense_layers)]
    return cache


def _rope_scalar(cfg: ModelConfig, pos: int, device):
    """cos/sin (1, hd/2) for one position.  Filled on the device: a tensor
    made from the Python int would be a blocking host-to-device copy in
    every layer of every decode step."""
    positions = torch.full((1,), pos, dtype=torch.float32, device=device)
    return rope(positions, cfg.head_dim, cfg.rope_theta)


def _decode_gqa(cfg: ModelConfig, h, pa, kv, window: int, q_pos: int):
    """One-token GQA against a ring-buffer cache slice.
    kv: {k (B, KVH, Sw, hd), v, pos (Sw,)}, written in place; returns the
    attention output (B, 1, d)."""
    B = h.shape[0]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Sw = kv["k"].shape[2]
    q = (h @ pa["wq"]).reshape(B, 1, H, hd)
    k = (h @ pa["wk"]).reshape(B, 1, KVH, hd)
    v = (h @ pa["wv"]).reshape(B, 1, KVH, hd)
    cos, sin = _rope_scalar(cfg, q_pos, h.device)
    q = attn_lib.apply_rope_bshd(q, cos, sin)
    k = attn_lib.apply_rope_bshd(k, cos, sin)
    slot_idx = q_pos % Sw
    kv["k"][:, :, slot_idx, :] = k[:, 0].to(kv["k"].dtype)
    kv["v"][:, :, slot_idx, :] = v[:, 0].to(kv["v"].dtype)
    kv["pos"][slot_idx] = q_pos
    nk, nv, npos = kv["k"], kv["v"], kv["pos"]
    qg = (q[:, 0] * hd ** -0.5).reshape(B, KVH, H // KVH, hd).to(
        torch.float32)
    s = torch.einsum("bkgh,bksh->bkgs", qg, nk.to(torch.float32))
    # Ring-buffer validity: a slot's most recent write is always within the
    # last Sw positions, so (npos > q_pos - Sw) enforces the window exactly
    # when Sw == window; (arange <= q_pos) masks not-yet-filled slots before
    # the first wrap (their pos defaults to 0).
    valid = ((npos <= q_pos) & (npos > q_pos - Sw)
             & (torch.arange(Sw, device=h.device) <= q_pos))
    s = s.masked_fill(~valid, attn_lib.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, nv.to(torch.float32))
    o = o.reshape(B, 1, H * hd).to(h.dtype)
    return o @ pa["wo"]


def _layer_cache(cache: Dict[str, Any], i: int, P: int) -> Dict[str, Any]:
    """Layer i's views of its slot of the cache (group i // P, slot
    i % P): {k, v, pos} under "kv", {conv, state} under "ssm"."""
    g, p = divmod(i, P)
    return {name: {k: t[g] for k, t in part.items()}
            for name, part in cache["slots"][p].items()}


def _decode_layers(params: Transformer, cache: Dict[str, Any]):
    """(layer, its cache entry) in order: the dense prefix, then the
    stack."""
    for layer, entry in zip(params.dense_prefix,
                            cache.get("dense_prefix", [])):
        yield layer, entry
    for i, layer in enumerate(params.layers):
        yield layer, _layer_cache(cache, i, params.cfg.period)


# a MoE layer's gap: this quantile over positions (the reference's MoE
# rule, tests/test_models.py:92-96: a router near-tie can flip one token's
# expert between the batched and the single-token path)
MOE_GAP_QUANTILE = 0.9


@torch.no_grad()
def decode_gap_by_layer(cfg: ModelConfig, params: Transformer,
                        tokens: torch.Tensor
                        ) -> Tuple[List[float], List[float]]:
    """How far each layer's decode path lies from its prefill path on the
    same input.  The forward's input to layer i (teacher forcing) goes
    through ``Layer.forward`` (on the card the prefill kernels) and, token
    by token from an empty cache, through ``Layer.decode``; per layer and
    position, max |decode delta - forward delta| / max |forward delta|
    over the whole input, delta = the layer's output minus its input.  A
    layer's gap is the largest over positions, or in a MoE config's stack
    their ``MOE_GAP_QUANTILE`` quantile.  Rounding apart the two compute
    the same function; unlike the end-to-end logits, the gap does not
    compound through depth.  tokens (B, S).  Returns (gaps, maxes), one
    per layer (the dense prefix first): the gaps, and the largest over
    positions of each."""
    _check_cfg(cfg, params)
    x = params.embed_tokens(tokens)
    B, S = tokens.shape
    rope_cs = (_rope_tables(cfg, torch.arange(S, device=x.device))
               if cfg.has_attention else None)
    cache = init_cache(cfg, B, S, device=x.device)
    gaps, maxes = [], []
    for layer, entry in _decode_layers(params, cache):
        fwd = layer(x, rope_cs)
        dec = torch.cat([layer.decode(x[:, s:s + 1], entry, s)
                         for s in range(S)], dim=1)
        df, dd = (fwd - x).float(), (dec - x).float()
        per_pos = ((df - dd).abs().amax(dim=(0, 2))
                   / df.abs().max().clamp_min(1e-30)).cpu()
        maxes.append(float(per_pos.max()))
        gaps.append(float(torch.quantile(per_pos, MOE_GAP_QUANTILE))
                    if layer.moe is not None else maxes[-1])
        x = fwd
    return gaps, maxes


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: Dict[str, Any]):
    """One decode step.  tokens: (B, 1) int.  Returns (logits (B,
    vocab_padded) float32, cache); the cache is written in place and
    ``cache['length']`` (the 0-based position of this token before the
    call) advances by one."""
    _check_cfg(cfg, params)
    q_pos = int(cache["length"])
    x = params.embed_tokens(tokens)
    for layer, entry in _decode_layers(params, cache):
        x = layer.decode(x, entry, q_pos)
    cache["length"] = q_pos + 1
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x[:, 0] @ params.head()).to(torch.float32)
    return logits, cache
