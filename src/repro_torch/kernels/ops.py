"""Public sweep operations, dispatched by the tensors' device.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel (``fused_sweep.py``), which launches or
raises.  Nothing falls back from one to the other.
"""
from __future__ import annotations

from .fused_sweep import gibbs_sweep_cuda, mgpmh_sweep_cuda
from .ref import gibbs_sweep_ref, mgpmh_sweep_ref

__all__ = ["gibbs_sweep", "mgpmh_sweep"]


def _route(x, op: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on 'cpu' or 'cuda' tensors, got "
                         f"{x.device}")
    return x.device.type


def mgpmh_sweep(x, W, row_prob, row_alias, i_sites, B, u_idx, u_alias,
                gumbel, logu, *, D: int, scale: float):
    """S fused sequential MGPMH site updates per chain (see
    ``ref.mgpmh_sweep_ref`` for exact semantics).

    x (C, n) i32; W/row_prob/row_alias (n, n); i_sites/B/logu (C, S);
    u_idx/u_alias (C, S, K) f32 uniforms; gumbel (C, S, D) f32.
    ``scale`` = L/lambda.  Returns (x_out (C, n) i32, accepts (C,) i32).
    """
    args = (x, W, row_prob, row_alias, i_sites, B, u_idx, u_alias, gumbel,
            logu)
    if _route(x, "mgpmh_sweep") == "cpu":
        return mgpmh_sweep_ref(*args, D, scale)
    return mgpmh_sweep_cuda(*args, D=D, scale=scale)


def gibbs_sweep(x, W, i_sites, gumbel, *, D: int):
    """S fused sequential vanilla-Gibbs site updates per chain (exact
    conditionals; see ``ref.gibbs_sweep_ref``).

    x (C, n) i32; W (n, n); i_sites (C, S); gumbel (C, S, D).
    Returns x_out (C, n) i32.
    """
    if _route(x, "gibbs_sweep") == "cpu":
        return gibbs_sweep_ref(x, W, i_sites, gumbel, D)
    return gibbs_sweep_cuda(x, W, i_sites, gumbel, D=D)
