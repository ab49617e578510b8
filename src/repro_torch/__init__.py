"""PyTorch port of the minibatch Gibbs sampling system (``repro``), for one
NVIDIA GPU.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``diagnostics``, ``kernels``, ``configs``, ``models``,
``launch``, ``obs``, ``runtime``) and never imports it.  Entry points run
on the card unless the caller passes ``device="cpu"``, where the kernels'
plain PyTorch versions run instead.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
