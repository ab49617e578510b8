"""Fused sweep kernels: hand-written CUDA for the card (``csrc/``), plain
PyTorch versions for the CPU (``ref.py``), dispatched by device
(``ops.py``)."""
