"""Kernels of the port: hand-written CUDA for the card (``csrc/``: the fused
sweeps and the bucket-energy sum), plain PyTorch versions for the CPU
(``ref.py``), dispatched by device (``ops.py``)."""
