"""Kernels of the port: hand-written CUDA for the card (``csrc/``: the fused
sweeps, the bucket-energy sum and flash attention), plain PyTorch versions
for the CPU (``ref.py``), dispatched by device (``ops.py``)."""
