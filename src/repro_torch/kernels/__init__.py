"""Kernels of the port: hand-written CUDA for the card (``csrc/``: the fused
sweeps, the bucket-energy sum, flash attention, the telemetry update and
the selective scan), plain PyTorch versions
for the CPU (``ref.py``), dispatched by device (``ops.py``)."""
