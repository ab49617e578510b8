"""End-to-end example on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps with the full stack -- deterministic data pipeline,
AdamW, checkpoint/auto-resume, straggler watchdog, and on the card the
flash-attention forward and backward kernels (the counterpart of
``examples/train_lm.py``).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--ckpt-dir DIR] [--device cpu]

Checkpoints are written, and a rerun resumes from them, only where
``--ckpt-dir`` names a directory.
"""
import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import train
from repro_torch.models.transformer import param_count

# ~100M params: a 12-layer llama-style decoder
CONFIG = ModelConfig(
    name="demo-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
    d_ff=2048, vocab_size=32000, rope_theta=1e4,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint and resume here (default: none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(f"params: {param_count(CONFIG)/1e6:.1f}M")
    loss, hist = train(CONFIG, steps=args.steps,
                       global_batch=args.global_batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, ckpt_every=100,
                       lr=3e-4, log_every=20, device=args.device)
    if loss is not None:         # None: resumed at --steps, nothing to run
        print(f"final loss: {loss:.4f}")
    return loss, hist


if __name__ == "__main__":
    main()
