"""Training launcher: a real loop with checkpoint/restart, auto-resume, a
straggler watchdog and deterministic data addressing -- the counterpart of
``repro/launch/train.py`` on one device (the card unless ``device`` or
``--device`` names another).

Example (CPU, reduced config; ``examples/torch_train_lm.py`` drives this
entry point; ``--arch`` takes any ported family, falcon-mamba-7b and
hymba-1.5b among them):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 50 --global-batch 8 --seq 256 --ckpt-dir /tmp/ck \\
      --device cpu
Auto-resume: rerunning the same command continues from the latest
checkpoint, and ends with the same bits as a run that never stopped (the
batches are a pure function of the step; the model, AdamW state and every
kernel are deterministic).

The parameters are the float32 master form (``init_params(...,
master=True)``), saved under ``ckpt_dir`` by name, the AdamW state under
``ckpt_dir/opt``, both through ``checkpoint/checkpoint.py``.  The
reference's mesh and parameter shardings (``make_mesh_for_host``,
``param_pspecs``) wait for ``shardings.py`` (ROADMAP.md Queue 1 item 10):
one device here.
"""
from __future__ import annotations

import argparse

import torch

from .._device import resolve_device
from ..checkpoint import checkpoint as ckpt
from ..configs.registry import get_arch
from ..data.pipeline import SyntheticTokens
from ..models import transformer as T
from ..optim.adamw import adamw_init
from ..runtime.fault import Heartbeat, StepWatchdog
from . import steps as steps_lib

__all__ = ["train", "main"]


def _restore(ckpt_dir: str, step: int, model: T.Transformer):
    """The model's parameters (in place) and the AdamW state of ``step``."""
    named = dict(model.named_parameters())
    saved = ckpt.restore(ckpt_dir, step, named)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(saved[name])
    return ckpt.restore(ckpt_dir + "/opt", step, adamw_init(named))


def train(cfg, *, steps: int, global_batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int = 50, lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, fail_at_step: int = -1, device=None):
    """Returns (final loss, metrics history).  ``fail_at_step`` injects a
    crash once (fault-tolerance test hook) -- resume must be seamless."""
    dev = resolve_device(device)
    data = SyntheticTokens(cfg.vocab_size, seq, global_batch, seed=seed)
    train_step = steps_lib.make_train_step(cfg, base_lr=lr,
                                           total_steps=max(steps, 100),
                                           loss_chunk=min(2048, seq))
    model = T.init_params(cfg, seed, device=dev, master=True)
    start = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if start is not None:
        opt = _restore(ckpt_dir, start, model)
        step0 = start
        print(f"[train] resumed from step {start}")
    else:
        opt = adamw_init(model)
        step0 = 0

    wd = StepWatchdog()
    hb = Heartbeat(ckpt_dir + "/heartbeat.json", 5.0) if ckpt_dir else None
    history = []
    crashed = False
    for step in range(step0, steps):
        if step == fail_at_step and not crashed:
            raise RuntimeError("injected failure (fault-tolerance test)")
        batch = data.batch(step)
        with wd:
            model, opt, metrics = train_step(model, opt, batch)
        if (step + 1) % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step + 1, **m})
            print(f"[train] step {step+1:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}",
                  flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, dict(model.named_parameters()))
            ckpt.save(ckpt_dir + "/opt", step + 1, opt)
        if hb:
            hb.beat(step)
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, dict(model.named_parameters()))
        ckpt.save(ckpt_dir + "/opt", steps, opt)
    print(f"[train] done; watchdog: {wd.stats()}")
    return history[-1]["loss"] if history else None, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch, smoke=args.smoke)
    train(cfg, steps=args.steps, global_batch=args.global_batch,
          seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
