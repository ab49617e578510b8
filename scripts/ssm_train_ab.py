#!/usr/bin/env python3
"""One training configuration's step, timed and traced, in two or more
checkouts on one card, in turns.

  python3 scripts/ssm_train_ab.py [--arch hymba-1.5b] [--layers L]
      [--batch 8] [--seq 2048] TREE [TREE ...]

Each checkout (a directory holding ``chip_smoke.py`` and
``src/repro_torch``) runs in a process of its own, in the order given and
then back, and times its own ``chip_smoke.train_step_times`` on the
configuration (full width, weights from ``chip_smoke.TRAIN_SEED``, depth
cut to ``--layers`` when given): the median step (CUDA events, a warm-up
step first), the device busy time and wall of one more step traced by
``torch.profiler``, and the traced step's idle share.  A fresh process per
run keeps the allocator and the profiler of earlier phases out of the
traced step.  Prints one JSON line per run and the card's name and power
limit, and writes them to ``chiprun_out/ssm_train_ab.json``.  Needs one
CUDA card; imports nothing of JAX.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("step_ms", "step_ms_all", "busy_ms", "traced_wall_ms", "idle",
        "scan_bwd_device_ms", "scan_fwd_device_ms", "peak_memory_gb")

RUN = """
import dataclasses, json, sys
sys.path.insert(0, {tree!r}); sys.path.insert(0, {tree!r} + "/src")
import torch
import chip_smoke as cs
from repro_torch.configs.registry import get_arch
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_arch({arch!r})
if {layers!r} is not None:
    cfg = dataclasses.replace(cfg, num_layers={layers!r})
rec = cs.train_step_times(cfg, torch.device("cuda"), {batch!r}, {seq!r})
print(json.dumps({{k: rec.get(k) for k in {keys!r}}}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="the checkouts to time")
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    runs = []
    trees = [str(Path(t).resolve()) for t in args.trees]
    for tree in trees + trees[::-1]:
        code = RUN.format(tree=tree, arch=args.arch, layers=args.layers,
                          batch=args.batch, seq=args.seq, keys=KEYS)
        res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(dict(tree=tree, **json.loads(
            res.stdout.strip().splitlines()[-1])))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "ssm_train_ab.json").write_text(json.dumps(
        dict(arch=args.arch, layers=args.layers, batch=args.batch,
             seq=args.seq, card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
