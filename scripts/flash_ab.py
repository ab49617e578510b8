#!/usr/bin/env python3
"""The flash-attention kernel of two checkouts, timed on one card.

  python3 scripts/flash_ab.py PARENT_ROOT CHANGE_ROOT

Each checkout (a directory holding ``src/repro_torch``) runs in a process
of its own, in the order parent, change, change, parent, builds its
kernels from its own sources and times its ``flash_attention_cuda`` at
``chip_smoke.FLASH_CONFIGS`` (bf16, the prefill attention of every dense
config), on the same seeded inputs and with the same CUDA-event median as
``chip_smoke.py`` phase 6.  A shape whose head dim a checkout's wrapper
refuses is recorded as null.  Prints one JSON line
per run, the card's name and power limit, and writes them all to
``chiprun_out/flash_ab.json``.  Needs one CUDA card; imports nothing of JAX.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_tree(tree):
    """{config: ms or None} for the checkout at ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    out = {}
    for name, (B, Sq, Sk, H, KVH, hd, w, causal) in cs.FLASH_CONFIGS.items():
        q, k, v = cs.flash_inputs(B, Sq, Sk, H, KVH, hd, torch.bfloat16, dev,
                                  seed=50)
        try:
            fa.flash_attention_cuda(q, k, v, window=w, causal=causal)
        except ValueError:       # a head dim this checkout was not built for
            out[name] = None
            continue
        out[name] = cs.per_launch_ms(
            lambda: fa.flash_attention_cuda(q, k, v, window=w,
                                             causal=causal), 20)
        del q, k, v
    return dict(tree=str(tree), module=fa.__file__, ms=out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.parent)))
        return 0
    if args.change is None:
        ap.error("give the parent's and the change's checkout")
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for tree in (args.parent, args.change, args.change, args.parent):
        res = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_ab.json").write_text(
        json.dumps(dict(card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
