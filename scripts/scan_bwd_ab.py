#!/usr/bin/env python3
"""The selective scan's backward kernel of two or more checkouts, timed on
one card, alone and as the training path calls it: after the forward.

  python3 scripts/scan_bwd_ab.py [--once] TREE [TREE ...]

Each checkout (a directory holding ``src/repro_torch``) runs in a process
of its own, in the order given and then back (with ``--once``, in the
order given only), builds its kernels from its own sources and times its
kernels on the same seeded inputs (``chip_smoke.scan_inputs`` and a bf16
N(0, 1) output gradient) at ``chip_smoke.SCAN_TIMED``: falcon-mamba-7b's
layer (1, 4096, 8192, 16) and hymba-1.5b's B=8 (8, 2048, 3200, 16) and B=1
(1, 4096, 3200, 16) layers.  For each shape: the CUDA-event median per
call (a stream of 5) of the backward alone (three launches; a checkout
whose backward takes the forward's checkpoints is given them), of the
pair of one layer's training calls (the forward, with checkpoints where
the checkout's backward takes them, then the backward) and of the serve
path's forward; the device time of each kernel of the pair
(``torch.profiler``); the bound and its terms
(``chip_smoke.scan_bwd_bound``), the layout the checkout takes
(``scan_bwd_layout``) and a hash of the seven gradients (equal hashes: the
same bits).  A lever tree is a copy of a checkout with one constant or
line changed (for example a ``sed`` of ``kBwdTargetLanes``).  Prints one
JSON line per run, the card's name and power limit, and writes them all
to ``chiprun_out/scan_bwd_ab.json``.  Needs one CUDA card; imports nothing
of JAX.
"""
import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_tree(tree):
    """{shape name: {ms, pair_ms, pair_device_ms, bound_ms, ...}} for the
    checkout at ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.kernels import selective_scan as ss
    dev = torch.device("cuda")

    # a backward that takes the forward's checkpoints, or one that writes
    # its own
    takes_ckpt = "ckpt" in inspect.signature(
        ss.selective_scan_bwd_cuda).parameters

    def measure(shape, seed):
        ins = cs.scan_inputs(*shape, dev, seed=seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        dy = torch.randn(shape[:3], generator=gen, device=dev).to(
            torch.bfloat16)
        if takes_ckpt:
            ck = ss.selective_scan_cuda(*ins, checkpoints=True)[1]
            bwd = lambda: ss.selective_scan_bwd_cuda(*ins, dy, ck)
            pair = lambda: ss.selective_scan_bwd_cuda(
                *ins, dy, ss.selective_scan_cuda(*ins, checkpoints=True)[1])
        else:
            bwd = lambda: ss.selective_scan_bwd_cuda(*ins, dy)
            pair = lambda: (ss.selective_scan_cuda(*ins), bwd())
        fwd = lambda: ss.selective_scan_cuda(*ins)
        grads = bwd()
        torch.cuda.synchronize()
        digest = hashlib.sha1()
        for g in grads:
            digest.update(g.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        dev_ev, _ = cs.device_events(lambda: [pair() for _ in range(3)])
        parts = cs.scan_device_ms(dev_ev)
        bms, by, terms = cs.scan_bwd_bound(*shape)
        rec = dict(shape=list(shape), ms=cs.per_launch_ms(bwd, 5),
                   pair_ms=cs.per_launch_ms(pair, 5),
                   forward_ms=cs.per_launch_ms(fwd, 10),
                   pair_device_ms=parts, bound_ms=bms, bound_by=by,
                   bound_terms_ms=terms, layout=ss.scan_bwd_layout(*shape),
                   kernel_layout=ss.kernel_bwd_layout(*shape),
                   takes_checkpoints=takes_ckpt,
                   grads_sha1=digest.hexdigest())
        del ins, dy, grads
        torch.cuda.empty_cache()
        return rec

    shapes = {name: measure(shape, 700 + 2 * k)
              for k, (name, shape) in enumerate(cs.SCAN_TIMED.items())}
    return dict(tree=str(tree), module=ss.__file__, shapes=shapes)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="the checkouts to time")
    ap.add_argument("--once", action="store_true",
                    help="each tree once, in the order given")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.trees[0])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    order = args.trees if args.once else args.trees + args.trees[::-1]
    for tree in order:
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
    (ROOT / "chiprun_out" / "scan_bwd_ab.json").write_text(
        json.dumps(dict(card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
