#!/usr/bin/env python3
"""The selective-scan kernel of two or more checkouts, timed on one card.

  python3 scripts/scan_ab.py PARENT_ROOT CHANGE_ROOT [LEVER_ROOT ...]

Each checkout (a directory holding ``src/repro_torch``) runs in a process
of its own, in the order given and then back (parent, change, change,
parent for two), builds its kernels from its own sources and times its
``selective_scan_cuda`` on the same seeded inputs
(``chip_smoke.scan_inputs``) at ``chip_smoke.SCAN_TIMED``: falcon-mamba-7b's
layer (1, 4096, 8192, 16) and hymba-1.5b's B=8 (8, 2048, 3200, 16) and
B=1 (1, 4096, 3200, 16) layers.  For each shape: the CUDA-event median
per launch (a stream of 20, as ``chip_smoke.py`` phase 7f), the kernel's
device time (``torch.profiler``), the bound and its terms
(``chip_smoke.scan_bound``), the layout the checkout takes (its
``scan_layout``: lanes a channel, tile, warps a scheduler; a checkout
without one runs a thread per (batch, channel)) and a hash of the output.
Each run also times the chunk probe: hymba-1.5b's B=1 layer cut into K =
2 and 4 rows of S / K steps, the work of a K-chunk scan's second pass in
K times the lanes.  Prints one JSON line per run, the card's name and
power limit, and writes them all to ``chiprun_out/scan_ab.json``.  Needs
one CUDA card; imports nothing of JAX.
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNKS = (2, 4)


def time_tree(tree):
    """{shape name: {ms, kernel_device_ms, bound_ms, ...}} for the checkout
    at ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.kernels import selective_scan as ss
    dev = torch.device("cuda")
    layout_of = getattr(ss, "scan_layout", None)

    def measure(shape, seed):
        ins = cs.scan_inputs(*shape, dev, seed=seed)
        run = lambda: ss.selective_scan_cuda(*ins)
        y = run()
        torch.cuda.synchronize()
        bms, by, terms = cs.scan_bound(*shape)
        rec = dict(shape=list(shape), ms=cs.per_launch_ms(run, 20),
                   kernel_device_ms=cs.kernel_device_ms(
                       run, 10, "selective_scan_kernel"),
                   bound_ms=bms, bound_by=by, bound_terms_ms=terms,
                   layout=layout_of(*shape) if layout_of else None,
                   y_sha1=hashlib.sha1(y.view(torch.int16).cpu().numpy()
                                       .tobytes()).hexdigest())
        del ins, y
        torch.cuda.empty_cache()
        return rec

    shapes = {name: measure(shape, 300 + k)
              for k, (name, shape) in enumerate(cs.SCAN_TIMED.items())}
    bsz, S, di, N = cs.SCAN_TIMED["hymba-1.5b B=1"]
    probe = {f"K={K}": measure((bsz * K, S // K, di, N), 400 + K)
             for K in CHUNKS}
    return dict(tree=str(tree), module=ss.__file__, shapes=shapes,
                chunk_probe=probe)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+",
                    help="the parent's checkout, the change's, and any "
                         "lever trees")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.trees[0])))
        return 0
    if len(args.trees) < 2:
        ap.error("give the parent's and the change's checkout")
    import torch
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for tree in args.trees + args.trees[::-1]:
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
    (ROOT / "chiprun_out" / "scan_ab.json").write_text(
        json.dumps(dict(card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
