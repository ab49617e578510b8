#!/usr/bin/env python3
"""The bucket-energy kernel of two checkouts, timed on one card.

  python3 scripts/bucket_ab.py PARENT_ROOT CHANGE_ROOT

Each checkout (a directory holding ``src/repro_torch``) runs in a process
of its own, in the order parent, change, change, parent, builds its
kernels from its own sources and times its ``bucket_energy_cuda`` at
``SHAPES`` (C=256, D=10, K = 8, 32, 128: the single-site steps' minibatch
shapes), ``ROUNDS`` times each, on the inputs of ``chip_smoke.py``
phase 6 and with its timers: the kernel's device time alone
(``torch.profiler``, 100 launches) and the per-launch time of a stream of
100 launches taken in turns with ``zeros.scatter_add_``.  It records the
device kernels each launch ran (which layout).  The first process also
times the host's lookups of the current device and stream, public and
private forms, per call over 200,000 calls.  Prints one JSON line per
run, the card's name and power limit, and writes them all to
``chiprun_out/bucket_ab.json``.  Needs one CUDA card; imports nothing of
JAX.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((256, 8, 10), (256, 32, 10), (256, 128, 10))
ROUNDS = 3


def lookup_us():
    """Host microseconds per call of each device and stream lookup."""
    import torch
    forms = {
        "torch.cuda.current_stream(0).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
    }
    n, out = 200_000, {}
    for name, fn in forms.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def time_tree(tree):
    """Readings of the checkout at ``tree``'s bucket-energy kernel."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.kernels import minibatch_energy as me
    dev = torch.device("cuda")
    out = {}
    for k, (C, K, D) in enumerate(SHAPES):
        w, v = cs.bucket_inputs(C, K, D, "normal", dev, seed=200 + k)
        v64 = v.long()
        kernel = lambda: me.bucket_energy_cuda(w, v, D)
        library = lambda: torch.zeros((C, D), device=dev).scatter_add_(
            1, v64, w)
        kernel()
        dev_events, _ = cs.device_events(kernel)
        names = sorted({e.key for e in dev_events})
        rounds = []
        for _ in range(ROUNDS):
            ms, lms, _ = cs.alternating_per_launch_ms(kernel, library, 100)
            rounds.append(dict(
                device_ms=cs.kernel_device_ms(kernel, 100, "bucket_energy"),
                ms=ms, library_ms=lms))
        out[f"C={C} K={K} D={D}"] = dict(device_kernels=names, rounds=rounds)
    return dict(tree=str(tree), module=me.__file__, shapes=out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--lookups", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        rec = time_tree(args.parent)
        if args.lookups:
            rec["lookup_us"] = lookup_us()
        print(json.dumps(rec))
        return 0
    if args.change is None:
        ap.error("give the parent's and the change's checkout")
    import torch
    if not torch.cuda.is_available():
        print("bucket_ab: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for k, tree in enumerate((args.parent, args.change, args.change,
                              args.parent)):
        cmd = [sys.executable, __file__, "--one", tree]
        res = subprocess.run(cmd + ["--lookups"] * (k == 0),
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
    (ROOT / "chiprun_out" / "bucket_ab.json").write_text(
        json.dumps(dict(card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
