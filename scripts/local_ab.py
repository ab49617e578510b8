#!/usr/bin/env python3
"""The local-gibbs sweep kernel of two or more checkouts, timed on one card.

  python3 scripts/local_ab.py [--once] TREE [TREE ...]

Each checkout (a directory holding ``src/repro_torch``) runs in a process
of its own, in the order given and then back (parent, change, change,
parent; with ``--once``, in the order given only), builds its kernels from
its own sources and times its ``local_gibbs_sweep_cuda`` on the inputs of
``chip_smoke.py`` phase 6 (``chip_smoke.local_inputs``: potts-64x64, C=256,
S=64, D=10, seeds 16 and 17) at B = 8, 32 and 128: the per-launch time of a
stream of 20 launches (CUDA events, median of 5), the device time alone
(``torch.profiler``, 20 launches), the byte bound
(``chip_smoke.local_bound``), the recompute share (the sub-steps the
consumer recomputed over C*S, mean of five launches, where the checkout's
wrapper takes ``recomputed=``), the launch's plan (where it has
``local_sweep_plan``) and a hash of the states (equal hashes: the same
bits).  A lever tree is a copy of a checkout with one constant changed
(for example a ``sed`` of ``kDepth`` in ``csrc/local_sweep.cu``).  Prints
one JSON line per run, the card's name and power limit, and writes them
all to ``chiprun_out/local_ab.json``.  Needs one CUDA card; imports
nothing of JAX.
"""
import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOCAL_B = (8, 32, 128)


def time_tree(tree):
    """{B: {ms, device_ms, bound_ms, recomputed_share, ...}} for the
    checkout at ``tree``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs        # puts ROOT/src on sys.path first ...
    import torch
    sys.path.insert(0, str(Path(tree).resolve() / "src"))   # ... then tree
    from repro_torch.core import engine
    from repro_torch.kernels import local_sweep as ls
    dev = torch.device("cuda")
    counts = "recomputed" in inspect.signature(
        ls.local_gibbs_sweep_cuda).parameters
    potts = engine.make_workload("potts-64x64", device=dev).graph
    out = {}
    for B in LOCAL_B:
        (x, i), kw = cs.local_inputs(potts, B, seed=16)
        sd = cs._seed(17, dev)
        kernel = lambda: ls.local_gibbs_sweep_cuda(x, potts.W, i, sd, **kw)
        states = kernel()
        torch.cuda.synchronize()
        rec = dict(ms=cs.per_launch_ms(kernel, 20),
                   device_ms=cs.kernel_device_ms(kernel, 20,
                                                 "local_gibbs_sweep"),
                   states_sha1=hashlib.sha1(
                       states.cpu().numpy().tobytes()).hexdigest())
        rec["bound_ms"], rec["bound_by"] = cs.bound(
            *cs.local_bound(x, i, B, kw["D"], sd))
        if counts:
            shares = []
            for _ in range(5):
                n_re = torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
                ls.local_gibbs_sweep_cuda(x, potts.W, i, sd, recomputed=n_re,
                                          **kw)
                shares.append(float(n_re.sum()) / i.numel())
            rec["recomputed_share"] = shares
        if hasattr(ls, "local_sweep_plan"):
            rec["plan"] = ls.local_sweep_plan(potts.n, i.shape[1], B,
                                              kw["D"])
        out[f"B={B}"] = rec
    return dict(tree=str(tree), module=ls.__file__, shapes=out)


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
        print("local_ab: no CUDA device", file=sys.stderr)
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
    (ROOT / "chiprun_out" / "local_ab.json").write_text(
        json.dumps(dict(card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
