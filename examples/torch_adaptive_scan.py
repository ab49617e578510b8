"""Convergence telemetry + adaptive scan on the PyTorch port (the
counterpart of ``examples/adaptive_scan.py``).

A heterogeneous pair-Ising model (registered workload ``hetero-pairs-24``):
every exact marginal is uniform, but strongly coupled pairs mix orders of
magnitude more slowly than weak ones.  A uniform random scan spends most
updates on sites that are already decorrelated; the AdaptiveScan schedule
reads the streaming telemetry (per-site flip rates) and reallocates updates
toward the sticky sites -- same stationary distribution, far fewer updates
to a given worst-site TV error.

  PYTHONPATH=src python examples/torch_adaptive_scan.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import diagnostics as diag
from repro_torch import resolve_device
from repro_torch.core import AdaptiveScan, engine, run_marginal_experiment

S, C, TARGET = 16, 16, 0.12


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--snapshots", type=int, default=120,
                    help="snapshots of 8 sweep calls per run")
    ap.add_argument("--pilot-calls", type=int, default=16,
                    help="sweep calls per lambda auto-tuner round")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    wl = engine.make_workload("hetero-pairs-24", device=dev)
    g = wl.graph
    ref = np.full((g.n, g.D), 0.5)    # exact marginals (relabeling symmetry)
    n_iters, n_snapshots = 8 * S * args.snapshots, args.snapshots

    def updates_to_target(eng):
        trace = run_marginal_experiment(
            eng, eng.init(0, C), n_iters=n_iters, n_snapshots=n_snapshots,
            ref_marginals=ref, site_reduce="max", telemetry=True)
        err = trace.error.cpu().numpy()
        iters = trace.iters.cpu().numpy()
        first = (int(iters[np.argmax(err < TARGET)]) if (err < TARGET).any()
                 else None)
        return first, diag.summarize(trace.telemetry, eng.exact_accept)

    uniform = engine.make("gibbs", g, sweep=S, device=dev)
    adaptive = engine.make(
        "gibbs", g, device=dev,
        schedule=AdaptiveScan(sweep_len=S, refresh_every=4, uniform_mix=0.15))

    fu, su = updates_to_target(uniform)
    fa, sa = updates_to_target(adaptive)
    print(f"worst-site TV < {TARGET}:")
    print(f"  uniform scan : {fu} site updates  "
          f"(max split-Rhat {su['max_split_rhat']:.3f})")
    print(f"  adaptive scan: {fa} site updates  "
          f"(max split-Rhat {sa['max_split_rhat']:.3f})")
    if fu and fa:
        print(f"  update ratio : {fa / fu:.2f}  (tier-1 asserts <= 0.7)")
    else:
        print(f"  target not reached within {n_iters} updates -- raise "
              f"--snapshots")

    # The same telemetry drives the minibatch auto-tuner: pick lambda so
    # MGPMH acceptance lands in a band instead of hand-tuning the paper
    # recipe.
    eng, hist = diag.autotune_lambda(
        "mgpmh", engine.make_workload("potts-20x20", device=dev).graph,
        target=(0.90, 0.96), lam0=4.0, pilot_calls=args.pilot_calls,
        device=dev)
    print("lambda auto-tuner:",
          " -> ".join(f"lam={h['lam']:.0f}@{h['acceptance']:.2f}"
                      for h in hist))
    return dict(uniform=fu, adaptive=fa, autotune=hist)


if __name__ == "__main__":
    main()
