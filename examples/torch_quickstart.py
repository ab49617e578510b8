"""Quickstart on the PyTorch port: minibatch Gibbs sampling on a Potts
model in ~20 lines (the counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import engine, make_potts_graph, run_marginal_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--iters", type=int, default=20_000,
                    help="site updates per run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # A fully-connected Potts model with Gaussian-kernel interactions
    # (the paper's validation family, scaled to run in seconds).
    graph = make_potts_graph(grid=8, beta=2.0, D=6, device=dev)
    print(f"n={graph.n}  D={graph.D}  Delta={graph.delta}  "
          f"L={graph.L:.2f}  Psi={graph.psi:.1f}")

    # MGPMH (Algorithm 4): minibatch proposal + exact accept.  engine.make
    # defaults to the paper recipe lam = 4 L^2 (spectral gap within
    # exp(-1/4) of vanilla Gibbs, Theorem 4) and a tail-safe draw capacity;
    # sweep=16 fuses 16 site updates per call (one kernel launch on the
    # card, the plain version on the CPU).
    mgpmh = engine.make("mgpmh", graph, sweep=16, device=dev)
    chains = mgpmh.init(0, n_chains=8)
    trace = run_marginal_experiment(mgpmh, chains, n_iters=args.iters,
                                    n_snapshots=5)
    print("MGPMH    marginal error:",
          np.round(trace.error.cpu().numpy(), 4))

    gibbs = engine.make("gibbs", graph, sweep=16, device=dev)
    ref = run_marginal_experiment(gibbs, gibbs.init(0, 8),
                                  n_iters=args.iters, n_snapshots=5)
    print("Gibbs    marginal error:", np.round(ref.error.cpu().numpy(), 4))
    lam = mgpmh.params["lam"]
    updates = int(trace.iters[-1])                # updates actually run
    acc = float(trace.final.accepts.float().mean()) / updates
    print(f"MGPMH acceptance rate: {acc:.3f}  "
          f"(expected ~exp(-L^2/lam) = {np.exp(-graph.L**2 / lam):.3f} "
          f"or better)")
    return dict(mgpmh=trace, gibbs=ref, acceptance=acc)


if __name__ == "__main__":
    main()
