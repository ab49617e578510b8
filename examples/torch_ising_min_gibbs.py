"""Paper Figure 1 on the PyTorch port: MIN-Gibbs (bias-adjusted global
minibatch, Algorithm 2) vs vanilla Gibbs on the Gaussian-kernel Ising model
(the counterpart of ``examples/ising_min_gibbs.py``).

Defaults are scaled down; pass --paper-scale for the paper's exact 20x20,
beta=1, 10^6-iteration setting.

  PYTHONPATH=src python examples/torch_ising_min_gibbs.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import engine, make_ising_graph, run_marginal_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper-scale", action="store_true")
    ap.add_argument("--sweep", type=int, default=8,
                    help="fused site updates per engine call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--iters", type=int, default=None,
                    help="site updates per run (default 50,000; 10^6 at "
                         "paper scale)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.paper_scale:
        g, iters = make_ising_graph(20, 1.0, device=dev), 1_000_000
    else:
        g, iters = make_ising_graph(8, 0.5, device=dev), 50_000
    iters = args.iters or iters
    print(f"Ising n={g.n} Psi={g.psi:.1f} L={g.L:.2f} (paper: 416.1, 2.21)")

    C = 8
    ref = engine.make("gibbs", g, sweep=args.sweep, device=dev)
    tr = run_marginal_experiment(ref, ref.init(0, C), n_iters=iters,
                                 n_snapshots=8)
    errors = {"gibbs": tr.error.cpu().numpy()}
    print("gibbs        ", np.round(errors["gibbs"], 4))

    # Fig 1 sweep over the estimator batch size lam in multiples of Psi^2.
    # engine.init seeds Alg 2's cached-energy augmented state; the sweep
    # threads it through the fused update loop.
    for mult in (0.25, 1.0, 4.0):
        lam = float(mult * g.psi ** 2)
        eng = engine.make("min-gibbs", g, sweep=args.sweep, lam=lam,
                          device=dev)
        tr = run_marginal_experiment(eng, eng.init(0, C), n_iters=iters,
                                     n_snapshots=8)
        errors[f"min {mult}"] = tr.error.cpu().numpy()
        print(f"min lam={mult:>4}Psi^2", np.round(errors[f"min {mult}"], 4))
    return errors


if __name__ == "__main__":
    main()
