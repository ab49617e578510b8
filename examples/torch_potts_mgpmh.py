"""Paper Figure 2(b)/(c) on the PyTorch port: MGPMH and DoubleMIN-Gibbs on
the Gaussian-kernel Potts model, batch sizes in multiples of L^2 / Psi^2
(the counterpart of ``examples/potts_mgpmh.py``).

  PYTHONPATH=src python examples/torch_potts_mgpmh.py [--paper-scale]
      [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import engine, make_potts_graph, run_marginal_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper-scale", action="store_true")
    ap.add_argument("--sweep", type=int, default=8,
                    help="fused site updates per engine call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--iters", type=int, default=None,
                    help="site updates per run (default 30,000; 10^6 at "
                         "paper scale)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.paper_scale:
        g, iters = make_potts_graph(20, 4.6, 10, device=dev), 1_000_000
    else:
        g, iters = make_potts_graph(6, 2.0, 6, device=dev), 30_000
    iters = args.iters or iters
    print(f"Potts n={g.n} D={g.D} Psi={g.psi:.1f} L={g.L:.2f} "
          f"(paper: 957.1, 5.09)  L^2={g.L**2:.1f} << Delta={g.delta}")

    C = 8
    ref = engine.make("gibbs", g, sweep=args.sweep, device=dev)
    tr = run_marginal_experiment(ref, ref.init(0, C), n_iters=iters,
                                 n_snapshots=8)
    out = {"gibbs": tr.error.cpu().numpy()}
    print("gibbs           ", np.round(out["gibbs"], 4))

    # Fig 2(b): MGPMH, proposal batch in multiples of L^2
    for mult in (1.0, 2.0, 4.0):
        lam = float(mult * g.L ** 2)
        eng = engine.make("mgpmh", g, sweep=args.sweep, lam=lam, device=dev)
        tr = run_marginal_experiment(eng, eng.init(0, C), n_iters=iters,
                                     n_snapshots=8)
        updates = int(tr.iters[-1])
        acc = float(tr.final.accepts.float().mean()) / updates
        out[f"mgpmh {mult}"] = (tr.error.cpu().numpy(), acc)
        print(f"mgpmh lam={mult}L^2  ",
              np.round(out[f"mgpmh {mult}"][0], 4), f"acc={acc:.3f}")

    # Fig 2(c): DoubleMIN (second minibatch in multiples of Psi^2);
    # engine.init seeds the cached xi_x augmented state (Thm 5)
    lam1 = float(g.L ** 2)
    for mult in (1.0, 2.0):
        lam2 = float(mult * g.psi ** 2)
        eng = engine.make("doublemin", g, sweep=args.sweep, lam1=lam1,
                          lam2=lam2, device=dev)
        tr = run_marginal_experiment(eng, eng.init(0, C), n_iters=iters,
                                     n_snapshots=8)
        out[f"double {mult}"] = tr.error.cpu().numpy()
        print(f"double l2={mult}Psi^2", np.round(out[f"double {mult}"], 4))
    return out


if __name__ == "__main__":
    main()
