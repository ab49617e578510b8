"""Core library: the paper's minibatch Gibbs algorithms behind the Engine API.

Public API:
  Engine API:     engine.make(name, graph, sweep=S, device=...), Engine,
                  UniformSites, ChromaticBlocks, make_workload, WORKLOADS
  Factor graphs:  MatchGraph, graph_from_numpy, make_ising_graph,
                  make_potts_graph, make_lattice_ising, lattice_colors,
                  make_pair_ising, pair_colors
  Samplers:       ChainState, init_state
  Estimators:     lemma2_lambda, recommended_capacity, draw_local_minibatch
  Runner:         run_marginal_experiment, marginal_error
"""
from .factor_graph import (MatchGraph, graph_from_numpy,
                           gaussian_kernel_interactions, make_ising_graph,
                           make_potts_graph, make_lattice_ising,
                           lattice_colors, make_pair_ising, pair_colors,
                           build_alias_table, alias_draw)
from .estimators import (lemma2_lambda, recommended_capacity,
                         capacity_overflow_prob, draw_local_minibatch)
from .samplers import ChainState, init_state
from . import engine
from .engine import (Engine, Schedule, UniformSites, ChromaticBlocks,
                     Workload, WORKLOADS, make_workload)
from .chains import MarginalTrace, run_marginal_experiment, marginal_error
