"""Core library: the paper's minibatch Gibbs algorithms behind the Engine API.

Public API:
  Engine API:     engine.make(name, graph, sweep=S, device=...), Engine,
                  UniformSites, ChromaticBlocks, AdaptiveScan, make_workload,
                  WORKLOADS
  Factor graphs:  MatchGraph, TabularPairwiseGraph, graph_from_numpy,
                  make_ising_graph, make_potts_graph, make_lattice_ising,
                  lattice_colors, make_pair_ising, pair_colors
  Samplers:       single-site reference steps make_gibbs_step,
                  make_min_gibbs_step, make_local_gibbs_step,
                  make_mgpmh_step, make_double_min_step; ChainState,
                  init_state, init_min_gibbs_cache, init_double_min_cache
  Estimators:     lemma2_lambda, recommended_capacity, draw_global_minibatch,
                  draw_local_minibatch, min_gibbs_estimate
  Runner:         init_chains, run_marginal_experiment, marginal_error
  Exact theory:   spectral (transition matrices, gaps, theorem checks)
"""
from .factor_graph import (MatchGraph, TabularPairwiseGraph, graph_from_numpy,
                           gaussian_kernel_interactions, make_ising_graph,
                           make_potts_graph, make_lattice_ising,
                           lattice_colors, make_pair_ising, pair_colors,
                           build_alias_table, alias_draw, pack_alias)
from .estimators import (lemma2_lambda, recommended_capacity,
                         capacity_overflow_prob, draw_global_minibatch,
                         draw_local_minibatch, min_gibbs_estimate)
from .samplers import (ChainState, init_state, make_gibbs_step,
                       make_min_gibbs_step, make_local_gibbs_step,
                       make_mgpmh_step, make_double_min_step,
                       init_min_gibbs_cache, init_double_min_cache)
from . import engine
from .engine import (Engine, Schedule, UniformSites, ChromaticBlocks,
                     AdaptiveScan, Workload, WORKLOADS, make_workload)
from .chains import (MarginalTrace, init_chains, run_marginal_experiment,
                     marginal_error)
from . import spectral
