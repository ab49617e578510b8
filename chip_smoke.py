#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:
  1. device and toolchain (card, power limit, torch/CUDA, nvcc, triton);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all started together; ``-Xptxas -v`` registers / shared
     memory for every kernel: the telemetry update, the ten sampling
     kernels (the Gibbs sweep
     and both MGPMH forms one instance per register width, 2/4/8/10/16
     buckets, the chromatic class kernel one per 2/4/8/16), flash
     attention's six bf16
     instances (padded head dims 64, 128, 256, each without and with the
     row log-sum-exp output; their registers, spills and launch shared
     memory printed apart, and no wgmma serialised) and its four float32
     ones, the flash backward's seven (D; dK/dV and dQ
     at padded head dims 64, 128, 256), the selective scan's nine (N =
     16 at 1, 2, 4, 8, 16 lanes per channel, N = 8 at 1, 2, 4, 8) and its
     backward's three (N = 16 and 8, and the ordered sum of partials));
  3. each kernel against its plain PyTorch version on the card, on the same
     tensors: (a) at the parity shapes of the tests, exactly equal (the
     in-kernel-RNG kernels, the local-gibbs sweep among them, with seeds
     0, 1 and 2^31-1; the Gibbs sweep also at its ring's shapes -- D=129
     above the register width, a ragged n=1001, S=1, and an odd n=23301
     whose rows stream through the ring in chunks -- twice each; both
     MGPMH kernels also at their edge shapes -- an odd n, D=33, K=600
     (several rounds of draws), n=23301 (chunked rows), x outside [0, D)
     at sites never updated, Poisson totals at 0 and at K -- twice each,
     the Philox form for every seed; the
     chromatic class kernel on every class of lattices (4x4, 6x6) and of
     hub graphs of degree 99 and 299 (the warp form, integer weights) at
     D in {2, 3, 10, 129}, fed uniforms, against its plain version and the
     sequential plain version fed their Gumbels, twice; its in-kernel
     Gumbel transform against ``gumbel_from_uniform`` bit for bit over
     every float32 in [0, 1]; the local sweep also at B = 1, B = n-1, a
     ragged n, B > 128, D > 32, a long sweep (S=160) and a sweep in which nearly
     every check of its consumer fails (recompute counts not all zero, at
     most S a chain, a second launch with the same bits); MIN-Gibbs and
     DoubleMIN also at shapes whose
     lane rows take a block three passes and are not a multiple of 4,
     with Poisson totals at 0 and at capacity, twice each with the same
     bits); (b) at full width
     on potts-64x64: mgpmh (C=256, S=64, K=201) and gibbs with at most 1%
     of chains differing — the plain version sums the ~1564 non-zero W
     terms of a row in another order, so only a near-tie can flip a
     decision, and a flip then changes the rest of that chain — the
     chromatic class kernel on both classes of lattice-ising-64x64 at
     C=256 exactly equal to its plain version and to the sequential plain
     version (all weights 0.8: any order of summing four gives the same
     float), and MIN-Gibbs (C=16, S=8, K=17188) and
     DoubleMIN (C=64, S=16, K1=201, K2=17188) exactly equal (integer
     counts, no float reduction); the in-kernel-RNG kernels at those
     shapes with at most 1% of chains differing, and the local-gibbs sweep
     (C=256, S=64, B in {8, 32, 128}) exactly equal, with a second launch
     giving the same bits; (c) the bucket-energy
     kernel at the eight shapes of ``tests/test_kernels.py``, the three of
     ``benchmarks/kernel_bench.py`` and the local path's (C=256, K=B in
     {8, 32, 128}, D=10): bit-equal at integer weights, within rtol 1e-5 /
     atol 1e-4 at N(0,1) weights (another summation order), the same bits
     on a second launch, plus out-of-range values and an f16 input; (d)
     the flash-attention kernel at the six shapes of
     ``tests/test_torch_flash.py`` in float32 (rtol 1e-4, atol 1e-5) and in
     bf16 (rtol 1e-2, atol 1e-2) at the prefill attention of every dense
     config at full width — tinyllama-1.1b (B=8, S=2048, H=32, KVH=4,
     hd=64, causal; also with a 1024 window and at S=32), starcoder2-7b
     (8, 2048, 36, 4, 128), h2o-danube-3-4b (1, 8192, 32, 8, 120, window
     4096), gemma3-12b local (1, 4096, 16, 8, 256, window 1024) and global
     — hymba-1.5b's (8, 2048, 25, 5, 64, window 1024: a GQA group of 5),
     and a ragged bidirectional shape (Sq=200, Sk=333) of each head dim
     16, 32, 64, 120, 128, 256, the same bits on a second launch;
  4. the main path through the user entry points (``engine.make`` +
     ``run_marginal_experiment``): mgpmh and gibbs on potts-64x64 with 256
     chains x 200 sweeps of 64 updates, chromatic gibbs on
     lattice-ising-64x64, min-gibbs (128 chains x 200 sweeps of 8) and
     doublemin (256 chains x 100 sweeps of 64) on potts-64x64 at their
     default lambda, and local-gibbs (256 chains x 100 sweeps of 64) for
     B in {8, 32, 128}, the Fig. 2a batch sizes, each replayed from its
     seed to the same bits; launch counts reset before and read after each
     run, and must equal the sweep calls (chromatic: one class-kernel
     launch per color class and call, no gibbs_sweep launch; one
     local-gibbs sweep launch per call and no bucket-energy launch); then
     each of the five single-site reference steps 64 times at C=256, chains
     moving and their bucket-energy launches counted (the bucket-energy
     kernel's path);
  5. the in-kernel-RNG path at C=256, S=64 on potts-64x64 (the MIN-Gibbs
     host form would need 45 GB of streams there): a few calls of each
     ``*_rng`` kernel with fresh seeds, launch counts reset before and read
     after, device memory growth no more than the outputs plus 1 MiB;
  6. kernel times (CUDA-event medians) at the shapes of phases 4-5 beside
     the plain versions' times and the least time the card could take
     (the Gibbs ring's plan printed; the chromatic class kernel per launch
     as a stream of launches, single call and device time, beside a
     float32 ``torch.matmul`` + argmax yardstick, TF32 off, and its byte
     bound over x, the uniforms and the class rows' records, and its
     launch plan; the whole chromatic sweep call traced: its time, device
     busy and idle, and its device ops per call, which must be five --
     the state's copy, then per class one ``torch.rand`` and one class
     launch);
     the timed outputs of each slice-2 kernel and its plain version are
     compared there too (host-stream kernels exactly, in-kernel-RNG kernels
     to at most 1% of chains, their plain versions run on chain slices);
     the bucket-energy kernel at every phase-3c shape beside its plain
     version, ``scatter_add_`` and its bound, per launch as a stream of
     launches (host path included) and as device time alone
     (``torch.profiler``); the local-gibbs sweep kernel at B in {8, 32,
     128} beside its plain version and bound, with the share of sub-steps
     its consumer recomputed and its plan, and one local-gibbs sweep
     call split into the kernel and the rest (site and seed draws), with
     updates/s and the device's busy time over one call from
     ``torch.profiler``; the MGPMH engine's sweep call traced (the call,
     its draws and the kernel's wrapper alone, with the host's issue time
     of each, and over a stream of ten calls the device's busy time, idle
     share and top ops; the MGPMH kernels' live draws beside a
     random-gather probe of as many records); the
     flash-attention kernel at the prefill attention of tinyllama-1.1b,
     starcoder2-7b, h2o-danube-3-4b and gemma3-12b (local and global)
     beside its plain version, ``scaled_dot_product_attention`` (timed,
     never called by the port; a boolean band mask where a window is set)
     and its bound, the largest of three terms (HBM bytes, tensor-core
     FLOPs, MUFU exponentials), each printed;
  7. the dense-transformer serve path at full width: tinyllama-1.1b (1.1 B
     parameters) with weights drawn on the card from a seed, through
     ``make_prefill_step`` (B=8, S=2048; the flash kernel's launch count
     reset before the calls and read after: one launch per layer and call)
     and ``make_serve_step`` (32 greedy decode steps at B=8 from an empty
     2048-position cache); at B=1, S=32 the forward logits against 32
     decode steps under the reference's criterion (log-softmax max abs diff
     < 0.15, argmax agreement >= 0.9); prefill and decode ms and tokens/s
     and the peak device memory, beside the card's name and power limit;
     then h2o-danube-3-4b (B=1, S=8192, hd 120) and gemma3-12b (B=1,
     S=4096, hd 256) at full width, weights from a seed, one warm-up and
     one counted prefill call each (one flash launch per layer, finite
     logits, ms and tokens/s), each model freed before the next;
     (7f) the SSM and hybrid families: the selective-scan kernel
     (``csrc/selective_scan.cu``) against its plain version at
     falcon-mamba-7b's layer shape (bsz 1, S 4096, d_inner 8192, N 16),
     hymba-1.5b's (8, 2048, 3200, 16) and its B=1 layer (1, 4096, 3200,
     16), ragged ones (S = 1, S off the time tile, d_inner off the channel
     block, N = 8) and the layout's edges (S one past a tile, d_inner off
     the block at every lane count), within SCAN_TOL and the same bits on
     a second launch, the library's layout equal to ``scan_layout``'s, at
     the three layer shapes its time per launch beside its layout (lanes a
     channel, tile, warps a scheduler), the plain version's time and its
     bound; then falcon-mamba-7b (B=1, S=4096) and
     hymba-1.5b (B=8, S=2048) at full width and depth, weights from a
     seed, through ``make_prefill_step`` (launch counts reset before three
     calls and read after: one scan launch per layer and call, and for
     hymba one flash launch too, nothing else, the plain scan never
     called; one more call traced: device busy and idle, the scan's and
     flash's launches and share of busy, top device ops), the float32
     ``w_x`` / ``w_dt`` products timed alone, 32 greedy decode steps at
     B=8, at B=1 S=32 every layer's decode against its prefill path on the
     same input (teacher-forced, within 0.1 of the layer's largest
     output) and the forward's logits against 32 decode steps (recorded:
     past ~16 layers the reference's own paths miss its criterion), and
     the reference's criterion on each config cut to two layers;
     (7m) the MoE family (``models/moe.py``; no kernel of its own, its
     attention the flash kernel's hd-128 instance): mixtral-8x7b at full
     width cut to 24 of 32 layers (35,092,631,552 parameters, 9,725,480,960
     active a token), weights from a seed, capacity factor 1.25, through
     ``make_prefill_step`` at B=1 S=4096 and B=8 S=2048 (a warm-up call,
     then three timed by CUDA events with the launch counts reset before
     and read after: one flash launch per layer and call, nothing else;
     tokens/s, the model-FLOPs share, peak memory, the share of
     assignments each layer drops) and 32 greedy decode steps at B=8 from
     an empty 4096-position cache beside their byte bound; then one B=8
     prefill and one decode step traced and one prefill under
     ``set_sync_debug_mode("error")``; dropless (capacity factor 16, as
     the reference's own decode test) at B=1 S=32 every layer's decode
     against its prefill path (the 0.9 quantile over positions within
     0.1) and the forward's logits against 32 decode steps (recorded at 24
     layers, gated at two: the reference's criterion with its MoE
     quantile);
  8. diagnostics at full width, every sampling loop under
     ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises) with
     the launch counts reset before and read after each run (one sweep
     launch per call, as in phase 4, and one telemetry-kernel launch per
     call for each telemetry carry: the runner's and an AdaptiveScan
     engine's own): (a) mgpmh on potts-64x64 (C=256, S=64, 200 calls) through
     ``run_marginal_experiment(..., telemetry=True)``, replayed to the same
     bits (chains, errors, every telemetry field) and equal to the run
     without telemetry; its ``summarize``, ``health_report``,
     ``freshness_report`` and ``empirical_spectral_gap``; the telemetry's
     cost as host wall time of the 200-call run with and without it (in
     turns), per call as a stream, as the profiler's device busy time per
     call, and the update alone against its bound; adaptive mgpmh's
     updates/s beside uniform's (c); then gibbs, min-gibbs, doublemin (phase-4
     shapes, 20 calls), local-gibbs B=32 and chromatic gibbs on
     lattice-ising-64x64, each with telemetry; (b) ``telemetry_update`` of
     one (C=256, n=4096) trajectory of 32 steps from a seed on the card
     (the kernel) and on the CPU (the plain version), every field within
     rtol 1e-6 / atol 1e-6; (c) gibbs on
     hetero-pairs-1024 uniform against AdaptiveScan at the reference
     bench's settings (S=256, C=32, 96 snapshots x 8 calls, worst-site TV
     0.25, ``benchmarks/diagnostics_bench.py:80-110``), both reaching the
     target, and adaptive mgpmh, min-gibbs and doublemin on potts-64x64 at
     their phase-4 shapes, each replayed to the same bits (mgpmh's error
     falling); (d) 10% of sites observed (from a seed) on potts-64x64
     (gibbs, mgpmh and doublemin at C=256 S=64, min-gibbs at its phase-4
     C=128 S=8; 50 calls) and lattice-ising-64x64 (chromatic): after
     ``clamp`` no observed site differs from its evidence in any chain
     after any call, and 10^7 draws from ``evidence_cdf`` and from the
     masked adaptive table land on no observed site; (e)
     ``autotune_lambda("mgpmh", potts-64x64, target=(0.9, 0.96))``: its
     rounds, landing lambda and wall time; (f) run first: the fused
     telemetry kernel (``csrc/telemetry_update.cu``, what every
     telemetry'd call of (a)-(e) launches, one per carry and call) against
     ``telemetry_update_plain`` on the card, every field bit for bit after
     every call, over 2K + 4 calls (the split crossed, the ring wrapped) at
     C=256 n=4096 K=8, without accept deltas, without stats, without a
     cache, at K=1 (the adaptive carry), at C=96, with a value out of
     [0, D) and with a NaN cache entry; then at the main path's shape (one
     mgpmh call's arguments, both halves) per launch as a stream, device
     time and host issue against its byte bound, beside the plain update's;
     (g) the reference's telemetry contract at its own shape
     (``benchmarks/diagnostics_bench.py:47-65``): mgpmh on potts-20x20,
     C=64, S=64, 48 calls in 4 snapshots through ``run_marginal_experiment``
     with and without telemetry, 7 runs each in turns, the medians'
     overhead against 10%; (h) observability: the mgpmh call at
     potts-64x64 (with and without telemetry) under an active ``Recorder``
     (a ``sweep_chunk`` span, the engine's annotations) against the
     ``NullRecorder``, 15 streams of 10 in turns, the median of the turns'
     ratios against 5%, and one span alone (host time); the active loop
     under ``set_sync_debug_mode("error")`` with the null loop's launches;
     the launcher (potts-20x20) with ``--metrics-dir``, ``--trace`` and
     ``--profile``: its files parse, count every call, and the profile's
     ``repro.sweep/mgpmh/cuda`` range holds the sweep kernel and its
     ``repro.sweep/telemetry`` range the telemetry kernel;
  9. the dist backend (``runtime/dist_gibbs.py``, no kernel of its own):
     (a) this process as one rank on NCCL, a (1, 1) ``DeviceMesh``,
     through ``engine.make(..., mesh=)``: gibbs and mgpmh on potts-64x64 at
     C=256, S=64, 200 calls (marginal error falling, mgpmh acceptance above
     0.9), min-gibbs at C=128, S=8 when the reckoning of its transient
     bytes fits the card (else C=32) and doublemin at C=32, S=8, 10 calls
     each, and all four at the JAX bench's dist shape (potts-20x20, C=32,
     S=8, 20 calls, lambda 128); every loop under
     ``set_sync_debug_mode("error")``, one all-reduce per call, each run
     replayed from its seed to the same bits; ms per call and updates/s
     beside phase 4's, and for gibbs and mgpmh one call's device ops,
     device busy share (``torch.profiler``) and host issue, the
     all-reduce's time at their payload (CUDA events) and the
     ``psum_footprint`` bytes; chromatic gibbs on lattice-ising-64x64 at
     C=256 bit-equal to ``make_chromatic_gibbs_step`` for 2 sweeps; the
     launcher's ``run(backend="dist")``; (b) two spawned processes sharing
     the card on gloo (NCCL refuses two ranks on one device), meshes 1x2 and
     2x1: all four algorithms within 0.05 of the exact marginals on potts
     2x2 D=3 (C=64, S=4, 800 calls) with one all-reduce per call, and on
     the 1x2 mesh chromatic lattice-ising-64x64 at C=2 bit-equal to the
     dense reference; a rank that fails or passes its join timeout fails
     the run;
 10. the supervised runtime (``runtime/supervisor.py``): crash-resume at
     potts-64x64 bit-equal to the clean run, escalation, the launcher,
     one NCCL rank and an elastic 2x1 -> 1x1 gloo pair (phase 10's
     functions say what each holds);
 11. serving (``serving/pool.py``, ``launch/serve.py``): (a) gibbs and
     mgpmh pools at potts-64x64 C=256 S=64 under the launcher's demo
     traffic -- chunk and publish-copy times, every lane's chunk launching
     16 sweep and 16 telemetry kernels under
     ``set_sync_debug_mode("error")``, one clamped chunk held against the
     plain versions, the answer path's overhead, the freshness gate's run;
     (b) hetero-pairs-1024: fresh clamped answers against exact
     conditionals, the exact rung, the resident bit-equal to an unserved
     control (gibbs, min-gibbs), the chaos drill; (c) supervised serving
     under phase 10's plan bit-equal to a clean run; (d) answer latency
     with the background driver stopped and running; (e) the serve
     launcher as subprocesses; (f) the profiler's device ops of a resident
     and a clamped chunk, equal; the kernel library not rebuilt;
 12. training (``launch/train.py``, ``launch/steps.py``, ``optim/``, the
     flash backward kernel ``csrc/flash_attention_bwd.cu``, the selective
     scan's backward in ``csrc/selective_scan.cu``): (a) the
     backward kernels' registers, spills (none in the wgmma ones) and
     shared memory; against its plain float32 version at tinyllama-1.1b's
     training attention (B=8, S=2048, 32/4 heads, hd 64, causal),
     h2o-danube-3-4b's window (S=8192, hd 120, window 4096), gemma3-12b's
     local and global layers (hd 256, window 1024 and none),
     a ragged bidirectional shape of every head dim, a causal Sk > Sq and
     rows with no valid key: dq, dk, dv each within 1e-2 relative
     (Frobenius), the same bits on a second launch; at the four model
     shapes its time per call (three launches) and each kernel's device
     time, the FLOP bound (2.5 times the forward's products) and
     scaled_dot_product_attention's backward (fwd + bwd minus fwd, a band
     mask at the windowed shapes, its fused causal path at the others), at
     tinyllama's also the plain version;
     (b) ``launch.train.train`` on tinyllama-1.1b at full width (weights
     from a seed, B=8, S=2048) for two steps into a temporary ckpt_dir,
     every launch count reset before and read after: the backward kernel
     once per layer and step, the forward twice (its rematerialisation),
     nothing else, the plain backward never called, losses and grad norms
     finite; then ``make_train_step`` timed (CUDA events), tokens/s, the
     model-FLOPs share, peak memory and one step under torch.profiler
     (device busy, idle, top ops, the backward's share); (c) crash-resume:
     a run killed by ``fail_at_step`` and resumed ends bit-equal to an
     uninterrupted one (loss, parameters, AdamW state); (d) the examples
     (``examples/torch_*.py``) as subprocesses, exit 0; (e) gemma3-12b at
     full width (d 3840, 16/8 heads, hd 256, d_ff 15360, vocab 262144,
     tied embeddings) cut to one 5:1 period (6 of 48 layers: the full
     depth's float32 training state does not fit one card), weights from a
     seed, B=1 S=4096: ``make_train_step`` for a warm-up and timed steps,
     every launch count reset before and read after -- per step the
     backward kernel once per layer (5 local, 1 global, all at hd 256) and
     the forward twice, nothing else, the plain backward never called,
     losses and grad norms finite; ms per step, tokens/s, the model-FLOPs
     share, peak memory, and one step under torch.profiler (idle share, the
     backward's device time and share of busy); (f) the SSM and hybrid
     families: the selective scan's backward kernel (its three entries'
     registers and spills) against its plain float32 version at
     falcon-mamba-7b's layer (1, 4096, 8192, 16), hymba-1.5b's at B=8
     (8, 2048, 3200, 16) and B=1, and ragged shapes (S = 1, S off the
     16-step chunk, d_inner off the 32-channel block, N = 8), z the strided
     gate half of a projection: every gradient within its relative
     (Frobenius) tolerance, in its input's dtype, finite, the same bits on
     a second launch, the library's layout equal to ``scan_bwd_layout``'s;
     at the three layer shapes its time per call (three launches), its
     kernels' device time, the plain version's and the bound; then
     ``make_train_step`` on hymba-1.5b at full width and depth (B=8,
     S=2048) and on falcon-mamba-7b at full width cut to 16 of 64 layers
     (B=1, S=4096; the full depth's training state does not fit one
     card), weights from a seed, every launch count reset before and read
     after -- per step the scan's forward twice and its backward once per
     mamba layer, hymba's flash forward twice and backward once per layer,
     nothing else, no plain version called, losses and grad norms finite,
     one step taken twice from the same state giving the same parameters
     bit for bit -- and the step's figures as (e)'s with the scan's device
     time and share of busy.

Prints the kernels' JSON record and the card's name and power limit, then
as its last line ``{"ok": true, "device": {...}}``.  Also writes the full
record to ``chiprun_out/chip_smoke.json``.  Needs one CUDA card; imports
nothing of JAX.
"""
import contextlib
import dataclasses
import importlib.metadata
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12                  # dense bf16 tensor cores
# exponentials: 16 MUFU ex2 per clock per SM (4 per SM sub-partition) x
# 132 SMs x the same 1.98 GHz clock
EX2_PER_S = 132 * 16 * 1.98e9
# int32 rate: 64 INT32 lanes per SM (half the 128 FP32 lanes, NVIDIA H100
# Tensor Core GPU Architecture white paper) x 132 SMs x the 1.98 GHz clock
# behind the data sheet's 67 TFLOP/s (= 132 x 128 x 2 x 1.98e9)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# one Philox4x32-10 call, 4 words: 10 rounds of two 32x32 -> 64-bit
# multiplies (one IMAD.WIDE gives hi and lo) and two three-input XORs (one
# LOP3 each); the round keys depend only on (seed, stream), so the function
# needs them once per stream, not once per call
PHILOX_INT_OPS = 10 * 4

C_FULL, S_FULL, SWEEPS = 256, 64, 200
C_MIN, S_MIN, SWEEPS_MIN = 128, 8, 200        # min-gibbs main path
C_DMIN, S_DMIN, SWEEPS_DMIN = 256, 64, 100    # doublemin main path
FULL_MIN, FULL_DMIN = (16, 8), (64, 16)       # exact full-width checks
# chains per call of a plain in-kernel-RNG version held against the kernel
# at C=256, S=64: it materialises every stream of its chains (~1.5 GB per
# MIN-Gibbs chain, ~0.15 GB per DoubleMIN chain)
SLICE_MIN, SLICE_DMIN = 8, 64
RNG_CALLS = 3                                 # phase 5 calls per kernel
PARITY_MGPMH = [(4, 5, 17, 3, 11), (8, 8, 128, 10, 40), (3, 1, 1, 2, 5),
                (5, 12, 33, 6, 20), (2, 3, 9, 129, 7)]
PARITY_GIBBS = [(4, 5, 3, 11), (8, 8, 10, 40), (3, 1, 2, 5)]
PARITY_MIN = [(4, 5, 17, 3, 11), (3, 1, 1, 2, 5), (5, 7, 33, 4, 20)]
PARITY_DMIN = [(4, 5, 17, 9, 3, 11), (3, 1, 1, 1, 2, 5),
               (5, 7, 33, 21, 4, 20)]         # (C, S, K1, K2, D, n)
# long lane rows (tests/test_torch_minibatch.py): D*K = 5155 and K2 =
# 4099 lanes, neither a multiple of 4, three passes of a 512-thread block
SPLIT_MIN = (3, 4, 1031, 5, 300)
SPLIT_DMIN = (3, 4, 33, 4099, 4, 300)
SEEDS = (0, 1, 2 ** 31 - 1)
# (C, S, B, D, n) of the local-gibbs sweep: tests/test_torch_local_sweep.py
PARITY_LOCAL = [(4, 5, 3, 3, 11), (8, 8, 10, 10, 40), (3, 1, 1, 2, 5),
                (5, 12, 19, 6, 20), (2, 3, 100, 4, 129), (3, 4, 130, 5, 200),
                (2, 2, 199, 3, 200), (2, 3, 40, 37, 90), (4, 64, 12, 2, 16),
                (2, 160, 32, 10, 1000)]
# the parity shape at which nearly every check of the consumer fails
PARITY_LOCAL_STALE = (4, 64, 12, 2, 16)
KERNELS = ("gibbs_sweep", "gibbs_class_sweep", "mgpmh_sweep",
           "mgpmh_sweep_rng", "min_gibbs_sweep", "min_gibbs_sweep_rng",
           "double_min_sweep", "double_min_sweep_rng", "bucket_energy",
           "local_gibbs_sweep", "flash_attention", "telemetry_update",
           "flash_attention_bwd", "selective_scan", "selective_scan_bwd")
# ptxas entry functions: one per kernel, but flash attention has six bf16
# instances (padded head dims 64, 128, 256, each without and with the
# lse2 output) and four float32 ones (head dims 16, 32, 64, 128), the
# Gibbs sweep and both MGPMH forms one per register width (2, 4, 8, 10,
# 16 buckets) and the class kernel one per width (2, 4, 8, 16) plus its
# Gumbel transform alone (the transform check); the
# telemetry update one; the flash backward seven (D, then dK/dV and dQ at
# padded head dims 64, 128, 256); the selective scan eighteen (lanes per
# channel 1, 2, 4, 8, 16 at N = 16 and 1, 2, 4, 8 at N = 8, each without
# and with the checkpoints), its backward five (four and two states a lane
# at N = 8 and 16, and the ordered sum of the partials)
PTXAS_ENTRIES = len(KERNELS) - 8 + (6 + 4) + 3 * 5 + 4 + 1 + 7 + 18 + 5
# the Gibbs ring kernel's new shapes (C, S, D, n): tests/test_torch_sweep.py
# GIBBS_RING_SHAPES (D > the register width, a ragged n, S = 1, an odd n
# that takes the chunked ring)
PARITY_RING = [(2, 3, 129, 7), (3, 6, 10, 1001), (4, 1, 10, 40),
               (2, 3, 10, 23301), (2, 2, 129, 23301)]
CHUNKED_N = 20000
# the MGPMH kernels' edge shapes (C, S, K, D, n), x outside [0, D) at sites
# never updated and totals at 0 and at K: tests/test_torch_sweep.py
# MGPMH_EDGE_SHAPES (an odd n, D above the register width, K above the
# block, an odd n whose rows stream through the ring in chunks)
PARITY_MGPMH_EDGE = [(3, 6, 17, 10, 1001), (2, 3, 9, 33, 7),
                     (3, 4, 600, 5, 301), (2, 3, 17, 10, 23301),
                     (2, 2, 9, 33, 23301)]
# host-clock reps of the mgpmh call's split (phase 6)
CALL_REPS = 20
# the class kernel (graph kind, size, weights, D, C): the lattice with
# lattice-ising's weights, and a hub of degree size - 1 (the warp form) with
# integer weights (every summation order gives the same bits):
# tests/test_torch_chromatic.py
PARITY_CLASS = [("lattice", 4, "ising", 2, 5), ("lattice", 6, "ising", 2, 3),
                ("hub", 100, "integer", 2, 6), ("hub", 100, "integer", 10, 6),
                ("hub", 300, "integer", 3, 6), ("hub", 300, "integer", 129, 6)]
# bucket-energy shapes (C, K, D): tests/test_kernels.py:30-33,
# benchmarks/kernel_bench.py:29, and the local path's minibatches
LOCAL_B = (8, 32, 128)                        # the Fig. 2a batch sizes
SWEEPS_LOCAL = 100
BUCKET_SHAPES = [(1, 1, 2), (4, 100, 10), (8, 256, 2), (32, 1024, 10),
                 (5, 513, 257), (16, 50, 129), (3, 2000, 4), (7, 131, 128),
                 (64, 1024, 10), (256, 4096, 10), (64, 8192, 2),
                 *((C_FULL, b, 10) for b in LOCAL_B)]
BUCKET_MAIN = (C_FULL, 32, 10)                # local-gibbs at the default B
LOCAL_MAIN = 32                               # the local-gibbs default B
STEP_CALLS = 64                               # phase 4 single-site steps
# flash attention (B, Sq, Sk, H, KVH, hd, window, causal): the float32
# shapes of tests/test_torch_flash.py that have a float32 template, then
# bf16: the prefill attention of each config at full width —
# tinyllama-1.1b (also with a 1024 window and at S=32, one ragged tile),
# starcoder2-7b, h2o-danube-3-4b (window 4096 at S=8192: whole key tiles
# outside it), gemma3-12b's local (window 1024) and global layers,
# mixtral-8x7b's two prefills of phase 7m (window 4096: at S=4096 the
# window equals S, the band's edge) — and one
# ragged bidirectional shape per head dim (Sq != Sk, neither a multiple of
# the 128-row tile: the tensor maps' zero fill and the clipped stores)
FLASH_SHAPES = [(2, 128, 128, 4, 2, 64, 0, True),
                (1, 256, 256, 2, 1, 64, 64, True),
                (2, 100, 100, 4, 4, 32, 0, True),
                (1, 64, 192, 2, 2, 64, 0, False),
                (1, 128, 128, 2, 2, 128, 32, True),
                (1, 384, 384, 2, 2, 64, 64, True)]
FLASH_CONFIGS = {"tinyllama-1.1b": (8, 2048, 2048, 32, 4, 64, 0, True),
                 "starcoder2-7b": (8, 2048, 2048, 36, 4, 128, 0, True),
                 "h2o-danube-3-4b": (1, 8192, 8192, 32, 8, 120, 4096, True),
                 "gemma3-12b local": (1, 4096, 4096, 16, 8, 256, 1024, True),
                 "gemma3-12b global": (1, 4096, 4096, 16, 8, 256, 0, True),
                 "mixtral-8x7b B=8": (8, 2048, 2048, 32, 8, 128, 4096, True),
                 "mixtral-8x7b B=1": (1, 4096, 4096, 32, 8, 128, 4096,
                                      True)}
FLASH_BF16 = [*FLASH_CONFIGS.values(),
              (8, 2048, 2048, 32, 4, 64, 1024, True),
              (8, 2048, 2048, 25, 5, 64, 1024, True),    # hymba-1.5b, 7f
              (8, 32, 32, 32, 4, 64, 0, True),
              *((1, 200, 333, 4, 2, hd, 0, False)
                for hd in (16, 32, 64, 120, 128, 256))]
# bf16 output: one rounding of values of size ~1 is 2^-8 and p is rounded
# to bf16 against another running max than the plain version's: within two
# bf16 ulps of the plain version
FLASH_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
# phase 7: tinyllama-1.1b serve path at full width
SERVE_ARCH, SERVE_SEED = "tinyllama-1.1b", 0
PREFILL_B, PREFILL_S, PREFILL_CALLS = 8, 2048, 4
# ... and one prefill call each of the configs with head dims 120 and 256
# (arch, B, S): danube's window (4096) and gemma3's local window (1024)
# exclude keys at these lengths
WIDE_PREFILL = [("h2o-danube-3-4b", 1, 8192), ("gemma3-12b", 1, 4096)]
DECODE_B, DECODE_STEPS = 8, 32
# phase 7f: the SSM and hybrid families at full width and depth, weights
# from a seed, after the dense models are freed: (arch, prefill B, S)
SSM_SERVE = [("falcon-mamba-7b", 1, 4096), ("hymba-1.5b", 8, 2048)]
SSM_PREFILL_CALLS = 3
# the scan kernel against its plain version (bsz, S, d_inner, N): each
# config's layer shape and hymba-1.5b's B=1 layer (timed), then S = 1, S
# off the time tile, d_inner off the 32-channel block, N = 8; then the
# layout's edges (selective_scan.scan_layout): S one past a tile (32 steps
# at 16 and 8 lanes, 16 at 4), d_inner off the block at every lane count
# of both N (16: 16, 8, 4, 2, 1 lanes; 8: 8, the most, then 4, 2, 1)
SCAN_MODEL_SHAPES = {"falcon-mamba-7b": (1, 4096, 8192, 16),
                     "hymba-1.5b": (8, 2048, 3200, 16)}
SCAN_TIMED = {**SCAN_MODEL_SHAPES, "hymba-1.5b B=1": (1, 4096, 3200, 16)}
SCAN_SHAPES = [*SCAN_TIMED.values(), (2, 1, 64, 16), (1, 100, 64, 16),
               (2, 70, 100, 16), (3, 130, 200, 8), (1, 33, 64, 16),
               (3, 33, 3000, 16), (5, 17, 3394, 16), (17, 5, 2002, 16),
               (34, 3, 2000, 16), (2, 21, 4002, 8), (3, 6, 6002, 8),
               (9, 4, 4002, 8), (40, 3, 2002, 8)]
# tests/test_torch_ssm.py CARD_TOL: the kernel's ex2.approx against expf
# and the sum over n in another order can put a bf16 rounding of y one ulp
# apart (2^-7 relative at most); near-zero y within float32 rounding of
# its terms
SCAN_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
# each layer's decode against its prefill path on the same input
# (transformer.decode_gap_by_layer), relative to the layer's largest
# output: tests/test_torch_models.py LAYER_GAP_TOL, derived there
LAYER_GAP_TOL = 0.1
# The reference's end-to-end criterion (forward logits against decode
# steps) compounds every bf16 rounding difference through depth: the JAX
# package itself misses it on these random-weight families past ~16 layers
# (0.36 log-softmax diff at 64 mamba layers, d_model 256; PERF.md).
# It is gated at the depth of the reference's own test (its smoke configs'
# two layers) at full width; full depth is recorded, and held layer by
# layer by LAYER_GAP_TOL.
SSM_GATE_LAYERS = 2
# phase 7m: the MoE family, after 7f's models are freed.  mixtral-8x7b at
# full width cut to 24 of 32 layers (the full depth's 93.4 GB of bf16
# weights do not fit one card; the cut's 70.19 GB leave ~14 GB for the
# prefill's buckets and the decode cache), weights from a seed, at the
# config's capacity factor 1.25: prefill (B, S), each timed over
# MOE_PREFILL_REPS calls after a warm-up; decode B=DECODE_B from an empty
# cache of MOE_DECODE_S positions (the window)
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 24
MOE_PREFILL = [(1, 4096), (8, 2048)]
MOE_PREFILL_REPS = 3
MOE_DECODE_S = 4096
# the gates run dropless, at the capacity factor of the reference's own
# decode test (tests/test_models.py:70-71): at 1.25 the decode's T = B
# tokens get 2 bucket rows an expert and drop where the prefill does not.
# A MoE layer is held by the reference's MoE rule, the 0.9 quantile over
# positions (transformer.MOE_GAP_QUANTILE; tests/test_models.py:92-96):
# a router near-tie can flip one token's expert between the two paths
MOE_DROPLESS = 16.0
# the MoE layer on the card against a plain per-expert loop on the same
# tensors (moe_layer_check): at the B=8 S=2048 prefill's T = 16384 and
# capacity factor 1.25, the inputs shifted along expert 0's router column
# (its logit up by MOE_CHECK_SKEW) so that it overflows its capacity.  Ids
# are compared where the k-th and (k+1)-th probabilities lie more than
# MOE_NEAR_TIE apart, and the outputs within tests/test_torch_moe.py's
# bf16 bound (FFN_MAX, FFN_MEAN: about twice the distance measured there)
MOE_CHECK_T, MOE_CHECK_SKEW = 8 * 2048, 3.0
MOE_NEAR_TIE = 1e-5
MOE_FFN_MAX, MOE_FFN_MEAN = 0.05, 0.005
# phase 12: training.  tinyllama-1.1b at full width through launch.train
TRAIN_ARCH, TRAIN_SEED, TRAIN_B, TRAIN_S = "tinyllama-1.1b", 0, 8, 2048
TRAIN_STEPS = 2        # train(): steps, then its final checkpoint (13 GB)
TRAIN_TIMED = 3        # make_train_step steps timed after a warm-up step
# tests/test_torch_flash_bwd.py's tolerance (relative Frobenius error per
# gradient against the plain float32 backward), derived there
BWD_REL_TOL = 1e-2
# (B, Sq, Sk, H, KVH, hd, window, causal): the first BWD_MODEL_SHAPES are
# tinyllama-1.1b's training attention, h2o-danube-3-4b's window (4096 at
# S=8192), gemma3-12b's local and global layers; then a ragged
# bidirectional shape of every head dim, a causal Sk > Sq (key tiles no
# query sees) and rows with no valid key
BWD_MODEL_SHAPES = 4
BWD_SHAPES = [(8, 2048, 2048, 32, 4, 64, 0, True),
              (1, 8192, 8192, 32, 8, 120, 4096, True),
              (1, 4096, 4096, 16, 8, 256, 1024, True),
              (1, 4096, 4096, 16, 8, 256, 0, True),
              *((1, 200, 333, 4, 2, hd, 0, False)
                for hd in (16, 32, 64, 120, 128, 256)),
              (1, 70, 300, 4, 2, 64, 0, True),
              (1, 150, 20, 2, 1, 16, 5, True)]
# 12c: the examples' ~100M config (examples/torch_train_lm.py) cut to four
# layers; six steps, checkpoints every three, killed at step four
RESUME_CFG = dict(name="demo-100m", family="dense", num_layers=4,
                  d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
                  d_ff=2048, vocab_size=32000, rope_theta=1e4)
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL = 6, 3, 4
# 12e: gemma3-12b at full width, depth cut from 48 layers to one period
# of its window pattern (five local layers, one global): 2.35B parameters,
# ~38 GB of float32 training state (the full depth's ~188 GB does not fit
# one 80 GB card); B=1 at the trained length S=4096
GEMMA_ARCH, GEMMA_LAYERS, GEMMA_B, GEMMA_S = "gemma3-12b", 6, 1, 4096
# 12f: the selective scan's backward against its plain version (bsz, S,
# d_inner, N): the SCAN_TIMED layer shapes (timed), then S = 1, S off the
# 16-step chunk, d_inner off the 32-channel block at both layouts
# (selective_scan.scan_bwd_layout: two states a lane at (2, 70, 100, 16)
# and (2, 21, 4002, 8), four at (5, 17, 3394, 16), (40, 3, 2002, 8),
# (3, 48, 3000, 16) and (4, 17, 4002, 8); 3394 and 4002 end on a block of
# two live channels), S = 16 k (16, 48: no partial chunk, the last
# checkpoint one chunk before the end) and 16 k + 1 (17, 33: a last chunk
# of one step), N = 8; z the strided gate half of scan_inputs throughout
SCAN_BWD_SHAPES = [*SCAN_TIMED.values(), (2, 1, 64, 16), (1, 100, 64, 16),
                   (2, 70, 100, 16), (3, 130, 200, 8), (1, 33, 64, 16),
                   (5, 17, 3394, 16), (2, 21, 4002, 8), (40, 3, 2002, 8),
                   (2, 16, 64, 16), (3, 48, 3000, 16), (4, 17, 4002, 8)]
# relative Frobenius error of each gradient against the plain float32
# backward: the float32 gradients, and dz (one bf16 rounding more):
# tests/test_torch_ssm.py BWD_CARD_TOL, derived there
SCAN_BWD_REL_TOL = {"float32": 2e-5, "dz": 2e-4}
# the forward kernel's checkpoints against the plain forward's states on
# the card, relative Frobenius: the same products and sums in the same
# order, but the decays are ex2.approx against expf (a few float32 ulps)
# through a contracting recurrence of up to S steps
SCAN_CKPT_REL_TOL = 1e-5
# 12f: the SSM and hybrid families trained at full width, weights from
# TRAIN_SEED: (arch, layers (None: all), B, S).  hymba-1.5b whole (26.6 GB
# of float32 training state); falcon-mamba-7b cut from 64 to 16 layers
# (35.5 GB; the full depth's 116 GB does not fit one 80 GB card); each at
# phase 7f's prefill shape
SSM_TRAIN = [("hymba-1.5b", None, 8, 2048), ("falcon-mamba-7b", 16, 1, 4096)]
# 12d: the port's examples, default sizes but the trainer's few steps
EXAMPLE_RUNS = [["examples/torch_train_lm.py", "--steps", "4", "--seq", "256",
                 "--global-batch", "4", "--ckpt-dir", "{tmp}/lm"],
                ["examples/torch_quickstart.py"],
                ["examples/torch_ising_min_gibbs.py"],
                ["examples/torch_potts_mgpmh.py"],
                ["examples/torch_adaptive_scan.py"]]
EXAMPLE_TIMEOUT_S = 300
# phase 8: diagnostics
DIAG_SNAPSHOTS = 10
DIAG_CALLS = 20                               # the other engines' runs
TEL_STEPS = 32                                # phase 8b trajectory
TEL_TOL = dict(rtol=1e-6, atol=1e-6)          # tests/test_torch_telemetry.py
# the reference bench's adaptive-vs-uniform cell at paper scale
# (benchmarks/diagnostics_bench.py:80-110): S, C, snapshots, calls per
# snapshot, worst-site TV target
ADA_S, ADA_C, ADA_SNAPSHOTS, ADA_CALLS, ADA_TARGET = 256, 32, 96, 8, 0.25
EV_CALLS, EV_FRACTION = 50, 0.10
LANDING_DRAWS = 10_000_000
AUTOTUNE_TARGET = (0.9, 0.96)
# phase 8f: the telemetry kernel against its plain version on the card, bit
# for bit, each case over 2K + 4 calls (the split at call 9 crossed, the
# ring wrapped twice): (C, n, K, half_at, inputs left out, a bad state,
# the sweep's stats: "moves" / "hits", a SiteDraws of C x 64 sites, as the
# engines hand them over, or "counts", a SweepStats)
TEL_N, TEL_D = 4096, 10                       # potts-64x64's sites, values
TEL_CASES = {
    "C=256 K=8, site draws (moves)": (256, TEL_N, 8, 9, (), None, "moves"),
    "site draws (hits)": (256, TEL_N, 8, 9, (), None, "hits"),
    "counters (SweepStats)": (256, TEL_N, 8, 9, (), None, "counts"),
    "no accept_delta": (256, TEL_N, 8, 9, ("accept_delta",), None, "moves"),
    "no stats": (256, TEL_N, 8, 9, ("stats",), None, "moves"),
    "no cache": (256, TEL_N, 8, 9, ("cache",), None, "moves"),
    "K=1 (the adaptive carry)": (256, TEL_N, 1, 2, (), None, "moves"),
    "C=96": (96, TEL_N, 8, 9, (), None, "moves"),
    "a value out of [0, D)": (256, TEL_N, 8, 9, (), "x", "counts"),
    "a NaN cache entry": (256, TEL_N, 8, 9, (), "cache", "moves"),
}
# 8g: the reference's telemetry contract at its own shape
# (benchmarks/diagnostics_bench.py:47-65): mgpmh on potts-20x20, C=64,
# S=64, 48 calls in 4 snapshots, overhead < 10%
REF_C, REF_S, REF_CALLS, REF_SNAPSHOTS, REF_LIMIT = 64, 64, 48, 4, 0.10
REF_REPS = 7
# 8h: observability's contract (src/repro/obs/recorder.py:1-15): an
# active recorder within 5% of the null one
OBS_LIMIT = 0.05
OBS_CALLS = 20
OBS_REPS = 15
CHECK_S = 32                                  # decode vs forward, B = 1
# the reference's decode-vs-forward criterion (tests/test_models.py:92-99)
SELF_TOL, SELF_AGREE = 0.15, 0.9
# phase 9: the dist backend.  (a) gibbs and mgpmh at the main path's shape
# (C_FULL, S_FULL), 200 calls in 10 segments; min-gibbs at its phase-4
# shape, doublemin at C_DIST_SMALL x S_DIST_SMALL, DIST_SHORT_CALLS
# calls each; the JAX bench's dist shape (benchmarks/sweep_bench.py:208-219:
# workload, C, S, calls, min-gibbs' lam and doublemin's lam2)
DIST_CALLS, DIST_SNAPSHOTS, DIST_SHORT_CALLS = 200, 10, 10
C_DIST_SMALL, S_DIST_SMALL = 32, 8
DIST_BENCH = ("potts-20x20", 32, 8, 20, 128.0)
# (b) two processes on the one card: NCCL refuses two ranks on one device
# (ncclInvalidUsage, "Duplicate GPU detected", NCCL 2.28.9 on the H100,
# found by a one-off probe of two NCCL ranks on device 0); gloo stages CUDA
# tensors through the host.  The exact-marginals check of
# tests/test_distributed.py:28-62 (C, S, calls) and its tolerance, and the
# tolerance of the exact edge agreements (which depend on W: a sampler that
# ignores the couplings misses them by 0.042; tests/test_torch_dist.py)
DIST_TWO_RANK_BACKEND = "gloo"
DIST_SMALL, DIST_SMALL_TOL, DIST_AGREE_TOL = (64, 4, 800), 0.05, 0.015
DIST_JOIN_S = 300
# the supervisor's nan-x fault code (src/repro/runtime/faultinject.py:198)
OOD_CODE = int(np.iinfo(np.int32).min // 2)
# phase 10: the supervised runtime at the main path's shape (C_FULL,
# S_FULL), SUP_OUTER outer steps of SUP_CHUNK calls; the JAX dist test's
# plan (tests/test_distributed.py:307-310)
SUP_CHUNK = 16
SUP_OUTER = 8
SUP_DIST_OUTER = 5                     # 10d on NCCL: the plan's last step
SUP_PLAN = [dict(step=2, kind="corrupt", target="arrays"),
            dict(step=2, kind="preempt"),
            dict(step=4, kind="nan", target="x")]
# 10b: a lambda far under potts-64x64's 4 L^2, the floor it falls under
# and the band the re-tune aims for
SUP_RETUNE = dict(lam=0.1, floor=0.3, target=(0.6, 0.9))
# 10c: the launcher as a subprocess (config, chains, sweep, calls)
SUP_LAUNCHER = ("potts-20x20", 64, 64, 128)
# 10d (b): two gloo processes, potts 2x2 D=3 (C, S, outer steps x calls)
SUP_ELASTIC = (1024, 4, 60, 8)
SUP_ELASTIC_BURN = 10
SUP_TIME_REPS = 2                      # turns of bare / ckpt_every 1 / 8
# phase 11: serving (serving/pool.py, launch/serve.py).  (a) potts-64x64
# at the main path's width (C_FULL, S_FULL), gibbs and mgpmh, chunks of
# POOL_CHUNK sweeps, the default FreshnessPolicy, the launcher's demo
# traffic (_demo_queries(seed=0, n=POOL_DEMO)) twice, each lane at most
# POOL_BUDGET extra sweeps per batch (a gate read per chunk, ~0.5 s at
# potts-64x64, sets the phase's time); the freshness gate on the resident
# until it passes or POOL_GATE_S pass, a gate read every POOL_GATE_EVERY
# chunks; the resilience overhead min of POOL_REPS in turns
# (tests/test_resilience.py:332-364's measurement).  (b)-(e) on
# POOL_PAIRS, whose components are pairs (exact conditionals are cheap):
# the bounds of tests/test_serving.py:140-146 and the chaos drill of
# tests/test_resilience.py:375-426 (its policy, admission, breaker,
# tolerance), POOL_DRIVER_BATCHES batches of POOL_DRIVER_DEMO demo queries
# (one unclamped, one clamped) under the background driver.
# MIN-Gibbs' plain version holds (C, S, D, K) pair indices: it is held on
# the first POOL_PLAIN_CHAINS chains of each call
POOL_CHUNK = 16
POOL_DEMO = 8
POOL_BUDGET = 2 * POOL_CHUNK
POOL_GATE_S = 20.0
POOL_GATE_EVERY = 8
POOL_REPS = 7
POOL_PAIRS = "hetero-pairs-1024"
POOL_FRESH_BUDGET = 30_000           # tests/test_serving.py:135
POOL_MIN_BUDGET = 8 * POOL_CHUNK     # min-gibbs' sweeps to try for fresh
POOL_TV = (0.06, 0.25)               # mean / max TV to the exact ones
POOL_CHAOS = dict(policy=dict(max_rhat=1.15, min_ess_per_site=32.0,
                              min_samples=128),
                  max_pending=3, open_after=2, tol=0.16, rounds=4)
POOL_DRIVER_BATCHES = 50
POOL_DRIVER_DEMO = 2
POOL_PLAIN_CHAINS = 32


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, reps, warmup=1):
    """(median CUDA-event ms over ``reps`` timed calls of ``fn()``, the
    last call's result)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def median_ms(fn, reps, warmup=1):
    return timed(fn, reps, warmup)[0]


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "not installed"
    info = dict(device=name, nvidia_smi=smi, count=torch.cuda.device_count(),
                python=sys.version.split()[0], torch=torch.__version__,
                torch_cuda=torch.version.cuda, nvcc=nvcc, triton=triton)
    say("1 device", json.dumps(info))
    return info


def wrappers():
    """Every kernel wrapper, each with its launch count."""
    from repro_torch.kernels import fused_sweep as fs, minibatch_energy as me
    from repro_torch.kernels import flash_attention as fa, local_sweep as ls
    from repro_torch.kernels import chromatic_sweep as chs
    from repro_torch.kernels import telemetry_update as tu
    from repro_torch.kernels import selective_scan as ss
    return fs.WRAPPERS + (chs.gibbs_class_sweep_cuda, me.bucket_energy_cuda,
                          ls.local_gibbs_sweep_cuda, fa.flash_attention_cuda,
                          tu.telemetry_update_cuda,
                          fa.flash_attention_bwd_cuda,
                          ss.selective_scan_cuda, ss.selective_scan_bwd_cuda)


def reset_launches():
    for fn in wrappers():
        fn.launches = 0


def read_launches():
    return {fn.__name__[:-len("_cuda")]: fn.launches for fn in wrappers()}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.load_library()
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "entry function" in ln or "spill" in ln]
    for ln in ptxas:
        say("2 build", ln)
    entries = [ln for ln in ptxas if "entry function" in ln]
    say("2 build", f"{built.path.name}: {len(entries)} kernels, nvcc "
        f"{built.seconds:.1f} s, load {wall:.1f} s")
    flash = flash_bf16_ptxas(built.log)
    for (hdp, lse), info in flash.items():
        flash[hdp, lse] = (f"{info}; dynamic shared memory "
                           f"{built.lib.flash_attention_bf16_smem(hdp)} "
                           f"bytes")
        say("2 build", f"flash bf16 HDP={hdp}{' with lse2' * lse}: "
            f"{flash[hdp, lse]}")
    serialized = [ln.strip() for ln in built.log.splitlines()
                  if "wgmma" in ln and "serialized" in ln]
    for ln in serialized:
        say("2 build", ln)
    if built.seconds > 0:            # a reused library printed no log
        check(len(entries) == PTXAS_ENTRIES,
              f"ptxas compiled {len(entries)} kernels, expected "
              f"{PTXAS_ENTRIES}")
        check(len(flash) == 6 and not serialized,
              f"flash bf16 instances {sorted(flash)}; wgmma serialized: "
              f"{serialized}")
    return dict(nvcc_seconds=built.seconds, load_seconds=wall, ptxas=ptxas,
                flash_bf16={f"{h}{' lse2' * l}": v
                            for (h, l), v in flash.items()})


def flash_bf16_ptxas(log):
    """{(padded head dim, writes lse2): "registers, shared memory,
    spills"} of the flash kernel's bf16 instances, from the -Xptxas -v
    log."""
    lines, out = log.splitlines(), {}
    for n, ln in enumerate(lines):
        if "entry function" in ln and "flash_bf16_kernel" in ln:
            args = ln.split("flash_bf16_kernelILi")[1]
            hdp = int(args.split("E")[0])
            out[hdp, "ELb1E" in args] = "; ".join(
                x.strip().replace("ptxas info    : ", "")
                for x in lines[n + 1:n + 4]
                if "spill" in x or "registers" in x)
    return out


def _seed(k, dev):
    return torch.tensor([k], dtype=torch.int32, device=dev)


def packed(args):
    """A MIN-Gibbs or DoubleMIN kernel's arguments from its plain
    version's (``parity_inputs.packed_args``)."""
    from repro_torch.kernels.parity_inputs import packed_args
    return packed_args(args)


def packed_mgpmh(args):
    """An MGPMH kernel's arguments from its plain version's: the row
    tables packed (``parity_inputs.packed_mgpmh_args``)."""
    from repro_torch.kernels.parity_inputs import packed_mgpmh_args
    return packed_mgpmh_args(args)


def _equal(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(p, q) for p, q in zip(a, b))


def first_differing_substep(run, S):
    """Smallest s such that the kernel and the plain version differ after
    the first s sub-steps (``run(s) -> (kernel_out, plain_out)``): the
    streams of a sub-step do not depend on S, so a truncated call replays
    the same draws."""
    for s in range(1, S + 1):
        if not _equal(*run(s)):
            return s
    return None


def rng_parity(name, kernel, plain, args, per_step, shape, dev):
    """An in-kernel-RNG kernel against its plain version, seeds 0, 1 and
    2^31-1: exactly equal, else the seed, shape and first differing
    sub-step are printed and the phase fails.  ``per_step``: positions of
    the (C, S, ...) inputs (sites, Poisson totals)."""
    S = args[per_step[0]].shape[1]
    for seed in SEEDS:
        sd = _seed(seed, dev)

        def run(s):
            a = tuple(v[:, :s].contiguous() if j in per_step else v
                      for j, v in enumerate(args))
            out = kernel(a, sd), plain(a, sd)
            torch.cuda.synchronize()
            return out

        if not _equal(*run(S)):
            fail(f"{name} kernel != plain version at shape {shape}, seed "
                 f"{seed}, first differing sub-step "
                 f"{first_differing_substep(run, S)}")


def phase_parity(dev):
    """Kernels vs plain versions at the test shapes: exactly equal."""
    from repro_torch.kernels import fused_sweep as fs, parity_inputs as pin
    from repro_torch.kernels import ref
    t = lambda arrays: tuple(torch.from_numpy(a).to(dev) for a in arrays)
    for (C, S, K, D, n) in PARITY_MGPMH:
        args = t(pin.mgpmh_inputs(C, S, K, D, n))
        xk, ak = fs.mgpmh_sweep_cuda(*packed_mgpmh(args), D=D, scale=0.7)
        xr, ar = ref.mgpmh_sweep_ref(*args, D, 0.7)
        torch.cuda.synchronize()
        check(torch.equal(xk, xr) and torch.equal(ak, ar),
              f"mgpmh kernel != plain version at (C,S,K,D,n)="
              f"{(C, S, K, D, n)}")
        rng_parity("mgpmh_sweep_rng",
                   lambda a, sd: fs.mgpmh_sweep_rng_cuda(
                       *packed_mgpmh(a), sd, D=D, scale=0.7, K=K),
                   lambda a, sd: ref.mgpmh_sweep_rng_ref(*a, sd, D, 0.7, K),
                   tuple(args[:6]), (4, 5), (C, S, K, D, n), dev)
    mgpmh_edge_parity(dev)
    for (C, S, D, n) in PARITY_GIBBS:
        args = t(pin.gibbs_inputs(C, S, D, n))
        xk = fs.gibbs_sweep_cuda(*args, D=D)
        torch.cuda.synchronize()
        check(torch.equal(xk, ref.gibbs_sweep_ref(*args, D)),
              f"gibbs kernel != plain version at (C,S,D,n)={(C, S, D, n)}")
    ring_parity(dev)
    class_parity(dev)
    for shape in PARITY_MIN:
        C, S, K, D, n = shape
        args = t(pin.min_gibbs_inputs(*shape))
        check(_equal(fs.min_gibbs_sweep_cuda(*packed(args), D=D,
                                             lscale=0.37),
                     ref.min_gibbs_sweep_ref(*args, D, 0.37)),
              f"min_gibbs kernel != plain version at (C,S,K,D,n)={shape}")
        head = args[:7] + (args[-1],)          # x, tables, i, B, cache
        rng_parity("min_gibbs_sweep_rng",
                   lambda a, sd: fs.min_gibbs_sweep_rng_cuda(
                       *packed(a), sd, D=D, lscale=0.37, K=K),
                   lambda a, sd: ref.min_gibbs_sweep_rng_ref(
                       *a, sd, D, 0.37, K), head, (5, 6), shape, dev)
    for shape in PARITY_DMIN:
        C, S, K1, K2, D, n = shape
        args = t(pin.double_min_inputs(*shape))
        check(_equal(fs.double_min_sweep_cuda(*packed(args), D=D, scale1=0.7,
                                              lscale2=0.31),
                     ref.double_min_sweep_ref(*args, D, 0.7, 0.31)),
              f"double_min kernel != plain version at "
              f"(C,S,K1,K2,D,n)={shape}")
        head = args[:7] + (args[10], args[-1])  # x, tables, i, B1, B2, cache
        rng_parity("double_min_sweep_rng",
                   lambda a, sd: fs.double_min_sweep_rng_cuda(
                       *packed(a), sd, D=D, scale1=0.7, lscale2=0.31, K1=K1,
                       K2=K2),
                   lambda a, sd: ref.double_min_sweep_rng_ref(
                       *a, sd, D, 0.7, 0.31, K1, K2), head, (5, 6, 7),
                   shape, dev)
    split_parity(dev)
    from repro_torch.kernels import local_sweep as ls
    for shape in PARITY_LOCAL:
        C, S, B, D, n = shape
        scale = (n - 1) / B
        for weights in ("real", "integer"):
            rng_parity("local_gibbs_sweep",
                       lambda a, sd: ls.local_gibbs_sweep_cuda(
                           *a, sd, B=B, D=D, scale=scale),
                       lambda a, sd: ref.local_gibbs_sweep_ref(
                           *a, sd, B, D, scale),
                       t(pin.local_gibbs_inputs(C, S, D, n, weights)), (2,),
                       shape, dev)
    stale = local_recomputes(dev)
    ood_parity(dev)
    transform = transform_check(dev)
    torch.cuda.synchronize()
    say("3a parity", f"{len(PARITY_MGPMH)} mgpmh + {len(PARITY_MGPMH_EDGE)} "
        f"mgpmh edge shapes {PARITY_MGPMH_EDGE} (both forms, twice) + "
        f"{len(PARITY_GIBBS)} gibbs "
        f"+ {len(PARITY_RING)} gibbs ring shapes {PARITY_RING} (twice) + "
        f"gibbs_class_sweep at {PARITY_CLASS} (every class, twice) "
        f"+ {len(PARITY_MIN)} min-gibbs + {len(PARITY_DMIN)} doublemin "
        f"shapes: kernel == plain version exactly (x, cache, accepts); the "
        f"3 in-kernel-RNG kernels == their plain versions exactly at the "
        f"same shapes for seeds {list(SEEDS)}; both forms of min-gibbs "
        f"{SPLIT_MIN} and doublemin {SPLIT_DMIN} (totals at 0 and at "
        f"capacity) exactly, twice; "
        f"local_gibbs_sweep == its "
        f"plain version exactly at {len(PARITY_LOCAL)} shapes (C,S,B,D,n) "
        f"{PARITY_LOCAL}, real and integer weights, seeds {list(SEEDS)}; "
        f"at {PARITY_LOCAL_STALE} the consumer recomputed {stale} of "
        f"{PARITY_LOCAL_STALE[0] * PARITY_LOCAL_STALE[1]} sub-steps in each "
        f"of two launches with the same bits; the class kernel's Gumbel "
        f"transform == gumbel_from_uniform on all {transform} float32 "
        f"values in [0, 1], 0 differing")


def local_recomputes(dev):
    """The local sweep at the shape where nearly every check of its
    consumer fails, launched twice: the same bits (the plain version's),
    recompute counts not all zero and at most S a chain.  Returns the two
    launches' totals."""
    from repro_torch.kernels import local_sweep as ls, ref
    from repro_torch.kernels import parity_inputs as pin
    C, S, B, D, n = PARITY_LOCAL_STALE
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in pin.local_gibbs_inputs(C, S, D, n))
    sd = _seed(0, dev)
    want = ref.local_gibbs_sweep_ref(*args, sd, B, D, (n - 1) / B)
    totals = []
    for _ in range(2):
        n_re = torch.full((C,), -1, dtype=torch.int32, device=dev)
        got = ls.local_gibbs_sweep_cuda(*args, sd, B=B, D=D,
                                        scale=(n - 1) / B, recomputed=n_re)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"local_gibbs_sweep at "
              f"{PARITY_LOCAL_STALE}: a launch differs from the plain version")
        check(bool(((n_re >= 0) & (n_re <= S)).all()),
              f"local_gibbs_sweep recompute counts {n_re.tolist()} outside "
              f"[0, S={S}]")
        totals.append(int(n_re.sum()))
    check(max(totals) > 0, f"local_gibbs_sweep at {PARITY_LOCAL_STALE}: no "
          f"sub-step recomputed in two launches")
    return totals


def ood_parity(dev):
    """Every sampling kernel against its plain version on a state holding
    codes outside [0, D) at sites the first sub-step updates (chain 0 the
    supervisor's nan-x code, chain 1 D + 3): exactly equal.  A code counts
    nowhere, and the site keeps it unless it takes a proposal."""
    from repro_torch.kernels import fused_sweep as fs, local_sweep as ls
    from repro_torch.kernels import parity_inputs as pin, ref
    t = lambda arrays: tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def corrupt(args, at, D):
        x, i = args[0].clone(), args[at]
        x[0, int(i[0, 0])] = OOD_CODE
        x[1, int(i[1, 0])] = D + 3
        return (x,) + tuple(args[1:])

    C, S, K, D, n = PARITY_MGPMH[0]
    args = corrupt(t(pin.mgpmh_inputs(C, S, K, D, n)), 4, D)
    check(_equal(fs.mgpmh_sweep_cuda(*packed_mgpmh(args), D=D, scale=0.7),
                 ref.mgpmh_sweep_ref(*args, D, 0.7)),
          "mgpmh kernel != plain version with codes outside [0, D)")
    rng_parity("mgpmh_sweep_rng (codes outside [0, D))",
               lambda a, sd: fs.mgpmh_sweep_rng_cuda(
                   *packed_mgpmh(a), sd, D=D, scale=0.7, K=K),
               lambda a, sd: ref.mgpmh_sweep_rng_ref(*a, sd, D, 0.7, K),
               tuple(args[:6]), (4, 5), (C, S, K, D, n), dev)
    C, S, D, n = PARITY_GIBBS[0]
    args = corrupt(t(pin.gibbs_inputs(C, S, D, n)), 2, D)
    check(_equal(fs.gibbs_sweep_cuda(*args, D=D),
                 ref.gibbs_sweep_ref(*args, D)),
          "gibbs kernel != plain version with codes outside [0, D)")
    shape = PARITY_MIN[0]
    C, S, K, D, n = shape
    args = corrupt(t(pin.min_gibbs_inputs(*shape)), 5, D)
    check(_equal(fs.min_gibbs_sweep_cuda(*packed(args), D=D, lscale=0.37),
                 ref.min_gibbs_sweep_ref(*args, D, 0.37)),
          "min_gibbs kernel != plain version with codes outside [0, D)")
    rng_parity("min_gibbs_sweep_rng (codes outside [0, D))",
               lambda a, sd: fs.min_gibbs_sweep_rng_cuda(
                   *packed(a), sd, D=D, lscale=0.37, K=K),
               lambda a, sd: ref.min_gibbs_sweep_rng_ref(*a, sd, D, 0.37,
                                                         K),
               args[:7] + (args[-1],), (5, 6), shape, dev)
    shape = PARITY_DMIN[0]
    C, S, K1, K2, D, n = shape
    args = corrupt(t(pin.double_min_inputs(*shape)), 5, D)
    check(_equal(fs.double_min_sweep_cuda(*packed(args), D=D, scale1=0.7,
                                          lscale2=0.31),
                 ref.double_min_sweep_ref(*args, D, 0.7, 0.31)),
          "double_min kernel != plain version with codes outside [0, D)")
    rng_parity("double_min_sweep_rng (codes outside [0, D))",
               lambda a, sd: fs.double_min_sweep_rng_cuda(
                   *packed(a), sd, D=D, scale1=0.7, lscale2=0.31, K1=K1,
                   K2=K2),
               lambda a, sd: ref.double_min_sweep_rng_ref(
                   *a, sd, D, 0.7, 0.31, K1, K2),
               args[:7] + (args[10], args[-1]), (5, 6, 7), shape, dev)
    C, S, B, D, n = PARITY_LOCAL[0]
    rng_parity("local_gibbs_sweep (codes outside [0, D))",
               lambda a, sd: ls.local_gibbs_sweep_cuda(
                   *a, sd, B=B, D=D, scale=(n - 1) / B),
               lambda a, sd: ref.local_gibbs_sweep_ref(*a, sd, B, D,
                                                       (n - 1) / B),
               corrupt(t(pin.local_gibbs_inputs(C, S, D, n)), 2, D), (2,),
               (C, S, B, D, n), dev)
    torch.cuda.synchronize()
    say("3a parity", f"codes outside [0, D) ({OOD_CODE} and D + 3) at "
        f"sites the first sub-step updates: mgpmh (both forms), gibbs, "
        f"min-gibbs and doublemin (both forms), local-gibbs == their plain "
        f"versions exactly")


def ring_inputs(C, S, D, n, dev):
    """(x, W, i_sites, gumbel) of a Gibbs ring shape on the card, chain 0's
    first three values outside [0, D); the chunked-ring sizes draw W
    (2.2 GB) on the card (``tests/test_torch_sweep.py::_ring_inputs``)."""
    from repro_torch.kernels import parity_inputs as pin
    if n < CHUNKED_N:
        x, W, i, g = (torch.from_numpy(a).to(dev)
                      for a in pin.gibbs_inputs(C, S, D, n))
    else:
        gen = torch.Generator(device=dev).manual_seed(n + D)
        W = torch.rand((n, n), generator=gen, device=dev)
        x = torch.randint(0, D, (C, n), generator=gen, device=dev,
                          dtype=torch.int32)
        i = torch.randint(0, n, (C, S), generator=gen, device=dev,
                          dtype=torch.int32)
        u = torch.rand((C, S, D), generator=gen, device=dev)
        g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    x[0, :3] = torch.tensor([-1, D, D + 5], dtype=torch.int32)
    return x, W, i, g


def ring_parity(dev):
    """The Gibbs kernel at the ring shapes: the planned ring (chunked
    exactly where n >= CHUNKED_N), twice the same bits, equal to the plain
    version."""
    from repro_torch.kernels import fused_sweep as fs, ref
    for shape in PARITY_RING:
        C, S, D, n = shape
        plan = fs.gibbs_ring_plan(n, D)
        check((plan["chunks"] > 1) == (n >= CHUNKED_N),
              f"gibbs ring plan {plan} at n={n}")
        x, W, i, g = ring_inputs(C, S, D, n, dev)
        outs = [fs.gibbs_sweep_cuda(x, W, i, g, D=D) for _ in range(2)]
        want = ref.gibbs_sweep_ref(x, W, i, g, D)
        torch.cuda.synchronize()
        check(torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want),
              f"gibbs kernel != plain version at ring shape (C,S,D,n)="
              f"{shape}, plan {plan}")
        say("3a parity", f"gibbs ring shape {shape}: plan {plan}")
        del x, W, i, g, outs, want
        torch.cuda.empty_cache()


def mgpmh_edge_parity(dev):
    """Both MGPMH kernels at the edge shapes (``mgpmh_edge_inputs``): the
    planned ring (chunked exactly where n >= CHUNKED_N), twice the same
    bits, equal to the plain versions (the Philox form for every seed)."""
    from repro_torch.kernels import fused_sweep as fs, parity_inputs as pin
    from repro_torch.kernels import ref
    for shape in PARITY_MGPMH_EDGE:
        C, S, K, D, n = shape
        plan = fs.mgpmh_ring_plan(n, D)
        check((plan["chunks"] > 1) == (n >= CHUNKED_N),
              f"mgpmh ring plan {plan} at n={n}")
        args = pin.mgpmh_edge_inputs(C, S, K, D, n, dev)
        kargs = packed_mgpmh(args)
        outs = [fs.mgpmh_sweep_cuda(*kargs, D=D, scale=0.7)
                for _ in range(2)]
        want = ref.mgpmh_sweep_ref(*args, D, 0.7)
        torch.cuda.synchronize()
        check(all(_equal(o, want) for o in outs),
              f"mgpmh kernel != plain version at edge shape (C,S,K,D,n)="
              f"{shape}, plan {plan}")
        for sd in SEEDS:
            seed = _seed(sd, dev)
            outs = [fs.mgpmh_sweep_rng_cuda(*kargs[:5], seed, D=D, scale=0.7,
                                            K=K) for _ in range(2)]
            want = ref.mgpmh_sweep_rng_ref(*args[:6], seed, D, 0.7, K)
            torch.cuda.synchronize()
            check(all(_equal(o, want) for o in outs),
                  f"mgpmh_sweep_rng != plain version at edge shape "
                  f"(C,S,K,D,n)={shape}, seed {sd}")
        say("3a parity", f"mgpmh edge shape {shape}: plan {plan}")
        del args, kargs, outs, want
        torch.cuda.empty_cache()


def class_parity(dev):
    """The class kernel on every class of each PARITY_CLASS graph, fed
    uniforms: twice the same bits, equal to its plain version and to the
    sequential plain version fed their Gumbels."""
    from repro_torch.core.factor_graph import MatchGraph
    from repro_torch.kernels import chromatic_sweep as chs, ref
    from repro_torch.kernels import parity_inputs as pin
    for kind, size, weights, D, C in PARITY_CLASS:
        W, colors = pin.class_graph(kind, size, weights)
        g = MatchGraph.from_interactions(W.astype(np.float64),
                                         match_weight_scale=1.0, D=D,
                                         device=dev)
        nbr = g.nbr_pack
        for k in range(int(colors.max()) + 1):
            sites = np.flatnonzero(colors == k)
            x, st, _, u = (torch.from_numpy(a).to(dev) for a in
                           pin.gibbs_class_inputs(C, D, g.n, sites, k))
            outs = [chs.gibbs_class_sweep_cuda(x.clone(), *nbr, st, u, D=D)
                    for _ in range(2)]
            gum = ref.gumbel_from_uniform(u.clone())
            want = ref.gibbs_class_sweep_ref(x, g.W, st, gum, D)
            seq = ref.gibbs_sweep_ref(x, g.W, st.expand(C, -1).contiguous(),
                                      gum, D)
            torch.cuda.synchronize()
            check(torch.equal(outs[0], outs[1])
                  and torch.equal(outs[0], want) and torch.equal(want, seq),
                  f"gibbs_class_sweep != plain versions on {kind} {size} "
                  f"{weights} D={D}, class {k}")


def transform_check(dev, chunk=1 << 26):
    """The class kernel's in-kernel Gumbel transform against
    ``ref.gumbel_from_uniform`` (``samplers.gumbel``'s operations) on every
    float32 bit pattern in [0, 1], in chunks: fails if any value differs in
    a bit.  Returns the number of values compared."""
    from repro_torch.kernels import chromatic_sweep as chs, ref
    top = int(np.float32(1.0).view(np.int32))
    differing = 0
    for lo in range(0, top + 1, chunk):
        u = torch.arange(lo, min(lo + chunk, top + 1), dtype=torch.int32,
                         device=dev).view(torch.float32)
        got = chs.gumbel_from_uniform_cuda(u)
        want = ref.gumbel_from_uniform(u.clone())
        differing += int((got.view(torch.int32)
                          != want.view(torch.int32)).sum())
    check(differing == 0, f"the class kernel's Gumbel transform differs "
          f"from gumbel_from_uniform on {differing} of {top + 1} float32 "
          f"values in [0, 1]")
    return top + 1


def split_parity(dev):
    """MIN-Gibbs and DoubleMIN at the SPLIT shapes, Poisson totals forced
    to 0 and to capacity in some rows (``parity_inputs.edge_totals``): each
    form equals its plain version bit for bit, on two launches."""
    from repro_torch.kernels import fused_sweep as fs, parity_inputs as pin
    from repro_torch.kernels import ref
    t = lambda arrays: tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def twice(name, launch, want, seed=None):
        first, again = launch(), launch()
        torch.cuda.synchronize()
        check(_equal(first, want) and _equal(again, want),
              f"{name} at seed {seed}: kernel != plain version (or two "
              f"launches differ)")

    C, S, K, D, n = SPLIT_MIN
    arrays = list(pin.min_gibbs_inputs(*SPLIT_MIN))
    arrays[6] = pin.edge_totals(arrays[6], K)
    args = t(arrays)
    kargs, head = packed(args), args[:7] + (args[-1],)
    want = ref.min_gibbs_sweep_ref(*args, D, 0.37)
    rng_want = {sd: ref.min_gibbs_sweep_rng_ref(*head, _seed(sd, dev), D,
                                                0.37, K) for sd in SEEDS}
    twice("min_gibbs_sweep", lambda: fs.min_gibbs_sweep_cuda(
        *kargs, D=D, lscale=0.37), want)
    for sd in SEEDS:
        twice("min_gibbs_sweep_rng", lambda: fs.min_gibbs_sweep_rng_cuda(
            *kargs[:5], args[-1], _seed(sd, dev), D=D, lscale=0.37, K=K),
            rng_want[sd], sd)
    C, S, K1, K2, D, n = SPLIT_DMIN
    arrays = list(pin.double_min_inputs(*SPLIT_DMIN))
    arrays[6] = pin.edge_totals(arrays[6], K1)
    arrays[10] = pin.edge_totals(arrays[10], K2)
    args = t(arrays)
    kargs, head = packed(args), args[:7] + (args[10], args[-1])
    want = ref.double_min_sweep_ref(*args, D, 0.7, 0.31)
    rng_want = {sd: ref.double_min_sweep_rng_ref(
        *head, _seed(sd, dev), D, 0.7, 0.31, K1, K2) for sd in SEEDS}
    twice("double_min_sweep", lambda: fs.double_min_sweep_cuda(
        *kargs, D=D, scale1=0.7, lscale2=0.31), want)
    for sd in SEEDS:
        twice("double_min_sweep_rng", lambda: fs.double_min_sweep_rng_cuda(
            *kargs[:5], args[10], args[-1], _seed(sd, dev), D=D, scale1=0.7,
            lscale2=0.31, K1=K1, K2=K2), rng_want[sd], sd)


def bucket_inputs(C, K, D, weights, dev, seed):
    """w (C, K) float32 (integers in [-8, 8], where every summation order
    is exact, or N(0, 1)) and v (C, K) int32 in [0, D), from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if weights == "integer":
        w = torch.randint(-8, 9, (C, K), generator=gen, device=dev).float()
    else:
        w = torch.randn((C, K), generator=gen, device=dev)
    v = torch.randint(0, D, (C, K), generator=gen, device=dev,
                      dtype=torch.int32)
    return w, v


def bucket_close(got, want):
    """The tolerance of tests/test_kernels.py for real weights, where the
    kernel sums in another order than the plain version's einsum."""
    return torch.allclose(got, want, rtol=1e-5, atol=1e-4)


def phase_bucket_parity(dev):
    """The bucket-energy kernel against its plain version at every shape of
    BUCKET_SHAPES: bit-equal at integer weights, within tolerance at real
    weights, the same bits on a second launch; out-of-range values and an
    f16 input through ``ops.bucket_energy``."""
    from repro_torch.kernels import minibatch_energy as me, ops, ref
    err = 0.0
    for k, (C, K, D) in enumerate(BUCKET_SHAPES):
        for weights in ("integer", "normal"):
            w, v = bucket_inputs(C, K, D, weights, dev, seed=k)
            got = me.bucket_energy_cuda(w, v, D)
            again = me.bucket_energy_cuda(w, v, D)
            want = ref.bucket_energy_ref(w, v, D)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"bucket_energy at (C,K,D)="
                  f"{(C, K, D)}: two launches gave different bits")
            if weights == "integer":
                check(torch.equal(got, want), f"bucket_energy != plain "
                      f"version at integer weights, (C,K,D)={(C, K, D)}")
            else:
                err = max(err, float((got - want).abs().max()))
                check(bucket_close(got, want), f"bucket_energy off the "
                      f"plain version at (C,K,D)={(C, K, D)}: max abs err "
                      f"{float((got - want).abs().max())}")
    w = torch.ones((1, 4), device=dev)
    v = torch.tensor([[0, 1, 5, 9]], dtype=torch.int32, device=dev)
    got = ops.bucket_energy(w, v, 3)
    check(got.tolist() == [[1.0, 1.0, 0.0]]
          and torch.equal(got, ref.bucket_energy_ref(w, v, 3)),
          f"bucket_energy: values >= D landed in a bucket: {got.tolist()}")
    w, v = bucket_inputs(4, 64, 8, "normal", dev, seed=99)
    got = ops.bucket_energy(w.half(), v.long(), 8)
    want = ref.bucket_energy_ref(w.half().float(), v, 8)
    check(got.dtype == torch.float32 and bucket_close(got, want),
          "bucket_energy on f16 weights off the plain version")
    say("3c bucket energy", f"{len(BUCKET_SHAPES)} shapes: kernel == plain "
        f"version bit for bit at integer weights, max abs err {err:.3g} at "
        f"N(0,1) weights (rtol 1e-5, atol 1e-4), same bits on a second "
        f"launch; values >= D land nowhere; f16 weights cast up")
    return dict(shapes=BUCKET_SHAPES, max_abs_err=err)


def build_graphs(dev):
    from repro_torch.core import engine
    t0 = time.perf_counter()
    potts = engine.make_workload("potts-64x64", device=dev).graph
    _ = potts.row_pack                       # the lazy packed row tables
    t1 = time.perf_counter()
    lattice = engine.make_workload("lattice-ising-64x64", device=dev)
    t2 = time.perf_counter()
    _ = potts.pair_prob          # the flat factor table the cache init reads
    t3 = time.perf_counter()
    say("graphs", f"potts-64x64 n={potts.n} D={potts.D} L={potts.L:.4f} "
        f"psi={potts.psi:.1f} delta={potts.delta} built in {t1 - t0:.1f} s; "
        f"lattice-ising-64x64 n={lattice.graph.n} built in {t2 - t1:.1f} s; "
        f"potts-64x64 flat pair table (F={potts.num_factors}) built in "
        f"{t3 - t2:.1f} s")
    return potts, lattice, t3 - t2


def mgpmh_inputs(graph, C, S, seed):
    from repro_torch.core import samplers
    from repro_torch.core.estimators import recommended_capacity
    lam = 4.0 * graph.L ** 2
    K = recommended_capacity(lam)
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    x = torch.randint(0, graph.D, (C, graph.n), generator=gen,
                      device=graph.device, dtype=torch.int32)
    draws = samplers.mgpmh_draws(gen, graph, C, S,
                                 samplers.mgpmh_rate(graph, lam), K)
    args = (x, graph.W, graph.row_prob, graph.row_alias, *draws)
    return args, dict(D=graph.D, scale=graph.L / lam), lam, K


def mgpmh_kargs(args, graph):
    """An MGPMH kernel's arguments from the plain version's (x, W,
    row_prob, row_alias, ...), whose tables are the graph's views of its
    packed records: the packed table itself, no copy."""
    pack = graph.row_pack
    check(args[2].data_ptr() == pack.data_ptr()
          and args[3].data_ptr() == pack.data_ptr() + 4,
          "mgpmh_kargs takes the graph's row-table views")
    return (args[0], args[1], pack, *args[4:])


def gather_probe(records, dev):
    """CUDA-event ms of ``torch.take`` of ``records`` random 8-byte records
    from a 128 MiB table (the card's random-gather rate, PERF.md PR 17)."""
    table = torch.arange(16 << 20, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    idx = torch.randint(0, table.numel(), (records,), generator=gen,
                        device=dev)
    ms, got = timed(lambda: torch.take(table, idx), 5)
    check(torch.equal(got, idx), "the gather probe read wrong records")
    return ms


def gather_floor(B):
    """The MGPMH call's live draws (the Poisson totals' sum), the bytes of
    one 32-byte sector per draw, and the time of as many random 8-byte
    record gathers (``gather_probe``): a floor of the draws beside the
    byte bound, which counts each distinct record once."""
    live = int(B.long().sum())
    return dict(live_draws=live, draw_sector_bytes=32 * live,
                gather_probe_ms=gather_probe(live, B.device))


def gibbs_inputs(graph, C, S, seed):
    """Inputs of one Gibbs sweep call."""
    from repro_torch.core import samplers
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    x = torch.randint(0, graph.D, (C, graph.n), generator=gen,
                      device=graph.device, dtype=torch.int32)
    i, g = samplers.gibbs_draws(gen, C, S, graph.n, graph.D, graph.device)
    return (x, graph.W, i, g)


def min_gibbs_inputs(graph, C, S, seed):
    """Inputs of one MIN-Gibbs sweep call at the engine defaults."""
    from repro_torch.core import samplers
    from repro_torch.core.estimators import (min_gibbs_lscale,
                                             recommended_capacity)
    lam = min(2.0 * graph.psi ** 2, 16384.0)
    K = recommended_capacity(lam)
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    st = samplers.init_state(gen, graph, C, start="random")
    st = samplers.init_min_gibbs_cache(gen, graph, st, lam, K)
    npb, nab = samplers._node_alias_table(graph)
    draws = samplers.min_gibbs_draws(gen, graph, C, S, lam, K)
    args = (st.x, npb, nab, graph.row_prob, graph.row_alias, *draws,
            st.cache)
    return args, dict(D=graph.D, lscale=min_gibbs_lscale(graph.psi, lam)), K


def double_min_inputs(graph, C, S, seed):
    """Inputs of one DoubleMIN sweep call at the engine defaults."""
    from repro_torch.core import samplers
    from repro_torch.core.estimators import (min_gibbs_lscale,
                                             recommended_capacity)
    lam1 = 4.0 * graph.L ** 2
    lam2 = min(2.0 * graph.psi ** 2, 16384.0)
    K1, K2 = recommended_capacity(lam1), recommended_capacity(lam2)
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    st = samplers.init_state(gen, graph, C, start="random")
    st = samplers.init_min_gibbs_cache(gen, graph, st, lam2, K2)
    npb, nab = samplers._node_alias_table(graph)
    draws = samplers.double_min_draws(gen, graph, C, S, lam1, K1, lam2, K2)
    args = (st.x, graph.row_prob, graph.row_alias, npb, nab, *draws,
            st.cache)
    kw = dict(D=graph.D, scale1=graph.L / lam1,
              lscale2=min_gibbs_lscale(graph.psi, lam2))
    return args, kw, K1, K2


def rng_view(kind, args, kw, K):
    """The in-kernel-RNG form of a host-stream argument list: drop the
    streams, add nothing but the seed (given at the call)."""
    if kind == "mgpmh":
        return args[:6], dict(kw, K=K)
    if kind == "min_gibbs":
        return args[:7] + (args[-1],), dict(kw, K=K)
    K1, K2 = K
    return args[:7] + (args[10], args[-1]), dict(kw, K1=K1, K2=K2)


def compare(name, out_k, out_p, C, exact=False, phase="3b full width"):
    """(differing chains, max abs err) of kernel vs plain outputs."""
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    differ = torch.zeros(C, dtype=torch.bool, device=outs_k[0].device)
    err = 0.0
    for a, b in zip(outs_k, outs_p):
        d = (a != b)
        differ |= d if d.dim() == 1 else d.any(dim=1)
        err = max(err, float((a.double() - b.double()).abs().max()))
    n_diff = int(differ.sum())
    say(phase, f"{name}: {n_diff}/{C} chains differ from the "
        f"plain version, max abs err {err}")
    if exact:
        check(n_diff == 0, f"{name}: {n_diff} of {C} chains differ "
              f"(must be exactly equal)")
    check(n_diff <= 0.01 * C, f"{name}: {n_diff} of {C} chains differ "
          f"(tolerance 1%)")
    return n_diff, err


def phase_full_width(potts, lattice):
    from repro_torch.kernels import fused_sweep as fs, ref
    out = {}
    args, kw, lam, K = mgpmh_inputs(potts, C_FULL, S_FULL, seed=1)
    say("3b full width", f"mgpmh lam={lam:.2f} capacity K={K} "
        f"mean B={float(args[5].float().mean()):.2f}")
    check(K == 201, f"capacity {K} != 201 at potts-64x64's default lambda")
    out["mgpmh_sweep"] = compare(
        "mgpmh_sweep", fs.mgpmh_sweep_cuda(*mgpmh_kargs(args, potts), **kw),
        ref.mgpmh_sweep_ref(*args, kw["D"], kw["scale"]), C_FULL)
    a, k = rng_view("mgpmh", args, kw, K)
    sd = _seed(11, potts.device)
    out["mgpmh_sweep_rng"] = compare(
        "mgpmh_sweep_rng",
        fs.mgpmh_sweep_rng_cuda(*mgpmh_kargs(a, potts), sd, **k),
        ref.mgpmh_sweep_rng_ref(*a, sd, k["D"], k["scale"], K), C_FULL)
    args = gibbs_inputs(potts, C_FULL, S_FULL, seed=2)
    out["gibbs_sweep"] = compare(
        "gibbs_sweep", fs.gibbs_sweep_cuda(*args, D=potts.D),
        ref.gibbs_sweep_ref(*args, potts.D), C_FULL)
    out["gibbs_class_sweep"] = class_full_width(lattice)
    C, S = FULL_MIN
    args, kw, K = min_gibbs_inputs(potts, C, S, seed=8)
    lscale = kw["lscale"]
    say("3b full width", f"min-gibbs lam=16384 capacity K={K} "
        f"lscale={lscale:.5f} C={C} S={S} mean B="
        f"{float(args[6].float().mean()):.1f}")
    check(K == 17188, f"capacity {K} != 17188 at lam=16384")
    out["min_gibbs_sweep"] = compare(
        "min_gibbs_sweep", fs.min_gibbs_sweep_cuda(*packed(args), **kw),
        ref.min_gibbs_sweep_ref(*args, kw["D"], lscale), C, exact=True)
    a, k = rng_view("min_gibbs", args, kw, K)
    del args
    sd = _seed(12, potts.device)
    out["min_gibbs_sweep_rng"] = compare(
        "min_gibbs_sweep_rng",
        fs.min_gibbs_sweep_rng_cuda(*packed(a), sd, **k),
        ref.min_gibbs_sweep_rng_ref(*a, sd, k["D"], lscale, K), C)
    C, S = FULL_DMIN
    args, kw, K1, K2 = double_min_inputs(potts, C, S, seed=9)
    say("3b full width", f"doublemin K1={K1} K2={K2} C={C} S={S}")
    out["double_min_sweep"] = compare(
        "double_min_sweep", fs.double_min_sweep_cuda(*packed(args), **kw),
        ref.double_min_sweep_ref(*args, kw["D"], kw["scale1"],
                                 kw["lscale2"]), C, exact=True)
    a, k = rng_view("double_min", args, kw, (K1, K2))
    del args
    sd = _seed(13, potts.device)
    out["double_min_sweep_rng"] = compare(
        "double_min_sweep_rng",
        fs.double_min_sweep_rng_cuda(*packed(a), sd, **k),
        ref.double_min_sweep_rng_ref(*a, sd, k["D"], k["scale1"],
                                     k["lscale2"], K1, K2), C)
    from repro_torch.kernels import local_sweep as ls
    worst = (0, 0.0)
    for B in LOCAL_B:
        # every chain exactly, and a second launch with the same bits
        # (its consumer may recompute other sub-steps)
        (x, i), kw = local_inputs(potts, B, seed=14)
        sd = _seed(15, potts.device)
        got = ls.local_gibbs_sweep_cuda(x, potts.W, i, sd, **kw)
        again = ls.local_gibbs_sweep_cuda(x, potts.W, i, sd, **kw)
        diff = compare(f"local_gibbs_sweep B={B}", got,
                       ref.local_gibbs_sweep_ref(x, potts.W, i, sd, kw["B"],
                                                 kw["D"], kw["scale"]),
                       C_FULL, exact=True)
        compare(f"local_gibbs_sweep B={B}, a second launch", again, got,
                C_FULL, exact=True)
        out[f"local_gibbs_sweep B={B}"] = diff
        worst = max(worst, diff)
    out["local_gibbs_sweep"] = worst
    torch.cuda.empty_cache()
    return out


def class_full_width(lattice):
    """Both classes of lattice-ising-64x64 at C=256 through the class
    kernel fed uniforms, in color order, against its plain version and the
    sequential plain version fed their Gumbels: no chain may differ (all
    weights are 0.8, and any order of summing at most four of them gives
    the same float)."""
    from repro_torch.kernels import chromatic_sweep as chs, ref
    graph = lattice.graph
    gen = torch.Generator(device=graph.device).manual_seed(3)
    x = torch.randint(0, graph.D, (C_FULL, graph.n), generator=gen,
                      device=graph.device, dtype=torch.int32)
    nbr = graph.nbr_pack
    worst = (0, 0.0)
    for k in range(2):
        sites = torch.as_tensor(np.flatnonzero(lattice.colors == k),
                                dtype=torch.int32, device=graph.device)
        u = torch.rand((C_FULL, sites.numel(), graph.D), generator=gen,
                       device=graph.device)
        g = ref.gumbel_from_uniform(u.clone())
        xk = chs.gibbs_class_sweep_cuda(x.clone(), *nbr, sites, u,
                                        D=graph.D)
        want = ref.gibbs_class_sweep_ref(x, graph.W, sites, g, graph.D)
        seq = ref.gibbs_sweep_ref(x, graph.W,
                                  sites.expand(C_FULL, -1).contiguous(), g,
                                  graph.D)
        worst = max(worst, compare(
            f"gibbs_class_sweep class {k}", xk, want, C_FULL, exact=True))
        compare(f"gibbs_class_sweep class {k} vs the sequential plain "
                f"version", xk, seq, C_FULL, exact=True)
        x = xk
    return worst


def local_inputs(potts, B, seed):
    """((x, i_sites), kwargs) of one local-gibbs sweep call on potts-64x64 at
    C=256, S=64, as the engine draws them (random x)."""
    gen = torch.Generator(device=potts.device).manual_seed(seed)
    x = torch.randint(0, potts.D, (C_FULL, potts.n), generator=gen,
                      device=potts.device, dtype=torch.int32)
    i = torch.randint(0, potts.n, (C_FULL, S_FULL), generator=gen,
                      device=potts.device, dtype=torch.int32)
    return (x, i), dict(B=B, D=potts.D, scale=(potts.n - 1) / B)


def run_main_path(name, eng, n_chains, n_iters, n_snapshots, expect,
                  falling=True, replay=False):
    """Drive one engine through run_marginal_experiment with the launch
    counts set to 0 just before and read just after.  ``expect(calls)``
    names the launches of the engine's kernel; every other kernel must
    have none.  ``falling``: the marginal error must fall and never rise
    by more than 1e-3; otherwise (the sticky MIN-Gibbs-type chains at
    their capped default lambda, whose trajectory is flat to ~1e-6) the
    chains must have moved and the error must stay finite and within its
    range.  ``replay``: a second run from the same seed, after the counts
    are read, must end in the same bits."""
    from repro_torch.core import chains
    st = eng.init(0, n_chains)
    x0, cache0 = st.x.clone(), float(st.cache.mean())
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tr = chains.run_marginal_experiment(eng, st, n_iters=n_iters,
                                        n_snapshots=n_snapshots)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    errs = [float(e) for e in tr.error]
    calls = int(tr.iters[-1]) // eng.updates_per_call
    updates = calls * eng.updates_per_call * n_chains
    acc = (1.0 if eng.exact_accept else
           float(tr.final.accepts.double().sum()) / updates)
    moved = int((tr.final.x != x0).sum())
    rec = dict(engine=eng.describe(), chains=n_chains, sweep_calls=calls,
               marg_err=errs, acceptance=acc, seconds=wall,
               updates_per_s=updates / wall, sites_changed=moved,
               launches={k: v for k, v in launches.items() if v})
    say("4 main path", f"{name}: marg_err "
        + " ".join(f"{e:.6f}" for e in errs)
        + f"; acc={acc:.4f}; {updates / wall / 1e6:.3f}M updates/s "
        f"({wall:.2f} s); {moved} of {n_chains * eng.graph.n} (chain, site) "
        f"values changed; launches {rec['launches']}")
    want = dict.fromkeys(KERNELS, 0)
    want.update(expect(calls))
    for kernel, n in want.items():
        check(launches[kernel] == n,
              f"{name}: {kernel} launched {launches[kernel]} times, "
              f"expected {n}")
    check(all(np.isfinite(errs)), f"{name}: non-finite marginal error")
    if falling:
        check(errs[-1] < errs[0] and all(b <= a + 1e-3 for a, b in
                                        zip(errs, errs[1:])),
              f"{name}: marginal error not decreasing: {errs}")
    else:
        top = math.sqrt(1.0 - 1.0 / eng.graph.D)    # a one-hot marginal
        check(moved > 0, f"{name}: no chain changed any site")
        check(all(0.0 <= e <= top + 1e-6 for e in errs),
              f"{name}: marginal error outside [0, {top}]: {errs}")
    check(tr.final.x.shape == (n_chains, eng.graph.n)
          and int(tr.final.x.min()) >= 0
          and int(tr.final.x.max()) < eng.graph.D,
          f"{name}: final state out of domain")
    if replay:
        again = chains.run_marginal_experiment(
            eng, eng.init(0, n_chains), n_iters=n_iters,
            n_snapshots=n_snapshots)
        check(torch.equal(again.final.x, tr.final.x)
              and torch.equal(again.error, tr.error),
              f"{name}: a replay from the same seed ended elsewhere")
        rec["replay_bit_identical"] = True
        say("4 main path", f"{name}: replay from seed 0 bit-identical")
    if eng.cache_init is not None:
        cache = tr.final.cache
        check(bool(torch.isfinite(cache).all()),
              f"{name}: non-finite cache")
        rec["cache_mean"] = float(cache.mean())
        rec["cache_start_mean"] = cache0
        say("4 main path", f"{name}: cache finite on all {n_chains} chains, "
            f"mean {cache0:.2f} at init, {rec['cache_mean']:.2f} at the end")
    return rec


def phase_main_path(potts, lattice, pair_table_s):
    from repro_torch.core import engine
    out = {}
    eng = engine.make("mgpmh", potts, sweep=S_FULL)
    check(eng.backend == "cuda", "mgpmh engine is not on the cuda backend")
    out["mgpmh"] = run_main_path(
        "mgpmh potts-64x64", eng, C_FULL, SWEEPS * S_FULL, 10,
        lambda calls: {"mgpmh_sweep": calls})
    check(out["mgpmh"]["acceptance"] > 0.9,
          f"mgpmh acceptance {out['mgpmh']['acceptance']} <= 0.9")
    eng = engine.make("gibbs", potts, sweep=S_FULL)
    out["gibbs"] = run_main_path(
        "gibbs potts-64x64", eng, C_FULL, SWEEPS * S_FULL, 10,
        lambda calls: {"gibbs_sweep": calls})
    eng = engine.make("gibbs", lattice.graph,
                      schedule=engine.ChromaticBlocks(lattice.colors))
    out["chromatic"] = run_main_path(
        "chromatic gibbs lattice-ising-64x64", eng, C_FULL,
        20 * lattice.graph.n, 4,
        lambda calls: {"gibbs_class_sweep": 2 * calls}, replay=True)
    t0 = time.perf_counter()
    eng = engine.make("min-gibbs", potts, sweep=S_MIN)
    build_s = time.perf_counter() - t0
    check(eng.backend == "cuda", "min-gibbs engine is not on the cuda backend")
    streams = host_stream_bytes(
        "min_gibbs", dict(D=potts.D, K=eng.params["capacity"]), C_MIN, S_MIN)
    say("4 main path", f"min-gibbs potts-64x64 params {eng.params}; engine "
        f"built in {build_s:.2f} s; flat pair table built in "
        f"{pair_table_s:.1f} s (host, at graph build); host-drawn streams "
        f"{streams / 1e9:.2f} GB per call")
    out["min-gibbs"] = run_main_path(
        "min-gibbs potts-64x64", eng, C_MIN, SWEEPS_MIN * S_MIN, 10,
        lambda calls: {"min_gibbs_sweep": calls}, falling=False)
    out["min-gibbs"].update(params=eng.params, engine_build_s=build_s,
                            pair_table_s=pair_table_s)
    eng = engine.make("doublemin", potts, sweep=S_DMIN)
    kw = dict(D=potts.D, K1=eng.params["capacity1"],
              K2=eng.params["capacity2"])
    say("4 main path", f"doublemin potts-64x64 params {eng.params}; "
        f"host-drawn streams "
        f"{host_stream_bytes('double_min', kw, C_DMIN, S_DMIN) / 1e9:.2f} "
        f"GB per call")
    out["doublemin"] = run_main_path(
        "doublemin potts-64x64", eng, C_DMIN, SWEEPS_DMIN * S_DMIN, 10,
        lambda calls: {"double_min_sweep": calls}, falling=False)
    out["doublemin"]["params"] = eng.params
    check(out["doublemin"]["acceptance"] > 0,
          "doublemin accepted no proposal")
    for B in LOCAL_B:
        eng = engine.make("local-gibbs", potts, sweep=S_FULL, batch_size=B)
        check(eng.backend == "cuda",
              "local-gibbs engine is not on the cuda backend")
        rec = run_main_path(
            f"local-gibbs B={B} potts-64x64", eng, C_FULL,
            SWEEPS_LOCAL * S_FULL, 10,
            lambda calls: {"local_gibbs_sweep": calls}, replay=True)
        check(rec["sites_changed"] > 0,
              f"local-gibbs B={B}: no chain changed any site")
        out[f"local-gibbs B={B}"] = rec
    torch.cuda.empty_cache()
    return out


def phase_steps(potts):
    """Each single-site reference step STEP_CALLS times from a random start
    at C=256: chains move, and the bucket-energy kernel is launched as often
    as the step computes energies through it (Gibbs: the exact pass; local:
    the minibatch; MGPMH: proposal and exact pass; DoubleMIN: the proposal;
    MIN-Gibbs counts matches without it)."""
    from repro_torch.core import samplers
    from repro_torch.core.estimators import recommended_capacity
    lam1, lam2 = 4.0 * potts.L ** 2, min(2.0 * potts.psi ** 2, 16384.0)
    K1, K2 = recommended_capacity(lam1), recommended_capacity(lam2)
    cases = {
        "gibbs": (samplers.make_gibbs_step(potts), None, 1),
        "local-gibbs": (samplers.make_local_gibbs_step(potts, 32), None, 1),
        "mgpmh": (samplers.make_mgpmh_step(potts, lam1, K1), None, 2),
        "min-gibbs": (samplers.make_min_gibbs_step(potts, lam2, K2),
                      samplers.init_min_gibbs_cache, 0),
        "doublemin": (samplers.make_double_min_step(potts, lam1, K1, lam2,
                                                    K2),
                      samplers.init_double_min_cache, 1),
    }
    out = {}
    for k, (name, (step, cache_init, per_step)) in enumerate(cases.items()):
        gen = torch.Generator(device=potts.device).manual_seed(40 + k)
        st = samplers.init_state(gen, potts, C_FULL, start="random")
        if cache_init is not None:
            st = cache_init(gen, potts, st, lam2, K2)
        x0 = st.x.clone()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(STEP_CALLS):
            st = step(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        moved = int((st.x != x0).sum())
        want = dict.fromkeys(KERNELS, 0)
        want["bucket_energy"] = per_step * STEP_CALLS
        check(launches == want, f"{name} step: launches {launches}, "
              f"expected {want}")
        check(moved > 0, f"{name} step: no chain changed any site")
        check(int(st.x.min()) >= 0 and int(st.x.max()) < potts.D,
              f"{name} step: state out of domain")
        check(bool(torch.isfinite(st.cache).all()),
              f"{name} step: non-finite cache")
        rec = dict(steps=STEP_CALLS, chains=C_FULL, sites_changed=moved,
                   seconds=wall, updates_per_s=STEP_CALLS * C_FULL / wall,
                   bucket_energy_launches=launches["bucket_energy"])
        if name in ("mgpmh", "doublemin"):
            rec["acceptance"] = float(st.accepts.sum()) / (STEP_CALLS
                                                          * C_FULL)
        say("4 steps", f"{name} step x{STEP_CALLS} at C={C_FULL}: {moved} "
            f"(chain, site) values changed, {rec['updates_per_s'] / 1e3:.1f}k"
            f" updates/s, {launches['bucket_energy']} bucket-energy launches"
            + (f", acceptance {rec['acceptance']:.4f}" if "acceptance" in rec
               else ""))
        out[name] = rec
    torch.cuda.empty_cache()
    return out


def rng_path_inputs(potts, seed):
    """Pre-made inputs of the three in-kernel-RNG kernels at C=256, S=64 on
    potts-64x64 at the engines' default lambdas: state, sites, Poisson
    totals and caches only."""
    from repro_torch.core import samplers
    from repro_torch.core.estimators import (min_gibbs_lscale,
                                             recommended_capacity)
    C, S, dev = C_FULL, S_FULL, potts.device
    lam1, lam2 = 4.0 * potts.L ** 2, min(2.0 * potts.psi ** 2, 16384.0)
    K1, K2 = recommended_capacity(lam1), recommended_capacity(lam2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = samplers.init_state(gen, potts, C, start="random")
    cache = samplers.init_min_gibbs_cache(gen, potts, st, lam2, K2).cache
    i = torch.randint(0, potts.n, (C, S), generator=gen, device=dev,
                      dtype=torch.int32)
    lam_i = (lam1 / potts.L) * potts.row_sum[i.long()]
    B1 = torch.poisson(lam_i, generator=gen).clamp_(max=K1).to(torch.int32)
    poisson2 = lambda shape: torch.poisson(
        torch.full(shape, lam2, device=dev), generator=gen
    ).clamp_(max=K2).to(torch.int32)
    npb, nab = samplers._node_alias_table(potts)
    rp, ra = potts.row_prob, potts.row_alias
    lscale2 = min_gibbs_lscale(potts.psi, lam2)
    return {
        "mgpmh_sweep_rng": (
            (st.x, potts.W, rp, ra, i, B1),
            dict(D=potts.D, scale=potts.L / lam1, K=K1)),
        "min_gibbs_sweep_rng": (
            (st.x, npb, nab, rp, ra, i, poisson2((C, S, potts.D)), cache),
            dict(D=potts.D, lscale=lscale2, K=K2)),
        "double_min_sweep_rng": (
            (st.x, rp, ra, npb, nab, i, B1, poisson2((C, S)), cache),
            dict(D=potts.D, scale1=potts.L / lam1, lscale2=lscale2, K1=K1,
                 K2=K2)),
    }


def host_stream_bytes(kernel, kw, C=C_FULL, S=S_FULL):
    """Bytes of the pre-drawn streams the host-stream form of ``kernel``
    takes for one call (uniforms, Gumbels, log-uniforms; float32)."""
    D = kw["D"]
    if kernel.startswith("mgpmh"):
        return 4 * C * S * (2 * kw["K"] + D + 1)
    if kernel.startswith("min_gibbs"):
        return 4 * C * S * D * (4 * kw["K"] + 1)
    return 4 * C * S * (2 * kw["K1"] + D + 4 * kw["K2"] + 1)


def phase_rng_path(potts):
    """The in-kernel-RNG path: RNG_CALLS chained calls of each kernel with
    fresh seeds, launch counts reset before and read after, and each call's
    device memory growth held to its outputs plus 1 MiB."""
    from repro_torch.kernels import fused_sweep as fs
    inputs = rng_path_inputs(potts, seed=21)
    torch.cuda.synchronize()
    reset_launches()
    out = {}
    for k, (args, kw) in inputs.items():
        wrapper = getattr(fs, k + "_cuda")
        a = list(mgpmh_kargs(args, potts) if k == "mgpmh_sweep_rng"
                 else packed(args))
        times, grown, acc = [], [], 0
        for call in range(RNG_CALLS):
            seed = _seed(1000 + call, potts.device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = wrapper(*a, seed, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            outputs = sum(t.numel() * t.element_size() for t in res)
            grown.append(torch.cuda.max_memory_allocated() - before)
            check(grown[-1] <= outputs + (1 << 20),
                  f"{k}: device memory grew {grown[-1]} bytes in a call, "
                  f"outputs {outputs} bytes")
            a[0] = res[0]                         # chain the state
            if k != "mgpmh_sweep_rng":
                a[-1] = res[1]                    # and the cache
            if k != "min_gibbs_sweep_rng":
                acc += int(res[-1].sum())
        x = a[0]
        check(int(x.min()) >= 0 and int(x.max()) < potts.D,
              f"{k}: state out of domain")
        if k != "mgpmh_sweep_rng":
            check(bool(torch.isfinite(a[-1]).all()), f"{k}: non-finite cache")
        upd = C_FULL * S_FULL
        rate = upd / (statistics.median(times) / 1e3)
        streams = host_stream_bytes(k, kw)
        rec = dict(calls=RNG_CALLS, call_ms=times, updates_per_s=rate,
                   memory_growth_bytes=grown, outputs_bytes=outputs,
                   host_stream_bytes=streams)
        line = (f"{k} C={C_FULL} S={S_FULL} K={kw.get('K', kw.get('K2'))}: "
                f"{RNG_CALLS} calls, median {statistics.median(times):.3f} "
                f"ms, {rate / 1e6:.3f}M updates/s, memory growth "
                f"{max(grown)} B (outputs {outputs} B; the host-stream form "
                f"would hold {streams / 1e9:.2f} GB of streams)")
        if k != "min_gibbs_sweep_rng":
            rec["acceptance"] = acc / (RNG_CALLS * upd)
            line += f", acceptance {rec['acceptance']:.4f}"
        say("5 rng path", line)
        out[k] = rec
    launches = read_launches()
    say("5 rng path", f"launches {launches}")
    for k in KERNELS:
        want = RNG_CALLS if k in inputs else 0
        check(launches[k] == want,
              f"rng path: {k} launched {launches[k]} times, expected {want}")
    check(out["mgpmh_sweep_rng"]["acceptance"] > 0.9,
          f"mgpmh_sweep_rng acceptance "
          f"{out['mgpmh_sweep_rng']['acceptance']} <= 0.9")
    out["launches"] = launches
    return out, inputs


def _unique_rows(i):
    return int(torch.unique(i).numel())


def _row_nnz(W, i):
    """Non-zero W entries summed over the rows the sub-steps read: the
    terms an exact pass needs (zeros add nothing)."""
    return int((W != 0).sum(dim=1)[i.long()].sum())


def gibbs_bound(x, W, i, g):
    C, n = x.shape
    nbytes = (8 * C * n + 4 * i.numel() + 4 * g.numel()
              + 4 * n * _unique_rows(i))
    ops = _row_nnz(W, i) * g.shape[-1]       # one compare-add per (j, u)
    return nbytes, ops


def mgpmh_bound(x, W, rp, ra, i, B, u1, u2, g, lu, sectors=False):
    """Bytes and operations of one MGPMH call: x, the sites and totals,
    the Gumbels and logu, the live uniforms, the distinct 8-byte row
    records the draws read (``sectors``: one 32-byte sector per live draw,
    the least a random record costs the memory), the distinct W rows; two
    compare-adds per row term and four operations per draw."""
    C, n = x.shape
    K = u1.shape[-1]
    live = torch.arange(K, device=x.device) < B[..., None]
    idx = torch.clamp((u1 * n).to(torch.int64), max=n - 1)
    keys = (i.long()[..., None] * n + idx)[live]
    records = (32 * int(B.long().sum()) if sectors
               else 8 * int(torch.unique(keys).numel()))
    nbytes = (8 * C * n + 4 * C + 12 * i.numel() + 4 * g.numel()
              + 8 * int(B.long().sum())              # the live uniforms
              + records                               # their table entries
              + 4 * n * _unique_rows(i))              # exact-pass W rows
    ops = 2 * _row_nnz(W, i) + 4 * int(B.long().sum())
    return nbytes, ops


def _pair_entries(row_sum, live):
    """Expected distinct node and (a, idx2) row-table entries that ``live``
    two-stage pair draws read: idx1 and idx2 are uniform over n, a follows
    the node table's p_a = L_a / 2Psi.  (Counted from the distribution, not
    the draws: the in-kernel-RNG forms never materialise theirs, and at
    these draw counts the two agree to well under 1%.)"""
    n = row_sum.numel()
    p = row_sum.double() / row_sum.double().sum()
    node = n * -math.expm1(live * math.log1p(-1.0 / n))
    row = float((n * -torch.expm1(live * torch.log1p(-p / n))).sum())
    return node, row


def _local_entries(i, B, n):
    """Expected distinct (i, idx) row-table entries of the local alias
    draws: B[c, s] uniform picks of idx in row i[c, s]."""
    T = torch.bincount(i.long().flatten(), weights=B.double().flatten(),
                       minlength=n)
    return float((n * -torch.expm1(T * math.log1p(-1.0 / n))).sum())


def _philox_calls(B, K=None):
    """Philox calls (4 words each) the live lanes of one stream need: lanes
    [0, B) of each (c, s) row, or with ``K`` lanes [u*K, u*K + B) of each
    (c, s, u) (MIN-Gibbs's D*K-lane streams)."""
    B = B.long()
    if K is None:
        return int(((B + 3) // 4).sum())
    first = torch.arange(B.shape[-1], device=B.device) * K
    calls = (first + B - 1) // 4 - first // 4 + 1
    return int(torch.where(B > 0, calls, 0).sum())


def _gumbel_calls(i, D, extra=0):
    """Philox calls of the D Gumbel lanes (and ``extra`` one-lane streams)
    of each (c, s)."""
    return (-(-D // 4) + extra) * i.numel()


def min_gibbs_bound(args, row_sum, rng, K):
    """x, tables, i, B first in ``args``; rng: the Philox form."""
    x, i, B = args[0], args[5], args[6]
    C, n = x.shape
    D = B.shape[-1]
    live = int(B.long().sum())
    node, row = _pair_entries(row_sum, live)
    nbytes = (8 * C * n + 8 * C + 4 * i.numel() + 4 * B.numel()
              + 8 * (node + row))
    int_ops = 0
    if rng:
        int_ops = PHILOX_INT_OPS * (4 * _philox_calls(B, K)
                                    + _gumbel_calls(i, D))
    else:
        nbytes += 16 * live + 4 * B.numel()          # uniforms, Gumbels
    return nbytes, 4 * live, int_ops


def double_min_bound(x, i, B1, B2, row_sum, D, rng):
    C, n = x.shape
    live1, live2 = int(B1.long().sum()), int(B2.long().sum())
    node, row = _pair_entries(row_sum, live2)
    nbytes = (8 * C * n + 12 * C + 12 * i.numel()
              + 8 * (_local_entries(i, B1, n) + node + row))
    int_ops = 0
    if rng:
        int_ops = PHILOX_INT_OPS * (2 * _philox_calls(B1)
                                    + 4 * _philox_calls(B2)
                                    + _gumbel_calls(i, D, extra=1))
    else:
        nbytes += 8 * live1 + 16 * live2 + 4 * (D + 1) * i.numel()
    return nbytes, 4 * (live1 + live2), int_ops


def mgpmh_rng_bound(x, W, rp, ra, i, B, D, sectors=False):
    C, n = x.shape
    live = int(B.long().sum())
    records = 32 * live if sectors else 8 * _local_entries(i, B, n)
    nbytes = (8 * C * n + 4 * C + 8 * i.numel()
              + records                               # alias entries
              + 4 * n * _unique_rows(i))              # exact-pass W rows
    int_ops = PHILOX_INT_OPS * (2 * _philox_calls(B)
                                + _gumbel_calls(i, D, extra=1))
    return nbytes, 2 * _row_nnz(W, i) + 4 * live, int_ops


def bound(nbytes, ops, int_ops=0):
    """Least time in ms: the larger of the bytes over the memory rate and
    the operations over their peak rates (fp32, int32)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S + int_ops / INT32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_times(potts, lattice, rng_inputs):
    from repro_torch.kernels import fused_sweep as fs, ref
    recs = {}
    args, kw, _, _ = mgpmh_inputs(potts, C_FULL, S_FULL, seed=4)
    kargs = mgpmh_kargs(args, potts)
    ms = median_ms(lambda: fs.mgpmh_sweep_cuda(*kargs, **kw), 20)
    pms = median_ms(lambda: ref.mgpmh_sweep_ref(*args, kw["D"], kw["scale"]),
                    3)
    bms, by = bound(*mgpmh_bound(*args))
    recs["mgpmh_sweep"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                               shape="potts-64x64 C=256 S=64 K=201 D=10",
                               sector_bound_ms=bound(*mgpmh_bound(
                                   *args, sectors=True))[0],
                               **gather_floor(args[5]),
                               ring=fs.mgpmh_ring_plan(potts.n, potts.D))
    args = gibbs_inputs(potts, C_FULL, S_FULL, seed=5)
    ms = median_ms(lambda: fs.gibbs_sweep_cuda(*args, D=potts.D), 20)
    pms = median_ms(lambda: ref.gibbs_sweep_ref(*args, potts.D), 3)
    bms, by = bound(*gibbs_bound(*args))
    recs["gibbs_sweep"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                               shape="potts-64x64 C=256 S=64 D=10")
    recs["gibbs_sweep"]["ring"] = fs.gibbs_ring_plan(potts.n, potts.D)
    recs["gibbs_class_sweep"] = class_times(lattice)
    recs.update(new_kernel_times(potts, rng_inputs))
    for k, r in recs.items():
        rate = (f", {r['pair_draws_per_s'] / 1e9:.2f} G pair draws/s"
                if "pair_draws_per_s" in r else "")
        if "gather_probe_ms" in r:
            rate += (f"; {r['live_draws']} live draws: bound with one "
                     f"sector each {r['sector_bound_ms']:.4f} ms, a "
                     f"random-gather probe of as many records "
                     f"{r['gather_probe_ms']:.4f} ms")
        say("6 times", f"{k} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms [{r.get('plain_shape', r['shape'])}], "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){rate}")
    recs["per_sweep_ms"] = sweep_parts(potts, lattice)
    recs["bucket_energy_shapes"] = shapes = bucket_times(potts.device)
    recs["bucket_energy"] = dict(
        shapes["C={} K={} D={}".format(*BUCKET_MAIN)],
        max_abs_err=max(r["max_abs_err"] for r in shapes.values()))
    recs["local_gibbs_sweep_b"] = local = local_times(potts)
    recs["local_gibbs_sweep"] = local[LOCAL_MAIN]
    recs["local_sweep_ms"] = local_split(potts)
    recs["mgpmh_call"] = mgpmh_call(potts)
    recs["chromatic_call"] = chromatic_call(lattice)
    return recs


def gibbs_class_bound(x, offsets, sites, u):
    """Bytes and operations one class update needs: x read and written once
    (8*C*n), the uniforms, the records of the class rows (8 per non-zero),
    their offsets and the sites; one compare-add per (chain, non-zero,
    bucket), and the two logarithms of each uniform's Gumbel counted as one
    operation each."""
    C, n = x.shape
    idx = sites.long()
    nnz = int((offsets[idx + 1] - offsets[idx]).sum())
    nbytes = 8 * C * n + 4 * u.numel() + 8 * nnz + 12 * sites.numel()
    return nbytes, C * nnz * u.shape[-1] + 2 * u.numel()


def class_library(W, x, sites, g):
    """A function computing the class's new values (m, C) as one float32
    ``torch.matmul`` of W[sites] (m x n) by the one-hot state (n x C*D),
    plus the Gumbels and the argmax (first maximum) -- the library
    yardstick of the class kernel, used nowhere in the port.  W[sites], the
    one-hot matrix and the transposed Gumbels are made once, outside it."""
    C, n = x.shape
    m, D = g.shape[1], g.shape[2]
    Wc = W[sites.long()]
    oh = (x.T[..., None] == torch.arange(D, device=x.device)).to(
        torch.float32).reshape(n, C * D)
    gT = g.transpose(0, 1).contiguous()
    return lambda: torch.argmax(torch.matmul(Wc, oh).view(m, C, D) + gT,
                                dim=-1)


def class_times(lattice):
    """The class kernel on class 0 of lattice-ising-64x64 at C=256, fed
    uniforms: per launch as a stream of launches (host path included; it
    writes the class in place, and a repeat writes the same values), single
    call, device time alone, beside its plain version (the Gumbels made
    from the uniforms included), the ``torch.matmul`` yardstick (TF32 off;
    the Gumbels made outside it), its bound and its launch plan."""
    from repro_torch.kernels import chromatic_sweep as chs, ref
    graph = lattice.graph
    gen = torch.Generator(device=graph.device).manual_seed(6)
    x = torch.randint(0, graph.D, (C_FULL, graph.n), generator=gen,
                      device=graph.device, dtype=torch.int32)
    sites = torch.as_tensor(np.flatnonzero(lattice.colors == 0),
                            dtype=torch.int32, device=graph.device)
    u = torch.rand((C_FULL, sites.numel(), graph.D), generator=gen,
                   device=graph.device)
    g = ref.gumbel_from_uniform(u.clone())
    nbr = graph.nbr_pack
    xk = x.clone()
    f = lambda: chs.gibbs_class_sweep_cuda(xk, *nbr, sites, u, D=graph.D)
    single = median_ms(f, 50)
    ms = per_launch_ms(f, 20)
    dms = kernel_device_ms(f, 20, "gibbs_class")
    pms, want = timed(lambda: ref.gibbs_class_sweep_ref(
        x, graph.W, sites, ref.gumbel_from_uniform(u.clone()), graph.D), 5)
    lms, v = timed(class_library(graph.W, x, sites, g), 20)
    torch.cuda.synchronize()
    check(torch.equal(xk, want), "gibbs_class_sweep != plain version in "
          "phase 6")
    check(torch.equal(v.T.to(torch.int32), want[:, sites.long()]),
          "the matmul yardstick != the plain version")
    bms, by = bound(*gibbs_class_bound(x, nbr[0], sites, u))
    plan = chs.gibbs_class_plan(C_FULL, sites.numel(), graph.D)
    say("6 times", f"gibbs_class_sweep: device {dms:.4f} ms a launch; plan "
        f"{plan}")
    return dict(ms=ms, single_call_ms=single, device_ms=dms, plain_ms=pms,
                library_ms=lms, bound_ms=bms, bound_by=by, plan=plan,
                shape=f"lattice-ising-64x64 class 0 C={C_FULL} "
                      f"m={sites.numel()} D={graph.D}")


def per_launch_ms(fn, n, reps=5):
    """Median over ``reps`` of the CUDA-event time of ``n`` back-to-back
    calls, divided by n (a kernel of a few microseconds is timed as the
    stream of launches its caller makes)."""
    return median_ms(lambda: [fn() for _ in range(n)], reps) / n


def bucket_times(dev):
    """The bucket-energy kernel at every BUCKET_SHAPES shape beside its
    plain version, the one PyTorch call that computes the same function
    (``zeros.scatter_add_``, float atomics, order not fixed) and its bound:
    C*K*8 bytes read and C*D*4 written against C*K adds."""
    from repro_torch.kernels import minibatch_energy as me, ref
    recs = {}
    for k, (C, K, D) in enumerate(BUCKET_SHAPES):
        w, v = bucket_inputs(C, K, D, "normal", dev, seed=100 + k)
        v64 = v.long()
        library = lambda: torch.zeros((C, D), device=dev).scatter_add_(
            1, v64, w)
        out, want, lib = (me.bucket_energy_cuda(w, v, D),
                          ref.bucket_energy_ref(w, v, D), library())
        check(bucket_close(out, want), f"bucket_energy off the plain "
              f"version at (C,K,D)={(C, K, D)}: max abs err "
              f"{float((out - want).abs().max())}")
        # scatter_add_ adds in the order its atomics land, which changes
        # from run to run: hold it to the float64 sum within the bound of
        # float32 summation in any order, (K - 1) 2^-24 sum_k |w[c, k]|
        # (rtol 1e-5 / atol 1e-4 failed it once at (64, 8192, 2))
        exact = torch.zeros((C, D), dtype=torch.float64, device=dev
                            ).scatter_add_(1, v64, w.double())
        lib_tol = (K - 1) * 2.0 ** -24 * w.double().abs().sum(1, True)
        check(bool(((lib.double() - exact).abs() <= lib_tol).all()),
              f"scatter_add_ off the float64 sum at (C,K,D)={(C, K, D)} "
              f"beyond float32 summation error")
        # the kernel and scatter_add_ in turns, so the host's load falls on
        # both alike
        ms, lms, _ = alternating_per_launch_ms(
            lambda: me.bucket_energy_cuda(w, v, D), library, 100)
        pms = per_launch_ms(lambda: ref.bucket_energy_ref(w, v, D), 20)
        dev_ms = kernel_device_ms(lambda: me.bucket_energy_cuda(w, v, D), 100,
                                  "bucket_energy")
        lib_dev_ms = kernel_device_ms(library, 100)
        bms, by = bound(8 * C * K + 4 * C * D, C * K)
        shape = f"C={C} K={K} D={D}"
        recs[shape] = dict(ms=ms, device_ms=dev_ms, plain_ms=pms,
                           library_ms=lms, library_device_ms=lib_dev_ms,
                           bound_ms=bms, bound_by=by, shape=shape,
                           max_abs_err=float((out - want).abs().max()))
        say("6 times", f"bucket_energy [C={C} K={K} D={D}]: kernel {ms:.4f} "
            f"ms per launch (device {dev_ms:.4f}), plain {pms:.4f} ms, "
            f"scatter_add_ {lms:.4f} ms per call (device, zeros and scatter "
            f"{lib_dev_ms:.4f}), bound {bms:.6f} ms ({by})")
    return recs


def alternating_per_launch_ms(fn_a, fn_b, n, reps=5):
    """Per-launch ms of two functions timed as ``per_launch_ms`` does, in
    turns (a, b, a, b, ...): (median of ``reps`` turns of a, of b, median
    over turns of a / b; the ratio of neighbouring turns is steadier than
    the ratio of medians where the host's pace drifts)."""
    ta, tb = [], []
    fn_a(), fn_b()
    for _ in range(reps):
        ta.append(per_launch_ms(fn_a, n, reps=1))
        tb.append(per_launch_ms(fn_b, n, reps=1))
    return (statistics.median(ta), statistics.median(tb),
            statistics.median(a / b for a, b in zip(ta, tb)))


def device_events(run, cpu=False, tries=3):
    """(the device events of ``torch.profiler``'s ``key_averages()`` over one
    window around ``run()``, what ``run`` returned).  CUPTI dropped every
    device record of one window on the H100 in several hundred: a window
    that delivered no device time is profiled again, up to ``tries``
    windows, and the caller checks what the last one saw."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            out = run()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(e.self_device_time_total > 0 for e in dev):
            break
    return dev, out


def kernel_device_ms(fn, n, name=None):
    """Device time per call of ``fn`` from ``torch.profiler`` over n calls:
    the summed self device time of the device ops whose name holds ``name``
    (all of them when None), divided by n."""
    def run():
        for _ in range(n):
            fn()

    fn()
    dev, _ = device_events(run)
    total = sum(e.self_device_time_total for e in dev
                if (name is None or name in e.key)
                and not e.key.startswith("repro."))
    check(total > 0, f"torch.profiler saw no device time for {name or fn}")
    return total / 1e3 / n


def local_bound(x, i, B, D, seed):
    """Bytes and operations one local-gibbs sweep call needs: the distinct
    W entries its subsets read (counted from the plain version's subsets),
    x read and written, the sites and the seed; one add per subset entry;
    and the Philox calls of its two streams (B and D lanes, four words per
    call)."""
    from repro_torch.kernels import ref
    C, n = x.shape
    S = i.shape[1]
    j = ref.local_gibbs_subsets(seed, i, B, n)
    cells = int(torch.unique(i.long()[..., None] * n + j).numel())
    nbytes = 4 * cells + 8 * C * n + 4 * C * S + 4
    int_ops = PHILOX_INT_OPS * C * S * (-(-B // 4) + -(-D // 4))
    return nbytes, C * S * B, int_ops


def local_times(potts):
    """The local-gibbs sweep kernel at C=256, S=64 on potts-64x64 for each
    B in LOCAL_B beside its plain version and its bound (bytes: distinct W
    entries, x, sites; the sub-steps' dependent latencies keep the kernel
    far above it), each output held against the plain version's."""
    from repro_torch.kernels import local_sweep as ls, ref
    recs = {}
    for B in LOCAL_B:
        (x, i), kw = local_inputs(potts, B, seed=16)
        sd = _seed(17, potts.device)
        kernel = lambda: ls.local_gibbs_sweep_cuda(x, potts.W, i, sd, **kw)
        ko = kernel()
        # the sub-steps the consumer recomputed (a value a producer read
        # had changed by its turn), over five launches
        shares = []
        for _ in range(5):
            n_re = torch.zeros(C_FULL, dtype=torch.int32, device=x.device)
            check(torch.equal(ls.local_gibbs_sweep_cuda(
                x, potts.W, i, sd, recomputed=n_re, **kw), ko),
                f"local_gibbs_sweep B={B}: a launch counting its recomputes "
                f"gave other bits")
            shares.append(float(n_re.sum()) / (C_FULL * S_FULL))
        plan = ls.local_sweep_plan(potts.n, S_FULL, B, kw["D"])
        # a stream of launches (the host's path runs ahead of the card's
        # work), and the device time alone from torch.profiler
        ms = per_launch_ms(kernel, 20)
        dev_ms = kernel_device_ms(kernel, 20, "local_gibbs_sweep")
        pms, po = timed(lambda: ref.local_gibbs_sweep_ref(
            x, potts.W, i, sd, B, kw["D"], kw["scale"]), 1)
        n_diff, err = compare(f"local_gibbs_sweep B={B}", ko, po, C_FULL,
                              phase="6 times")
        bms, by = bound(*local_bound(x, i, B, kw["D"], sd))
        shape = f"potts-64x64 C={C_FULL} S={S_FULL} B={B} D={kw['D']}"
        recs[B] = dict(ms=ms, device_ms=dev_ms, plain_ms=pms, bound_ms=bms,
                       bound_by=by, library_ms=None, shape=shape,
                       differing_chains=n_diff, max_abs_err=err,
                       recomputed_share=shares, plan=plan)
        say("6 times", f"local_gibbs_sweep [{shape}]: kernel {ms:.4f} ms per "
            f"launch (device {dev_ms:.4f}), plain {pms:.4f} ms, bound "
            f"{bms:.6f} ms ({by}; the S dependent sub-steps keep it "
            f"latency-bound), no library call; recomputed sub-steps "
            f"{min(shares):.4f}-{max(shares):.4f} of C*S over 5 launches; "
            f"plan {plan}")
    return recs


def local_split(potts):
    """One local-gibbs sweep call (C=256, S=64) per batch size, CUDA-event
    medians: the whole call (``eng.sweep``), the kernel alone on the same
    inputs, and the rest (the site and seed draws, the launch's host path);
    updates/s of the call, and the device's busy time over one call from
    ``torch.profiler`` against the unprofiled call's time."""
    from repro_torch.core import engine
    from repro_torch.kernels import local_sweep as ls
    out = {}
    C, S, n, D, dev = C_FULL, S_FULL, potts.n, potts.D, potts.device
    for B in LOCAL_B:
        eng = engine.make("local-gibbs", potts, sweep=S, batch_size=B)
        st = eng.init(3, C, start="random")
        call = median_ms(lambda: eng.sweep(st), 20)
        gen = torch.Generator(device=dev).manual_seed(4)
        draw = lambda: (
            torch.randint(0, n, (C, S), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=dev,
                          dtype=torch.int32))
        draws = median_ms(draw, 20)
        i, sd = draw()
        kern = median_ms(lambda: ls.local_gibbs_sweep_cuda(
            st.x, potts.W, i, sd, B=B, D=D, scale=(n - 1) / B), 20)
        out[B] = rec = dict(call_ms=call, kernel_ms=kern, draws_ms=draws,
                            rest_ms=call - kern,
                            updates_per_s=C * S / (call / 1e3),
                            **device_busy(lambda: eng.sweep(st)))
        # the profiled device time against the unprofiled call's time
        rec["device_idle_share"] = 1.0 - rec["device_busy_ms"] / call
        say("6 times", f"local-gibbs sweep call B={B} C={C} S={S}: "
            f"{call:.4f} ms = kernel {kern:.4f} + rest {call - kern:.4f} "
            f"(site and seed draws alone {draws:.4f}; "
            f"{rec['updates_per_s'] / 1e6:.3f}M updates/s); profiled call: "
            f"{rec['profiled_wall_ms']:.3f} ms wall, device busy "
            f"{rec['device_busy_ms']:.4f} ms (idle "
            f"{rec['device_idle_share']:.3f} of the call), device ops "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        rec["top_device_ops_ms"].items()))
    return out


def host_ms(fn, n):
    """Host-clock ms per call of ``fn`` over n calls with no synchronize
    between them: the time the host takes to issue one call's work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / n


def call_trace(call, parts, n=CALL_REPS, window=10):
    """One sweep call split up: CUDA-event medians of the whole call and of
    each of ``parts`` (name -> fn, on inputs made once) alone, the host's
    issue time of each (``host_ms``); a stream of ``window`` calls (ms per
    call), and the device's busy time and top ops over such a stream under
    torch.profiler, per call, with the idle share of the unprofiled
    stream's time."""
    rec = dict(call_ms=median_ms(call, n), call_host_ms=host_ms(call, n),
               parts=list(parts))
    for name, fn in parts.items():
        rec[f"{name}_ms"] = median_ms(fn, n)
        rec[f"{name}_host_ms"] = host_ms(fn, n)
    stream = lambda: [call() for _ in range(window)]
    rec["stream_call_ms"] = median_ms(stream, 3) / window
    busy = device_busy(stream)
    rec.update(window=window,
               profiled_wall_ms=busy["profiled_wall_ms"] / window,
               device_busy_ms=busy["device_busy_ms"] / window,
               top_device_ops_ms={k: v / window for k, v in
                                  busy["top_device_ops_ms"].items()})
    rec["device_idle_share"] = 1.0 - rec["device_busy_ms"] / rec[
        "stream_call_ms"]
    return rec


def trace_line(name, rec):
    """A ``call_trace`` record as one line."""
    parts = ", ".join(f"{p} {rec[p + '_ms']:.4f} (host "
                      f"{rec[p + '_host_ms']:.4f})" for p in rec["parts"])
    return (f"{name}: call {rec['call_ms']:.4f} ms (host issue "
            f"{rec['call_host_ms']:.4f}); alone: {parts}; a stream of "
            f"{rec['window']} calls {rec['stream_call_ms']:.4f} ms per call, "
            f"device busy {rec['device_busy_ms']:.4f} (idle "
            f"{rec['device_idle_share']:.3f}; profiled wall "
            f"{rec['profiled_wall_ms']:.4f}), top device ops per call "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        rec["top_device_ops_ms"].items()))


def mgpmh_call(potts):
    """The MGPMH engine's sweep call at C=256, S=64 (phase 4's), traced:
    the whole call, its draws and the kernel's wrapper alone, the device's
    busy time and idle share over a stream of calls, and updates/s of that
    stream."""
    from repro_torch.core import engine, samplers
    from repro_torch.kernels import fused_sweep as fs
    eng = engine.make("mgpmh", potts, sweep=S_FULL)
    st = eng.init(3, C_FULL, start="random")
    lam, K = eng.params["lam"], eng.params["capacity"]
    rate = samplers.mgpmh_rate(potts, lam)
    gen = torch.Generator(device=potts.device).manual_seed(4)
    draw = lambda: samplers.mgpmh_draws(gen, potts, C_FULL, S_FULL, rate, K)
    kargs = (st.x, potts.W, potts.row_pack, *draw())
    kw = dict(D=potts.D, scale=potts.L / lam)
    rec = call_trace(lambda: eng.sweep(st), {
        "draws": draw,
        "kernel": lambda: fs.mgpmh_sweep_cuda(*kargs, **kw)})
    rec["updates_per_s"] = C_FULL * S_FULL / (rec["stream_call_ms"] / 1e3)
    say("6 times", trace_line(f"mgpmh sweep call potts-64x64 C={C_FULL} "
                              f"S={S_FULL} K={K}", rec)
        + f"; {rec['updates_per_s'] / 1e6:.3f}M updates/s")
    return rec


def device_ops_per_call(fn, n=10):
    """Device ops (kernels, copies, memsets) per call of ``fn``, counted by
    ``torch.profiler`` over n calls: the mean (CUPTI has left out one or
    two records of 150 on the H100, so a caller rounds it)."""
    def run():
        for _ in range(n):
            fn()

    fn()
    dev, _ = device_events(run)
    ops = sum(e.count for e in dev if not e.key.startswith("repro."))
    check(ops > 0, f"torch.profiler saw no device op for {fn}")
    return ops / n


def chromatic_call(lattice):
    """The chromatic engine's sweep call on lattice-ising-64x64 at C=256
    (phase 4's), traced as ``mgpmh_call``'s: the whole call, one class's
    uniform draw and class launch alone, the device's busy time and idle
    share over a stream of calls, updates/s of that stream, and the device
    ops of a call, which must be five: the state's copy, then per class one
    ``torch.rand`` and one class-kernel launch."""
    from repro_torch.core import engine
    from repro_torch.kernels import chromatic_sweep as chs
    graph = lattice.graph
    eng = engine.make("gibbs", graph,
                      schedule=engine.ChromaticBlocks(lattice.colors))
    st = eng.init(3, C_FULL, start="random")
    sites = torch.as_tensor(np.flatnonzero(lattice.colors == 0),
                            dtype=torch.int32, device=graph.device)
    gen = torch.Generator(device=graph.device).manual_seed(4)
    draw = lambda: torch.rand((C_FULL, sites.numel(), graph.D),
                              generator=gen, device=graph.device)
    u, xk = draw(), st.x.clone()
    rec = call_trace(lambda: eng.sweep(st), {
        "draws": draw,
        "kernel": lambda: chs.gibbs_class_sweep_cuda(
            xk, *graph.nbr_pack, sites, u, D=graph.D)})
    rec["updates_per_s"] = C_FULL * graph.n / (rec["stream_call_ms"] / 1e3)
    rec["device_ops_per_call"] = ops = device_ops_per_call(
        lambda: eng.sweep(st))
    check(round(ops) == 5, f"a chromatic sweep call issued {ops} device "
          f"ops, expected 5 (the copy, and a torch.rand and a class launch "
          f"per class)")
    say("6 times", trace_line(f"chromatic sweep call lattice-ising-64x64 "
                              f"C={C_FULL}", rec)
        + f"; {rec['updates_per_s'] / 1e6:.3f}M updates/s; {ops:g} device "
        f"ops a call")
    return rec


def device_busy(fn, kernels=(), top=5):
    """One call of ``fn`` under torch.profiler: wall ms (host clock, to a
    synchronize; the profiler's own cost included), device ms (the summed
    time of the device's kernels, memcpys and memsets; one stream) and the
    ``top`` of them with the most time; for each name in ``kernels``, the
    launches and device ms of the kernels whose name holds it.  The
    ``repro.`` ranges of ``obs.annotate``, which the profiler also lists on
    the device, span kernels already counted and are left out."""
    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    dev, wall = device_events(run, cpu=True)
    name = lambda key: key.replace("(anonymous namespace)::", "").split(
        "(")[0].split("<")[0].split(" ")[-1]
    ops = [(name(e.key), e.self_device_time_total / 1e3) for e in dev
           if not e.key.startswith("repro.")]
    ops = sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])
    check(bool(ops), f"torch.profiler saw no device time for {fn}")
    rec = dict(profiled_wall_ms=1e3 * wall,
               device_busy_ms=sum(ms for _, ms in ops),
               top_device_ops_ms={k: ms for k, ms in ops[:top]})
    if kernels:
        rec["kernels"] = {n: dict(
            launches=sum(e.count for e in dev if n in e.key),
            device_ms=sum(e.self_device_time_total for e in dev
                          if n in e.key) / 1e3) for n in kernels}
    return rec


def _per_s(B, ms):
    """Live draws (the Poisson totals' sum) per second of kernel time."""
    return int(B.long().sum()) / (ms / 1e3)


def sliced_plain(plain, args, per_chain, step):
    """A plain in-kernel-RNG version over chain slices of ``step`` rows
    (``plain(args, chain0)``; all chains' streams at once would not fit):
    (CUDA-event ms summed over the slices, the slices' outputs joined)."""
    C = args[0].shape[0]
    ms, outs = 0.0, []
    for lo in range(0, C, step):
        part = tuple(v[lo:lo + step] if j in per_chain else v
                     for j, v in enumerate(args))
        t, out = timed(lambda: plain(part, lo), 1, warmup=0)
        ms += t
        outs.append(out)
    return ms, tuple(torch.cat(o) for o in zip(*outs))


def new_kernel_times(potts, rng_inputs):
    """Slice-2 kernels at the shapes of phases 4 (host streams) and 5
    (in-kernel RNG), each held against its plain version on the same
    inputs: the host-stream kernels exactly, the in-kernel-RNG kernels to
    at most 1% of chains.  The plain in-kernel-RNG versions materialise
    every stream (MIN-Gibbs's > 45 GB at C=256, S=64), so they run on chain
    slices (``chain0``), and their time is the slices' sum."""
    from repro_torch.kernels import fused_sweep as fs, ref
    recs = {}
    rs = potts.row_sum
    check_at = lambda k, C, ko, po, exact: dict(zip(
        ("differing_chains", "max_abs_err"),
        compare(k, ko, po, C, exact=exact, phase="6 times")))
    args, kw, K = min_gibbs_inputs(potts, C_MIN, S_MIN, seed=31)
    D, lscale = kw["D"], kw["lscale"]
    kargs = packed(args)
    ms, ko = timed(lambda: fs.min_gibbs_sweep_cuda(*kargs, **kw), 5)
    pms, po = timed(lambda: ref.min_gibbs_sweep_ref(*args, D, lscale), 1)
    bms, by = bound(*min_gibbs_bound(args, rs, rng=False, K=K))
    shape = f"potts-64x64 C={C_MIN} S={S_MIN} K={K} D={D}"
    recs["min_gibbs_sweep"] = dict(
        ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, shape=shape,
        pair_draws_per_s=_per_s(args[6], ms),
        **check_at("min_gibbs_sweep", C_MIN, ko, po, True))
    del args, kargs, ko, po
    torch.cuda.empty_cache()
    args, kw, K1, K2 = double_min_inputs(potts, C_DMIN, S_DMIN, seed=32)
    kargs = packed(args)
    ms, ko = timed(lambda: fs.double_min_sweep_cuda(*kargs, **kw), 5)
    pms, po = timed(lambda: ref.double_min_sweep_ref(
        *args, kw["D"], kw["scale1"], kw["lscale2"]), 1)
    bms, by = bound(*double_min_bound(args[0], args[5], args[6], args[10],
                                      rs, D, rng=False))
    recs["double_min_sweep"] = dict(
        ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        shape=f"potts-64x64 C={C_DMIN} S={S_DMIN} K1={K1} K2={K2} D={D}",
        pair_draws_per_s=_per_s(args[10], ms),
        **check_at("double_min_sweep", C_DMIN, ko, po, True))
    del args, kargs, ko, po
    torch.cuda.empty_cache()
    seed = _seed(77, potts.device)
    rng_shape = f"potts-64x64 C={C_FULL} S={S_FULL}"
    args, kw = rng_inputs["mgpmh_sweep_rng"]
    kargs = mgpmh_kargs(args, potts)
    ms, ko = timed(lambda: fs.mgpmh_sweep_rng_cuda(*kargs, seed, **kw), 10)
    pms, po = timed(lambda: ref.mgpmh_sweep_rng_ref(
        *args, seed, kw["D"], kw["scale"], kw["K"]), 3)
    bms, by = bound(*mgpmh_rng_bound(*args, kw["D"]))
    recs["mgpmh_sweep_rng"] = dict(
        ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        shape=f"{rng_shape} K={kw['K']}", **gather_floor(args[5]),
        sector_bound_ms=bound(*mgpmh_rng_bound(*args, kw["D"],
                                               sectors=True))[0],
        **check_at("mgpmh_sweep_rng", C_FULL, ko, po, False))
    args, kw = rng_inputs["min_gibbs_sweep_rng"]
    kargs = packed(args)
    ms, ko = timed(lambda: fs.min_gibbs_sweep_rng_cuda(*kargs, seed, **kw),
                   3)
    bms, by = bound(*min_gibbs_bound(args, rs, rng=True, K=kw["K"]))
    pms, po = sliced_plain(
        lambda a, c0: ref.min_gibbs_sweep_rng_ref(
            *a, seed, D, kw["lscale"], kw["K"], chain0=c0),
        args, (0, 5, 6, 7), SLICE_MIN)
    recs["min_gibbs_sweep_rng"] = dict(
        ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        pair_draws_per_s=_per_s(args[6], ms),
        shape=f"{rng_shape} K={kw['K']}",
        plain_shape=f"{rng_shape} K={kw['K']} in slices of {SLICE_MIN} "
                    f"chains",
        **check_at("min_gibbs_sweep_rng", C_FULL, ko, po, False))
    del ko, po
    torch.cuda.empty_cache()
    args, kw = rng_inputs["double_min_sweep_rng"]
    kargs = packed(args)
    ms, ko = timed(lambda: fs.double_min_sweep_rng_cuda(*kargs, seed, **kw),
                   5)
    bms, by = bound(*double_min_bound(args[0], args[5], args[6], args[7],
                                      rs, D, rng=True))
    pms, po = sliced_plain(
        lambda a, c0: ref.double_min_sweep_rng_ref(
            *a, seed, D, kw["scale1"], kw["lscale2"], kw["K1"], kw["K2"],
            chain0=c0),
        args, (0, 5, 6, 7, 8), SLICE_DMIN)
    recs["double_min_sweep_rng"] = dict(
        ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        pair_draws_per_s=_per_s(args[7], ms),
        shape=f"{rng_shape} K1={kw['K1']} K2={kw['K2']}",
        plain_shape=f"{rng_shape} K1={kw['K1']} K2={kw['K2']} in slices of "
                    f"{SLICE_DMIN} chains",
        **check_at("double_min_sweep_rng", C_FULL, ko, po, False))
    del ko, po
    torch.cuda.empty_cache()
    return recs


def sweep_parts(potts, lattice):
    """CUDA-event medians of the other device work one sweep call of each
    main-path run makes: its draws and the runner's marginal accumulation."""
    from repro_torch.core import samplers
    from repro_torch.core.estimators import recommended_capacity
    gen = torch.Generator(device=potts.device).manual_seed(7)
    lam = 4.0 * potts.L ** 2
    K = recommended_capacity(lam)
    rate = samplers.mgpmh_rate(potts, lam)
    from repro_torch.core.chains import accumulate_marginals
    marg = torch.zeros((C_FULL, potts.n, potts.D), device=potts.device)
    weight = torch.empty((C_FULL, potts.n), device=potts.device)
    ones = torch.ones((C_FULL, potts.n, 1), device=potts.device)
    x = torch.randint(0, potts.D, (C_FULL, potts.n), generator=gen,
                      dtype=torch.int32, device=potts.device)
    x_long = x.long()
    # the runner's accumulation per sweep call in two forms, timed in
    # turns: an int64 conversion of the state and a scatter of ones (which
    # a code outside [0, D) breaks), and accumulate_marginals (an int32
    # clamp, the in-domain mask, a scatter of the mask)
    accumulate = {
        "marginal_accumulate_int64_ones": lambda: marg.scatter_add_(
            2, x.long().unsqueeze(-1), ones),
        "marginal_accumulate_masked": lambda: accumulate_marginals(
            marg, x, weight)}
    turns = {k: [] for k in accumulate}
    for _ in range(21):
        for k, fn in accumulate.items():
            turns[k].append(median_ms(fn, 1))
    half = lattice.graph.n // 2
    lam2 = min(2.0 * potts.psi ** 2, 16384.0)
    K2 = recommended_capacity(lam2)
    parts = {
        "mgpmh_draws": median_ms(lambda: samplers.mgpmh_draws(
            gen, potts, C_FULL, S_FULL, rate, K), 20),
        "min_gibbs_draws": median_ms(lambda: samplers.min_gibbs_draws(
            gen, potts, C_MIN, S_MIN, lam2, K2), 5),
        "double_min_draws": median_ms(lambda: samplers.double_min_draws(
            gen, potts, C_DMIN, S_DMIN, lam, K, lam2, K2), 5),
        "gibbs_draws": median_ms(lambda: samplers.gibbs_draws(
            gen, C_FULL, S_FULL, potts.n, potts.D, potts.device), 20),
        # the uniforms a chromatic call draws per class, and the Gumbels
        # of as many (the draw and five elementwise passes) it drew before
        # the class kernel made them itself
        "chromatic_draws_per_class": median_ms(lambda: torch.rand(
            (C_FULL, half, 2), generator=gen, device=potts.device), 20),
        "chromatic_gumbels_per_class": median_ms(lambda: samplers.gumbel(
            (C_FULL, half, 2), gen, potts.device), 20),
        # the scatter alone, of a state already in int64
        "marginal_accumulate": median_ms(lambda: marg.scatter_add_(
            2, x_long.unsqueeze(-1), ones), 20),
        **{k: statistics.median(v) for k, v in turns.items()},
    }
    say("6 times", "per sweep call, besides the kernel: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items()))
    return parts


def flash_inputs(B, Sq, Sk, H, KVH, hd, dtype, dev, seed):
    """q (B, Sq, H, hd), k and v (B, Sk, KVH, hd), N(0, 1), from seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, Sq, H, hd), (B, Sk, KVH, hd),
                               (B, Sk, KVH, hd)))


def phase_flash_parity(dev):
    """The flash-attention kernel against its plain version: float32 at the
    test shapes (rtol 1e-4, atol 1e-5, the JAX test's tolerance), bf16 at
    every config's prefill shape, tinyllama-1.1b's also with a 1024
    window and at S = 32 (one ragged tile), and the ragged bidirectional
    shapes of each head dim, within FLASH_BF16_TOL; the same bits on a
    second launch."""
    from repro_torch.kernels import flash_attention as fa, ref
    cases = [(shape, torch.float32, dict(rtol=1e-4, atol=1e-5))
             for shape in FLASH_SHAPES]
    cases += [(shape, torch.bfloat16, FLASH_BF16_TOL) for shape in FLASH_BF16]
    errs = {}
    for k, ((B, Sq, Sk, H, KVH, hd, w, causal), dtype, tol) in enumerate(
            cases):
        q, kk, v = flash_inputs(B, Sq, Sk, H, KVH, hd, dtype, dev, seed=k)
        got = fa.flash_attention_cuda(q, kk, v, window=w, causal=causal)
        again = fa.flash_attention_cuda(q, kk, v, window=w, causal=causal)
        want = ref.flash_attention_ref(q, kk, v, window=w, causal=causal)
        torch.cuda.synchronize()
        shape = (B, Sq, Sk, H, KVH, hd, w, causal)
        check(torch.equal(got, again), f"flash_attention at {shape}: two "
              f"launches gave different bits")
        err = float((got.float() - want.float()).abs().max())
        errs[f"{shape} {str(dtype)[6:]}"] = err
        check(torch.allclose(got.float(), want.float(), **tol),
              f"flash_attention off the plain version at {shape} "
              f"{dtype}: max abs err {err}")
        del q, kk, v, got, again, want
    bf16_red = (torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction)
    say("3d flash attention", f"{len(FLASH_SHAPES)} float32 shapes within "
        f"rtol 1e-4 / atol 1e-5 (max abs err "
        f"{max(list(errs.values())[:len(FLASH_SHAPES)]):.3g}), "
        f"{len(FLASH_BF16)} bf16 shapes (B, Sq, Sk, H, KVH, hd, window, "
        f"causal) {FLASH_BF16} within {FLASH_BF16_TOL} (max abs err "
        f"{max(list(errs.values())[len(FLASH_SHAPES):]):.3g}); "
        f"same bits on a second launch; allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"allow_bf16_reduced_precision_reduction {bf16_red}")
    return dict(max_abs_err=max(errs.values()), errors=errs,
                allow_bf16_reduced_precision_reduction=bf16_red)


def attended_pairs(Sq, Sk, window, causal):
    """(query, key) pairs the mask lets through, per (batch, head)."""
    i = np.arange(Sq)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(Sk - 1, i) if causal else np.full_like(i, Sk - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound(B, Sq, Sk, H, KVH, hd, w, causal):
    """The least time in ms for one call and the term that sets it: the
    largest of the bytes (q, k, v read once, out written once, bf16) over
    the memory rate, 4*hd FLOPs per attended pair over the bf16 tensor-core
    peak, and one exponential per attended pair over the MUFU rate."""
    pairs = B * H * attended_pairs(Sq, Sk, w, causal)
    terms = {"bytes": 2 * (2 * B * Sq * H * hd + 2 * B * Sk * KVH * hd)
             / HBM_BYTES_PER_S,
             "tensor cores": 4 * hd * pairs / BF16_TC_FLOPS_PER_S,
             "exponentials": pairs / EX2_PER_S}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], term, {k: 1e3 * v for k, v in terms.items()}


def flash_times(dev):
    """At each config's prefill attention (FLASH_CONFIGS): the kernel
    (CUDA-event median), its plain version, scaled_dot_product_attention
    (enable_gqa, with is_causal or, where a window is set, the causal band
    as a boolean mask; the library yardstick, never called by the port) on
    the same tensors, and the three-term bound.  The record of
    tinyllama-1.1b's shape is the kernel's; every shape is listed under
    "configs"."""
    from repro_torch.kernels import flash_attention as fa, ref
    recs = {}
    for name, (B, Sq, Sk, H, KVH, hd, w, causal) in FLASH_CONFIGS.items():
        q, k, v = flash_inputs(B, Sq, Sk, H, KVH, hd, torch.bfloat16, dev,
                               seed=50)
        ms = per_launch_ms(
            lambda: fa.flash_attention_cuda(q, k, v, window=w,
                                             causal=causal), 20)
        pms = per_launch_ms(
            lambda: ref.flash_attention_ref(q, k, v, window=w,
                                            causal=causal), 2, reps=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if w == 0:
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            # the causal band as a boolean mask (True: attended), built
            # once outside the timed call; every row keeps its own key
            i = torch.arange(Sq, device=dev)[:, None]
            j = torch.arange(Sk, device=dev)[None, :]
            band = i - j < w
            if causal:
                band &= i >= j
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        lib = sdpa().transpose(1, 2)
        got = fa.flash_attention_cuda(q, k, v, window=w, causal=causal)
        check(torch.allclose(lib.float(), got.float(), **FLASH_BF16_TOL),
              f"scaled_dot_product_attention off the kernel at {name}")
        lms = per_launch_ms(sdpa, 20)
        del qt, kt, vt, lib, got
        bound_ms, term, terms = flash_bound(B, Sq, Sk, H, KVH, hd, w, causal)
        flops = 4 * hd * B * H * attended_pairs(Sq, Sk, w, causal)
        recs[name] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound_ms,
            bound_by="bytes" if term == "bytes" else "operations",
            bound_term=term, bound_terms_ms=terms, flops=flops,
            tflops_per_s=flops / ms / 1e9,
            shape=f"B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} hd={hd} "
                  f"window={w} {'causal' if causal else 'bidirectional'} "
                  f"bf16")
        say("6 times", f"flash_attention {name} [{recs[name]['shape']}]: "
            f"kernel {ms:.4f} ms ({recs[name]['tflops_per_s']:.1f} "
            f"TFLOP/s), plain {pms:.4f} ms, scaled_dot_product_attention "
            f"{lms:.4f} ms, bound {bound_ms:.4f} ms set by {term} ("
            + ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) + " ms)")
        del q, k, v
    rec = dict(recs["tinyllama-1.1b"])
    rec["configs"] = recs
    return rec


def _sync_ms(fn):
    """(host ms of fn() up to a synchronize, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def phase_serve(dev, smi):
    """tinyllama-1.1b at full width, weights drawn on the card from a seed,
    through the serve path's entry points (make_prefill_step,
    make_serve_step): prefill at B=8, S=2048 with the flash kernel's launch
    count reset before and read after (one launch per layer and call); 32
    greedy decode steps at B=8 from an empty cache of 2048 positions; and
    at B=1, S=32 the forward logits against 32 decode steps under the
    reference's criterion."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = get_arch(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t_init, model = _sync_ms(lambda: T.init_params(cfg, SERVE_SEED,
                                                   device=dev))
    check(T.param_count(cfg) == sum(p.numel() for p in model.parameters()),
          "tinyllama-1.1b: the model's parameters != param_count")
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    toks = torch.randint(1, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                         generator=gen, device=dev)
    prefill = steps.make_prefill_step(cfg)
    reset_launches()
    times = []
    for _ in range(PREFILL_CALLS):
        ms, logits = _sync_ms(lambda: prefill(model, {"tokens": toks}))
        times.append(ms)
    launches = fa.flash_attention_cuda.launches
    counts = read_launches()
    check(launches == cfg.num_layers * PREFILL_CALLS,
          f"prefill: {launches} flash-attention launches in "
          f"{PREFILL_CALLS} calls, expected {cfg.num_layers} per call")
    check(all(n == 0 for k, n in counts.items() if k != "flash_attention"),
          f"prefill launched other kernels: {counts}")
    check(tuple(logits.shape) == (PREFILL_B, T._pad_vocab(cfg.vocab_size))
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "prefill logits not finite float32 (B, vocab_padded)")
    prefill_ms = statistics.median(times[1:])      # the first warms up

    serve = steps.make_serve_step(cfg)
    cache = T.init_cache(cfg, DECODE_B, PREFILL_S, device=dev)
    tok = toks[:DECODE_B, :1]

    def step():
        nonlocal tok, cache
        lg, cache = serve(model, tok, cache)
        tok = torch.argmax(lg, dim=-1, keepdim=True)
        return lg
    step_ms = []
    for _ in range(DECODE_STEPS):
        ms, lg = _sync_ms(step)
        step_ms.append(ms)
    check(cache["length"] == DECODE_STEPS
          and bool(torch.isfinite(lg).all()),
          "decode: cache length or logits wrong")
    decode_ms = statistics.median(step_ms[1:])     # the first warms up
    # where the time goes: one more prefill call and decode step, traced
    prof = dict(prefill=device_busy(lambda: prefill(model, {"tokens": toks})),
                decode_step=device_busy(step))

    before = fa.flash_attention_cuda.launches
    diff, agree = forward_vs_decode(cfg, model, toks[:1, :CHECK_S])
    check(fa.flash_attention_cuda.launches - before == cfg.num_layers,
          "forward at S=32 did not run the flash kernel in every layer")
    check(diff < SELF_TOL and agree >= SELF_AGREE,
          f"decode vs forward at B=1, S={CHECK_S}: log-softmax max abs diff "
          f"{diff:.4f} (< {SELF_TOL}), argmax agreement {agree:.3f} "
          f"(>= {SELF_AGREE})")
    rec = dict(arch=SERVE_ARCH, params=T.param_count(cfg), seed=SERVE_SEED,
               init_ms=t_init, prefill_ms=prefill_ms, prefill_ms_all=times,
               prefill_tokens_per_s=PREFILL_B * PREFILL_S / prefill_ms * 1e3,
               prefill_calls=PREFILL_CALLS, flash_launches=launches,
               decode_ms_per_step=decode_ms, decode_ms_all=step_ms,
               decode_tokens_per_s=DECODE_B / decode_ms * 1e3,
               profile=prof,
               decode_vs_forward=dict(max_abs_logsoftmax=diff,
                                      argmax_agree=agree),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=smi)
    say("7 serve", f"{SERVE_ARCH} ({rec['params']} params, weights from seed "
        f"{SERVE_SEED}) on {smi}: prefill B={PREFILL_B} S={PREFILL_S} "
        f"{prefill_ms:.2f} ms/call ({rec['prefill_tokens_per_s']:.0f} "
        f"tokens/s; calls {[round(t, 2) for t in times]} ms), "
        f"{launches} flash launches in {PREFILL_CALLS} calls; decode "
        f"B={DECODE_B} {decode_ms:.3f} ms/step median of steps 2-"
        f"{DECODE_STEPS} (first {step_ms[0]:.1f} ms; "
        f"{rec['decode_tokens_per_s']:.0f} tokens/s); decode vs forward at "
        f"B=1 S={CHECK_S}: log-softmax max abs diff {diff:.4f}, argmax "
        f"agreement {agree:.3f}; peak memory "
        f"{rec['peak_memory_gb']:.2f} GB")
    for k, r in prof.items():
        say("7 serve", f"{k} traced: wall {r['profiled_wall_ms']:.2f} ms, "
            f"device busy {r['device_busy_ms']:.2f} ms (idle "
            f"{1 - r['device_busy_ms'] / r['profiled_wall_ms']:.3f}), top "
            f"device ops " + ", ".join(f"{n} {ms:.3f}" for n, ms in
                                       r['top_device_ops_ms'].items()))
    return rec


def phase_wide_prefill(dev, smi):
    """The configs whose head dims the flash kernel pads to 128 and 256, at
    full width with weights drawn on the card from a seed, through
    make_prefill_step: one warm-up call, then one call with the launch
    counts reset before and read after (one flash launch per layer, no
    other kernel of the port), finite float32 logits; each model is freed
    before the next."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    recs = {}
    for arch, B, S in WIDE_PREFILL:
        cfg = get_arch(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_init, model = _sync_ms(lambda: T.init_params(cfg, SERVE_SEED,
                                                       device=dev))
        check(T.param_count(cfg)
              == sum(x.numel() for x in model.parameters()),
              f"{arch}: the model's parameters != param_count")
        gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
        toks = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                             device=dev)
        prefill = steps.make_prefill_step(cfg)
        first_ms, _ = _sync_ms(lambda: prefill(model, {"tokens": toks}))
        reset_launches()
        ms, logits = _sync_ms(lambda: prefill(model, {"tokens": toks}))
        counts = read_launches()
        check(counts["flash_attention"] == cfg.num_layers
              and all(n == 0 for k, n in counts.items()
                      if k != "flash_attention"),
              f"{arch} prefill: launches {counts}, expected "
              f"{cfg.num_layers} flash-attention launches and no other")
        check(tuple(logits.shape) == (B, T._pad_vocab(cfg.vocab_size))
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits not finite float32 (B, vocab_padded)")
        recs[arch] = dict(
            params=T.param_count(cfg), B=B, S=S, head_dim=cfg.head_dim,
            windows=sorted(set(cfg.window_pattern)), init_ms=t_init,
            first_call_ms=first_ms, prefill_ms=ms,
            prefill_tokens_per_s=B * S / ms * 1e3,
            flash_launches=counts["flash_attention"],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            card=smi)
        say("7 serve", f"{arch} ({recs[arch]['params']} params, hd "
            f"{cfg.head_dim}, windows {recs[arch]['windows']}, weights from "
            f"seed {SERVE_SEED}) on {smi}: prefill B={B} S={S} {ms:.2f} ms "
            f"({recs[arch]['prefill_tokens_per_s']:.0f} tokens/s; first "
            f"call {first_ms:.2f} ms), {counts['flash_attention']} flash "
            f"launches in one call; peak memory "
            f"{recs[arch]['peak_memory_gb']:.2f} GB")
        del model, logits, toks
    torch.cuda.empty_cache()
    return recs

# ---------------------------------------------------------------------------
# phase 7f: the SSM and hybrid families
# ---------------------------------------------------------------------------

def scan_inputs(bsz, S, di, N, dev, seed):
    """The scan's inputs as a mamba layer hands them over, from a seed: dt
    = softplus(N(0, 1) - 4.6) (the init's dt_bias), x, B, C N(0, 1), z the
    gate half of a (bsz, S, 2 di) bf16 projection (a row-strided view, read
    in place), A = -exp(bf16(log(1..N))) per channel, D one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(r(bsz, S, di) - 4.6)
    x = r(bsz, S, di)
    z = r(bsz, S, 2 * di).to(torch.bfloat16)[..., di:]
    B, C = r(bsz, S, N), r(bsz, S, N)
    A = -torch.exp(torch.log(torch.arange(
        1, N + 1, dtype=torch.float32, device=dev)).to(torch.bfloat16)
        .float()).expand(di, N).contiguous()
    return dt, x, z, B, C, A, torch.ones(di, device=dev)


def scan_bound(bsz, S, di, N):
    """(least ms, "bytes" or "operations", the terms): dt and x read as
    float32, z as bf16, B and C as float32, A and D once, y written as
    bf16, over the memory rate; N + 1 exponentials per (b, t, d) (the
    decays and silu's) over the MUFU rate; 6 N + 6 float32 operations per
    (b, t, d) over the FP32 rate."""
    elems = bsz * S * di
    terms = {"bytes": (12 * elems + 8 * bsz * S * N + 4 * di * (N + 1))
             / HBM_BYTES_PER_S,
             "exponentials": (N + 1) * elems / EX2_PER_S,
             "fp32": (6 * N + 6) * elems / FP32_OPS_PER_S}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            {k: 1e3 * v for k, v in terms.items()})


def scan_parity(dev):
    """The scan kernel against its plain version on the card at
    SCAN_SHAPES (the SCAN_TIMED layer shapes, then the ragged ones and the
    layout's edges), within SCAN_TOL, the same bits on a second launch, and
    the layout the library takes equal to ``scan_layout``'s; at the
    SCAN_TIMED shapes its time per launch (a stream of 20) beside the
    layout, the plain version's time and the bound."""
    from repro_torch.kernels import ref, selective_scan as ss
    errs, times, layouts = {}, {}, {}
    for k, shape in enumerate(SCAN_SHAPES):
        ins = scan_inputs(*shape, dev, seed=300 + k)
        got = ss.selective_scan_cuda(*ins)
        again = ss.selective_scan_cuda(*ins)
        want = ref.selective_scan_ref(*ins)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"selective_scan at {shape}: two "
              f"launches gave different bits")
        diff = (got.float() - want.float()).abs()
        errs[str(shape)] = float(diff.max())
        check(torch.allclose(got.float(), want.float(), **SCAN_TOL),
              f"selective_scan off the plain version at {shape}: max abs "
              f"err {errs[str(shape)]}")
        layout = ss.scan_layout(*shape)
        built = ss.kernel_layout(*shape)
        check(built == {key: layout[key] for key in built},
              f"selective_scan at {shape}: the library's layout {built}, "
              f"scan_layout's {layout}")
        layouts[str(shape)] = layout
        name = next((a for a, sh in SCAN_TIMED.items() if sh == shape), None)
        if name is not None:
            ms = per_launch_ms(lambda: ss.selective_scan_cuda(*ins), 20)
            pms = per_launch_ms(lambda: ref.selective_scan_ref(*ins), 1,
                                reps=1)
            bms, by, terms = scan_bound(*shape)
            bsz, S, di, N = shape
            times[name] = dict(
                ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                bound_terms_ms=terms, library_ms=None, layout=layout,
                shape=f"bsz={bsz} S={S} d_inner={di} N={N} ({name} layer)")
            say("7f ssm serve", f"selective_scan [{times[name]['shape']}; "
                f"{layout['lanes']} lanes a channel, {layout['tile']}-step "
                f"tiles, {layout['warps_per_scheduler']:.2f} warps a "
                f"scheduler]: kernel {ms:.4f} ms per launch, plain "
                f"{pms:.2f} ms, bound {bms:.4f} ms set by {by} (" + ", ".join(
                    f"{n} {v:.4f}" for n, v in terms.items()) + " ms)")
        del ins, got, again, want, diff
    say("7f ssm serve", f"selective_scan at {len(SCAN_SHAPES)} shapes "
        f"(bsz, S, d_inner, N) {SCAN_SHAPES} within {SCAN_TOL} of the plain "
        f"version (max abs err {max(errs.values()):.3g}), the same bits on "
        f"a second launch, lanes a channel "
        f"{[layouts[str(sh)]['lanes'] for sh in SCAN_SHAPES]} as "
        f"scan_layout gives them")
    return dict(max_abs_err=max(errs.values()), errors=errs,
                layouts=layouts), times


@contextlib.contextmanager
def plain_calls(names):
    """Counts the calls of the plain versions ``names`` through
    ``kernels.ops`` (the route a CPU tensor takes) while the body runs:
    on the card a prefill or a training step must make none."""
    from repro_torch.kernels import ops
    reals, calls = {n: getattr(ops, n) for n in names}, []

    def counted(real):
        def fn(*args, **kw):
            calls.append(real.__name__)
            return real(*args, **kw)
        return fn
    for n, real in reals.items():
        setattr(ops, n, counted(real))
    try:
        yield calls
    finally:
        for n, real in reals.items():
            setattr(ops, n, real)


def ssm_model(arch, B, S, dev, smi):
    """One SSM or hybrid config at full width and depth, weights from a
    seed: prefill (a warm-up call, then SSM_PREFILL_CALLS calls with the
    launch counts reset before and read after: the scan kernel once per
    layer and call, the flash kernel too where the layers attend, nothing
    else, the plain scan never called; one more call traced), the float32
    w_x / w_dt products of one layer timed alone, 32 greedy decode steps at
    DECODE_B; at B=1 S=CHECK_S every layer's decode against its prefill
    path on the same input (within LAYER_GAP_TOL) and the forward's logits
    against as many decode steps (recorded); then the reference's
    criterion on the config cut to SSM_GATE_LAYERS layers, full width."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init, model = _sync_ms(lambda: T.init_params(cfg, SERVE_SEED,
                                                   device=dev))
    check(T.param_count(cfg) == sum(x.numel() for x in model.parameters()),
          f"{arch}: the model's parameters != param_count")
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    toks = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    prefill = steps.make_prefill_step(cfg)
    call = lambda: prefill(model, {"tokens": toks})
    first_ms, _ = _sync_ms(call)
    L = cfg.num_layers
    want = {"selective_scan": L * SSM_PREFILL_CALLS,
            "flash_attention": L * SSM_PREFILL_CALLS * cfg.has_attention}
    with plain_calls(("selective_scan_ref",)) as plain:
        reset_launches()
        times = []
        for _ in range(SSM_PREFILL_CALLS):
            ms, logits = _sync_ms(call)
            times.append(ms)
        counts = read_launches()
        prof = device_busy(call, ("selective_scan_kernel",
                                  "flash_bf16_kernel"), top=8)
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{arch} prefill: launches {counts} in {SSM_PREFILL_CALLS} calls, "
          f"expected {want} and no other")
    check(not plain, f"{arch} prefill called the plain scan {len(plain)} "
          f"times")
    traced = {k: v["launches"] for k, v in prof["kernels"].items()}
    check(traced == {"selective_scan_kernel": L,
                     "flash_bf16_kernel": L * cfg.has_attention},
          f"{arch}: the traced prefill call launched {traced}")
    check(tuple(logits.shape) == (B, T._pad_vocab(cfg.vocab_size))
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{arch}: prefill logits not finite float32 (B, vocab_padded)")
    prefill_ms = statistics.median(times)
    busy = prof["device_busy_ms"]
    scan_ms = prof["kernels"]["selective_scan_kernel"]["device_ms"]

    # the reference's float32 products of the mamba block (xc @ w_x and
    # proj[..., :dt_rank] @ w_dt, the weights widened per call as the port
    # does), one layer at this shape, times the layers
    w = model.layers[0].ssm.weights()
    xc = torch.randn((B, S, cfg.d_inner), generator=gen, device=dev)
    proj = xc @ w["w_x"].float()
    r = cfg.dt_rank
    f32_ms = L * (median_ms(lambda: xc @ w["w_x"].float(), 5)
                  + median_ms(lambda: proj[..., :r] @ w["w_dt"].float(), 5))
    del xc, proj, w

    serve = steps.make_serve_step(cfg)
    cache = T.init_cache(cfg, DECODE_B, S, device=dev)
    tok = toks[:DECODE_B, :1] if B >= DECODE_B else toks[:1, :1].expand(
        DECODE_B, 1).contiguous()

    def step():
        nonlocal tok, cache
        lg, cache = serve(model, tok, cache)
        tok = torch.argmax(lg, dim=-1, keepdim=True)
        return lg
    step_ms = []
    for _ in range(DECODE_STEPS):
        ms, lg = _sync_ms(step)
        step_ms.append(ms)
    check(cache["length"] == DECODE_STEPS
          and bool(torch.isfinite(lg).all()),
          f"{arch} decode: cache length or logits wrong")
    decode_ms = statistics.median(step_ms[1:])     # the first warms up
    decode_prof = device_busy(step)

    one = toks[:1, :CHECK_S]
    gaps, _ = T.decode_gap_by_layer(cfg, model, one)
    check(max(gaps) < LAYER_GAP_TOL,
          f"{arch}: decode off the prefill path in layer "
          f"{int(np.argmax(gaps))}: gap {max(gaps):.4f} (< {LAYER_GAP_TOL})")
    # end to end at full depth: recorded, not gated (see SSM_GATE_LAYERS)
    diff, agree = forward_vs_decode(cfg, model, one)
    del model, logits, toks, cache
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, name=f"{arch} {SSM_GATE_LAYERS} layers",
                              num_layers=SSM_GATE_LAYERS)
    model = T.init_params(cut, SERVE_SEED, device=dev)
    cut_diff, cut_agree = forward_vs_decode(cut, model, one)
    check(cut_diff < SELF_TOL and cut_agree >= SELF_AGREE,
          f"{arch} cut to {SSM_GATE_LAYERS} layers: decode vs forward at "
          f"B=1, S={CHECK_S}: log-softmax max abs diff {cut_diff:.4f} (< "
          f"{SELF_TOL}), argmax agreement {cut_agree:.3f} (>= "
          f"{SELF_AGREE})")
    rec = dict(
        params=T.param_count(cfg), B=B, S=S, seed=SERVE_SEED, init_ms=t_init,
        first_call_ms=first_ms, prefill_ms=prefill_ms, prefill_ms_all=times,
        prefill_tokens_per_s=B * S / prefill_ms * 1e3, launches=counts,
        plain_scan_calls=len(plain), profile=prof,
        scan_share_of_busy=scan_ms / busy,
        f32_gemm_ms=f32_ms, f32_gemm_share=f32_ms / prefill_ms,
        decode_ms_per_step=decode_ms, decode_ms_all=step_ms,
        decode_tokens_per_s=DECODE_B / decode_ms * 1e3,
        decode_profile=decode_prof, decode_gap_by_layer=gaps,
        decode_vs_forward=dict(max_abs_logsoftmax=diff, argmax_agree=agree),
        decode_vs_forward_cut=dict(layers=SSM_GATE_LAYERS,
                                   max_abs_logsoftmax=cut_diff,
                                   argmax_agree=cut_agree),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
    say("7f ssm serve", f"{arch} ({rec['params']} params, weights from seed "
        f"{SERVE_SEED}) on {smi}: prefill B={B} S={S} {prefill_ms:.2f} ms "
        f"({rec['prefill_tokens_per_s']:.0f} tokens/s; calls "
        f"{[round(t, 2) for t in times]} ms, first {first_ms:.1f}), "
        f"launches {counts['selective_scan']} scan / "
        f"{counts['flash_attention']} flash in {SSM_PREFILL_CALLS} calls, "
        f"no plain scan; decode B={DECODE_B} {decode_ms:.3f} ms/step "
        f"({rec['decode_tokens_per_s']:.0f} tokens/s); at B=1 S={CHECK_S} "
        f"each layer's decode within {max(gaps):.4f} of its prefill path "
        f"(median {statistics.median(gaps):.4f}), decode vs forward "
        f"log-softmax max abs diff {diff:.4f}, argmax agreement {agree:.3f} "
        f"at full depth (not gated), {cut_diff:.4f} / {cut_agree:.3f} at "
        f"{SSM_GATE_LAYERS} layers; peak memory "
        f"{rec['peak_memory_gb']:.2f} GB")
    say("7f ssm serve", f"{arch} prefill traced: wall "
        f"{prof['profiled_wall_ms']:.2f} ms, device busy {busy:.2f} ms (idle "
        f"{1 - busy / prof['profiled_wall_ms']:.3f}); scan kernel "
        f"{prof['kernels']['selective_scan_kernel']['launches']} launches "
        f"{scan_ms:.3f} ms ({rec['scan_share_of_busy']:.3f} of busy); flash "
        f"{prof['kernels']['flash_bf16_kernel']['launches']} launches "
        f"{prof['kernels']['flash_bf16_kernel']['device_ms']:.3f} ms; float32 "
        f"w_x / w_dt products {f32_ms:.2f} ms per call "
        f"({rec['f32_gemm_share']:.3f} of the call); top device ops "
        + ", ".join(f"{n} {t:.3f}" for n, t in
                    prof["top_device_ops_ms"].items()))
    say("7f ssm serve", f"{arch} decode step traced: wall "
        f"{decode_prof['profiled_wall_ms']:.2f} ms, device busy "
        f"{decode_prof['device_busy_ms']:.2f} ms; top device ops "
        + ", ".join(f"{n} {t:.3f}" for n, t in
                    decode_prof["top_device_ops_ms"].items()))
    del model
    torch.cuda.empty_cache()
    return rec


def forward_vs_decode(cfg, model, toks, quantile=None):
    """(log-softmax max abs diff, argmax agreement) of the forward's logits
    against as many decode steps from an empty cache, tokens (1, S): the
    reference's criterion (tests/test_models.py:92-99).  With ``quantile``
    (its MoE rule) the diff is that quantile over positions of each
    position's max."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    with torch.no_grad():
        fwd = (T.forward(cfg, model, toks) @ model.head()).float()
    serve = steps.make_serve_step(cfg)
    cache = T.init_cache(cfg, 1, toks.shape[1], device=toks.device)
    dec = torch.stack([serve(model, toks[:, s:s + 1], cache)[0]
                       for s in range(toks.shape[1])], dim=1)
    per_pos = (torch.log_softmax(fwd, -1)
               - torch.log_softmax(dec, -1)).abs().amax(dim=(0, 2))
    diff = float(per_pos.max() if quantile is None
                 else torch.quantile(per_pos, quantile))
    return diff, float((fwd.argmax(-1) == dec.argmax(-1)).float().mean())


def phase_ssm_serve(dev, smi):
    """Phase 7f: the scan kernel against its plain version (scan_parity),
    then falcon-mamba-7b and hymba-1.5b at full width and depth
    (ssm_model); the launches of both models' counted prefills, summed."""
    t0 = time.perf_counter()
    parity, times = scan_parity(dev)
    torch.cuda.empty_cache()
    models = {arch: ssm_model(arch, B, S, dev, smi)
              for arch, B, S in SSM_SERVE}
    launches = {k: sum(m["launches"][k] for m in models.values())
                for k in ("selective_scan", "flash_attention")}
    rec = dict(parity=parity, times=dict(times["falcon-mamba-7b"],
                                         configs=times),
               models=models, launches=launches,
               seconds=time.perf_counter() - t0)
    rec["times"]["max_abs_err"] = parity["max_abs_err"]
    say("7f ssm serve", f"{rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 7m: the MoE family
# ---------------------------------------------------------------------------

def moe_drops(model, call):
    """Per MoE layer, the share of its T * k assignments dropped at the
    config's capacity in one ``call()``: a forward hook runs each layer's
    router and dispatch (``models/moe.py``) again on the layer's input."""
    from repro_torch.models import moe as M
    cfg, drops = model.cfg, []

    def hook(mod, inputs, _out):
        h = inputs[0].reshape(-1, cfg.d_model)
        _, ids, _ = M.router_topk(h, mod.router, cfg.top_k)
        cap = M.capacity(h.shape[0], cfg.top_k, cfg.num_experts,
                         cfg.moe_capacity_factor)
        drops.append(1.0 - M.dispatch_slots(ids, cfg.num_experts, cap)[1]
                     .float().mean())
    handles = [layer.moe.register_forward_hook(hook)
               for layer in model.layers]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    return [float(d) for d in drops]


def moe_prefill(cfg, model, B, S, dev):
    """One prefill shape of phase 7m: a warm-up call, then
    MOE_PREFILL_REPS calls timed by CUDA events (median) with the launch
    counts reset before and read after (one flash launch per layer and
    call, nothing else, the plain attention never called), finite float32
    logits, the peak memory, the model-FLOPs share (2 N_active per token
    over the bf16 tensor-core peak) and the dropped share per layer.
    Returns (record, tokens, the call)."""
    from repro_torch.launch import steps
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    toks = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    prefill = steps.make_prefill_step(cfg)
    call = lambda: prefill(model, {"tokens": toks})
    torch.cuda.reset_peak_memory_stats()
    first_ms, _ = _sync_ms(call)
    with plain_calls(("flash_attention_ref",)) as plain:
        reset_launches()
        ms, logits = timed(call, MOE_PREFILL_REPS, warmup=0)
        counts = read_launches()
    L = cfg.num_layers
    want = {"flash_attention": L * MOE_PREFILL_REPS}
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{cfg.name} prefill B={B} S={S}: launches {counts} in "
          f"{MOE_PREFILL_REPS} calls, expected {want} and no other")
    check(not plain, f"{cfg.name} prefill called the plain attention")
    check(tuple(logits.shape) == (B, T._pad_vocab(cfg.vocab_size))
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name}: prefill logits not finite float32 (B, vocab_padded)")
    n_active = T.active_param_count(cfg)
    rec = dict(
        B=B, S=S, first_call_ms=first_ms, prefill_ms=ms,
        prefill_tokens_per_s=B * S / ms * 1e3,
        model_flops_share=2 * n_active * B * S / (ms / 1e3)
        / BF16_TC_FLOPS_PER_S,
        flash_launches_per_call=counts["flash_attention"] / MOE_PREFILL_REPS,
        launches=counts,
        capacity=M.capacity(B * S, cfg.top_k, cfg.num_experts,
                            cfg.moe_capacity_factor),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        dropped_by_layer=moe_drops(model, call))
    return rec, toks, call


def moe_ffn_loop(xt, p, ids, weights, cap):
    """The plain version of ``moe.moe_ffn`` (no shared experts) for given
    ids and weights (T, k): expert by expert, its assignments in
    token-major order (``nonzero``), the first ``cap`` kept, their rows
    through the expert's three products; each kept assignment's output
    times its weight (rounded to bf16, as there), added in slot order.
    Returns (out (T, d) bf16, slot, keep) of the T * k assignments."""
    T, k = ids.shape
    E = p["router"].shape[-1]
    flat = ids.reshape(-1).long()
    keep = torch.zeros(T * k, dtype=torch.bool, device=xt.device)
    slot = torch.full((T * k,), E * cap, dtype=torch.long, device=xt.device)
    contrib = torch.zeros((T * k, xt.shape[1]), dtype=xt.dtype,
                          device=xt.device)
    w = weights.reshape(-1).to(xt.dtype)
    for e in range(E):
        a = (flat == e).nonzero()[:cap, 0]
        keep[a] = True
        slot[a] = e * cap + torch.arange(len(a), device=xt.device)
        rows = xt[a // k]
        h = (torch.nn.functional.silu(rows @ p["w_gate"][e])
             * (rows @ p["w_up"][e]))
        contrib[a] = (h @ p["w_down"][e]) * w[a, None]
    contrib = contrib.view(T, k, -1)
    out = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        out = out + contrib[:, j]
    return out, slot, keep


def moe_layer_check(cfg, layer, dev):
    """One MoE layer of ``cfg`` at its width on the card: ``router_topk``'s
    ids against ``torch.topk`` of the same float32 probabilities away from
    near-ties, ``dispatch_slots``' slots and keep mask equal to the plain
    loop's (``moe_ffn_loop``) exactly, and ``moe_ffn`` (run with no host
    sync) within MOE_FFN_MAX / MOE_FFN_MEAN of it, at MOE_CHECK_T tokens
    and capacity factor 1.25 on inputs skewed toward expert 0."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    p = {k: T._compute(w) for k, w in layer.moe.named_parameters()}
    k, E, cf = cfg.top_k, cfg.num_experts, 1.25
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 2)
    xt = torch.randn((MOE_CHECK_T, cfg.d_model), generator=gen, device=dev)
    r0 = p["router"][:, 0].float()
    xt = (xt + MOE_CHECK_SKEW * r0 / r0.square().sum()).to(p["router"].dtype)
    weights, ids, _ = M.router_topk(xt, p["router"], k)
    cap = M.capacity(MOE_CHECK_T, k, E, cf)
    slot, keep = M.dispatch_slots(ids, E, cap)
    with no_host_sync():
        got = M.moe_ffn(xt[None], p, top_k=k, capacity_factor=cf)[0]
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1)
    clear = top.values[:, k - 1] - top.values[:, k] > MOE_NEAR_TIE
    check(torch.equal(ids[clear].long(), top.indices[clear, :k]),
          f"{cfg.name}: router ids off torch.topk away from near-ties")
    plain_cap = max(k, int(cf * MOE_CHECK_T * k / E))
    want, pslot, pkeep = moe_ffn_loop(xt, p, ids, weights, plain_cap)
    check(cap == plain_cap and torch.equal(keep, pkeep)
          and torch.equal(slot, pslot),
          f"{cfg.name}: the dispatch's slots or keep mask off the plain "
          f"per-expert loop's")
    diff = (got.float() - want.float()).abs()
    rec = dict(tokens=MOE_CHECK_T, capacity=cap,
               near_ties=int((~clear).sum()),
               dropped=float(1 - keep.float().mean()),
               expert0_assignments=int((ids == 0).sum()),
               max_abs_err=float(diff.max()), mean_abs_err=float(diff.mean()),
               max_abs_out=float(want.float().abs().max()))
    check(rec["max_abs_err"] <= MOE_FFN_MAX
          and rec["mean_abs_err"] <= MOE_FFN_MEAN,
          f"{cfg.name}: moe_ffn on the card off the plain per-expert loop: "
          f"max abs {rec['max_abs_err']:.4g} (<= {MOE_FFN_MAX}), mean "
          f"{rec['mean_abs_err']:.4g} (<= {MOE_FFN_MEAN})")
    return rec


def phase_moe_serve(dev, smi):
    """Phase 7m: mixtral-8x7b at full width cut to MOE_LAYERS layers,
    weights from a seed, capacity factor 1.25: prefill at each MOE_PREFILL
    shape (moe_prefill), DECODE_STEPS greedy decode steps at B=DECODE_B
    from an empty cache of MOE_DECODE_S positions beside their byte bound
    (every weight but the embedding table read once a step; the bucketed
    product reads every expert); then, after the timings, one B=DECODE_B
    prefill call and one decode step traced, and one such prefill under
    ``set_sync_debug_mode("error")``, and the decode timed again after
    those traces (the same process and host: whether a profiler's session
    slows the host-bound step); then dropless (MOE_DROPLESS) at B=1
    S=CHECK_S every layer's decode against its prefill path (within
    LAYER_GAP_TOL by the MoE rule) and the forward's logits against as
    many decode steps (recorded at MOE_LAYERS layers, gated at
    SSM_GATE_LAYERS, the reference's criterion with its MoE quantile); and
    on the cut's first layer ``moe_layer_check`` at capacity factor 1.25."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    quant = T.MOE_GAP_QUANTILE
    t0 = time.perf_counter()
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, name=f"{MOE_ARCH} {MOE_LAYERS} layers",
                              num_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init, model = _sync_ms(lambda: T.init_params(cfg, SERVE_SEED,
                                                   device=dev))
    n_params = sum(x.numel() for x in model.parameters())
    check(n_params == T.param_count(cfg),
          f"{cfg.name}: the model's parameters != param_count")
    rec = dict(arch=MOE_ARCH, layers=MOE_LAYERS,
               full_layers=full.num_layers, params=n_params,
               active_params=T.active_param_count(cfg),
               full_params=T.param_count(full), seed=SERVE_SEED,
               capacity_factor=cfg.moe_capacity_factor, init_ms=t_init,
               load_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=smi)
    say("7m moe serve", f"{cfg.name}: {n_params} parameters ({MOE_ARCH} "
        f"whole: {rec['full_params']}), {rec['active_params']} active a "
        f"token, weights from seed {SERVE_SEED} on {smi} in {t_init:.0f} "
        f"ms; memory after load {rec['load_memory_gb']:.2f} GB")
    prefills = {}
    for B, S in MOE_PREFILL:
        r, toks, call = moe_prefill(cfg, model, B, S, dev)
        prefills[f"B={B} S={S}"] = r
        drops = r["dropped_by_layer"]
        say("7m moe serve", f"prefill B={B} S={S}: {r['prefill_ms']:.2f} ms "
            f"a call (median of {MOE_PREFILL_REPS}, CUDA events; first "
            f"{r['first_call_ms']:.1f} ms), {r['prefill_tokens_per_s']:.0f} "
            f"tokens/s, model-FLOPs share {r['model_flops_share']:.4f}, "
            f"{r['flash_launches_per_call']:.0f} flash launches a call, "
            f"capacity {r['capacity']} rows an expert, dropped "
            f"{statistics.mean(drops):.4f} of the assignments (layers "
            f"{min(drops):.4f}-{max(drops):.4f}: "
            f"{[round(d, 4) for d in drops]}); peak memory "
            f"{r['peak_memory_gb']:.2f} GB")
        if B == DECODE_B:
            traced, traced_name = call, f"B={B} S={S}"
            decode_toks = toks[:DECODE_B, :1]
            one = toks[:1, :CHECK_S].clone()
    rec["prefill"] = prefills

    serve = steps.make_serve_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    cache = T.init_cache(cfg, DECODE_B, MOE_DECODE_S, device=dev)
    tok = decode_toks

    def step():
        nonlocal tok, cache
        lg, cache = serve(model, tok, cache)
        tok = torch.argmax(lg, dim=-1, keepdim=True)
        return lg
    step_ms = []
    for _ in range(DECODE_STEPS):
        ms, lg = _sync_ms(step)
        step_ms.append(ms)
    check(cache["length"] == DECODE_STEPS
          and bool(torch.isfinite(lg).all()),
          f"{cfg.name} decode: cache length or logits wrong")
    decode_ms = statistics.median(step_ms[1:])     # the first warms up
    decode_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # traced after the timings, which a profiler's session could slow
    prof = device_busy(traced, ("flash_bf16_kernel",), top=8)
    decode_prof = device_busy(step)
    with no_host_sync():
        logits = traced()
    torch.cuda.synchronize()
    length = cache["length"]       # device_busy may profile a step again
    after = [_sync_ms(step) for _ in range(DECODE_STEPS)]
    after_ms, lg = [ms for ms, _ in after], after[-1][1]
    del after
    check(cache["length"] == length + DECODE_STEPS
          and bool(torch.isfinite(lg).all()),
          f"{cfg.name} decode after the traces: cache length or logits "
          f"wrong")
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: the prefill without host syncs gave non-finite "
          f"logits")
    prefills[traced_name].update(profile=prof, host_syncs=0)
    busy = prof["device_busy_ms"]
    say("7m moe serve", f"prefill {traced_name} traced: wall "
        f"{prof['profiled_wall_ms']:.2f} ms, device busy {busy:.2f} ms (idle "
        f"{1 - busy / prof['profiled_wall_ms']:.3f}); flash "
        f"{prof['kernels']['flash_bf16_kernel']['launches']} launches "
        f"{prof['kernels']['flash_bf16_kernel']['device_ms']:.3f} ms; top "
        f"device ops " + ", ".join(f"{n} {t:.3f}" for n, t in
                                   prof["top_device_ops_ms"].items()))
    say("7m moe serve", f"prefill {traced_name} under "
        f"set_sync_debug_mode('error'): no host sync")
    # the least a step moves: every weight once but the embedding table (B
    # rows of it), and the K/V rows of the positions it attends
    embed = model.embed
    kv = cache["slots"][0]["kv"]["k"]
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in model.parameters()) - embed.numel() \
        * embed.element_size()
    step_bytes = (weight_bytes + DECODE_B * cfg.d_model * embed.element_size()
                  + 2 * cfg.num_layers * DECODE_B * cfg.num_kv_heads
                  * DECODE_STEPS * cfg.head_dim * kv.element_size())
    rec.update(
        decode_ms_per_step=decode_ms, decode_ms_all=step_ms,
        decode_tokens_per_s=DECODE_B / decode_ms * 1e3,
        decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
        decode_bound_bytes=step_bytes, decode_profile=decode_prof,
        decode_peak_memory_gb=decode_peak_gb,
        decode_ms_after_traces=statistics.median(after_ms),
        decode_ms_all_after_traces=after_ms)
    busy = decode_prof["device_busy_ms"]
    say("7m moe serve", f"decode B={DECODE_B} from an empty "
        f"{MOE_DECODE_S}-position cache: {decode_ms:.3f} ms a step (median "
        f"of steps 2-{DECODE_STEPS}; first {step_ms[0]:.1f} ms; "
        f"{rec['decode_tokens_per_s']:.1f} tokens/s) against a byte bound "
        f"of {rec['decode_bound_ms']:.3f} ms ({step_bytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak memory "
        f"{rec['decode_peak_memory_gb']:.2f} GB; one step traced: wall "
        f"{decode_prof['profiled_wall_ms']:.2f} ms, device busy "
        f"{busy:.2f} ms (idle "
        f"{1 - busy / decode_prof['profiled_wall_ms']:.3f}); top device ops "
        + ", ".join(f"{n} {t:.3f}" for n, t in
                    decode_prof["top_device_ops_ms"].items())
        + f"; after the traces {rec['decode_ms_after_traces']:.3f} ms a "
        f"step (median of {DECODE_STEPS}; before them {decode_ms:.3f})")
    del model, cache, lg, tok, decode_toks, logits, traced, call
    torch.cuda.empty_cache()

    # the gates, dropless, on the same weights (the seed draws them alike
    # whatever the capacity factor)
    dropless = dataclasses.replace(cfg, moe_capacity_factor=MOE_DROPLESS)
    model = T.init_params(dropless, SERVE_SEED, device=dev)
    gaps, gap_max = T.decode_gap_by_layer(dropless, model, one)
    check(max(gaps) < LAYER_GAP_TOL,
          f"{cfg.name}: decode off the prefill path in layer "
          f"{int(np.argmax(gaps))}: gap {max(gaps):.4f} (< {LAYER_GAP_TOL}, "
          f"the {quant} quantile over positions)")
    diff, agree = forward_vs_decode(dropless, model, one,
                                    quantile=quant)
    del model
    torch.cuda.empty_cache()
    cut = dataclasses.replace(dropless, name=f"{MOE_ARCH} "
                              f"{SSM_GATE_LAYERS} layers",
                              num_layers=SSM_GATE_LAYERS)
    model = T.init_params(cut, SERVE_SEED, device=dev)
    cut_diff, cut_agree = forward_vs_decode(cut, model, one,
                                            quantile=quant)
    check(cut_diff < SELF_TOL and cut_agree >= SELF_AGREE,
          f"{cut.name}: decode vs forward at B=1, S={CHECK_S}: log-softmax "
          f"diff {cut_diff:.4f} ({quant} quantile over positions, < "
          f"{SELF_TOL}), argmax agreement {cut_agree:.3f} (>= {SELF_AGREE})")
    layer_rec = moe_layer_check(full, model.layers[0], dev)
    del model
    torch.cuda.empty_cache()
    rec.update(
        decode_gap_by_layer=gaps, decode_gap_by_layer_max=gap_max,
        decode_vs_forward=dict(layers=MOE_LAYERS, quantile=quant,
                               logsoftmax_diff=diff, argmax_agree=agree),
        decode_vs_forward_cut=dict(layers=SSM_GATE_LAYERS,
                                   quantile=quant,
                                   logsoftmax_diff=cut_diff,
                                   argmax_agree=cut_agree),
        moe_layer_check=layer_rec,
        launches={"flash_attention": sum(
            r["launches"]["flash_attention"] for r in prefills.values())},
        seconds=time.perf_counter() - t0)
    say("7m moe serve", f"capacity factor {MOE_DROPLESS} at B=1 S={CHECK_S}: "
        f"each layer's decode within {max(gaps):.4f} of its prefill path "
        f"(the {quant} quantile over positions; median "
        f"{statistics.median(gaps):.4f}; largest over positions "
        f"{max(gap_max):.4f}); decode vs forward log-softmax diff "
        f"{diff:.4f}, argmax agreement {agree:.3f} at {MOE_LAYERS} layers "
        f"(not gated), {cut_diff:.4f} / {cut_agree:.3f} at "
        f"{SSM_GATE_LAYERS} layers; {rec['seconds']:.1f} s")
    say("7m moe serve", f"moe_ffn of the cut's first layer at T="
        f"{MOE_CHECK_T}, capacity factor 1.25 ({layer_rec['capacity']} rows "
        f"an expert), inputs skewed toward expert 0 "
        f"({layer_rec['expert0_assignments']} assignments): ids equal "
        f"torch.topk's away from {layer_rec['near_ties']} near-ties, slots "
        f"and keep mask equal the plain per-expert loop's ("
        f"{layer_rec['dropped']:.4f} of the assignments dropped), outputs "
        f"within max abs {layer_rec['max_abs_err']:.4g} (<= {MOE_FFN_MAX}), "
        f"mean {layer_rec['mean_abs_err']:.4g} (<= {MOE_FFN_MEAN}) of it "
        f"(outputs up to {layer_rec['max_abs_out']:.3g}); no host sync")
    return rec


# ---------------------------------------------------------------------------
# phase 8: diagnostics
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_host_sync():
    """The body runs under ``torch.cuda.set_sync_debug_mode("error")``: a
    call that would make the host wait for the device raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def diag_run(name, eng, C, calls, expect, *, seed=0, state=None,
             n_snapshots=DIAG_SNAPSHOTS, **kw):
    """``run_marginal_experiment`` over ``calls`` sweep calls from
    ``eng.init(seed, C)`` (or ``state``) under ``no_host_sync``, the launch
    counts set to 0 just before and read just after: ``expect(calls)``
    names the engine's launches, the telemetry kernel must have one per
    call for each carry the run threads (the runner's with
    ``telemetry=True``, an AdaptiveScan engine's own), every other kernel
    none.  Returns (trace, host wall s to a synchronize, launches)."""
    from repro_torch.core import chains, engine
    st = eng.init(seed, C) if state is None else state
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with no_host_sync():
        tr = chains.run_marginal_experiment(
            eng, st, n_iters=calls * eng.updates_per_call,
            n_snapshots=n_snapshots, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = dict.fromkeys(KERNELS, 0)
    want.update(expect(calls))
    want["telemetry_update"] = calls * (
        int(bool(kw.get("telemetry"))) + int(isinstance(
            eng.schedule, engine.AdaptiveScan)))
    for kernel, n in want.items():
        check(launches[kernel] == n,
              f"8 {name}: {kernel} launched {launches[kernel]} times, "
              f"expected {n}")
    x = tr.final.x
    check(int(x.min()) >= 0 and int(x.max()) < eng.graph.D
          and bool(torch.isfinite(tr.error).all()),
          f"8 {name}: final state out of domain or error not finite")
    return tr, wall, {k: v for k, v in launches.items() if v}


def tel_fields(tel):
    from repro_torch.diagnostics import telemetry_to_numpy
    return telemetry_to_numpy(tel)


def same_telemetry(a, b):
    ta, tb = tel_fields(a), tel_fields(b)
    return all(np.array_equal(ta[f], tb[f]) for f in ta)


def same_run(a, b):
    """Two traces end in the same bits: chains, errors and (when both
    carry one) every telemetry field."""
    same = torch.equal(a.final.x, b.final.x) and torch.equal(a.error,
                                                              b.error)
    if a.telemetry is not None:
        same = same and same_telemetry(a.telemetry, b.telemetry)
    return same


def telemetry_cost(eng):
    """The telemetry's cost on the engine's sweep call: ms per call with and
    without the carry as a stream of 10 calls in turns (CUDA events), the
    device's busy time per call over such a stream (torch.profiler), and
    the update alone (stream ms, host issue ms, device ms)."""
    from repro_torch import diagnostics as diag
    box = {"st": eng.init(1, C_FULL), "plain": eng.init(1, C_FULL)}
    box["tel"] = eng.init_telemetry(box["st"])

    def with_tel():
        box["st"], box["tel"] = eng.sweep(box["st"], box["tel"])

    def without():
        box["plain"] = eng.sweep(box["plain"])

    rec = {}
    rec["call_ms"], rec["plain_call_ms"], _ = alternating_per_launch_ms(
        with_tel, without, 10, reps=7)
    busy_t = device_busy(lambda: [with_tel() for _ in range(10)])
    busy_p = device_busy(lambda: [without() for _ in range(10)])
    rec["device_busy_ms"] = busy_t["device_busy_ms"] / 10
    rec["plain_device_busy_ms"] = busy_p["device_busy_ms"] / 10
    rec["top_device_ops_ms"] = {k: v / 10 for k, v in
                                busy_t["top_device_ops_ms"].items()}
    old, new = box["plain"], eng.sweep(box["plain"])
    stats = eng.sweep_stats_fn(old)[1]
    args = (old.x, new.x, eng.updates_per_call, new.accepts - old.accepts,
            stats)
    kw = dict(cache=new.cache, n_values=eng.graph.D)

    def update():
        box["tel"] = diag.telemetry_update(box["tel"], *args, **kw)

    rec["update_ms"] = per_launch_ms(update, 10)
    rec["update_host_ms"] = host_ms(update, 20)
    rec["update_device_ms"] = device_busy(
        lambda: [update() for _ in range(10)])["device_busy_ms"] / 10
    C, n = old.x.shape
    rec["update_bound_ms"] = bound(telemetry_bytes(
        C, n, box["tel"].cross.shape[0], box["tel"].count >= box[
            "tel"].split, eng.updates_per_call), 0)[0]
    rec["overhead_call"] = rec["call_ms"] / rec["plain_call_ms"] - 1.0
    rec["overhead_device"] = (rec["device_busy_ms"]
                              / rec["plain_device_busy_ms"] - 1.0)
    return rec


def telemetry_bytes(C, n, K, second, S):
    """Bytes one telemetry update must move: x_old and x_new, the accept
    deltas, the sweep's C x S site draws and the cache read once; the
    Welford pair (both pairs in the second half), the K lag sums, the
    counters and the scalars read and written; the K ring slots read and
    two written."""
    per_elem = 8 + 16 + (16 if second else 0) + 4 * K + 8 * K + 8
    return (C * n * per_elem + 4 * C + 4 * C * S + 4 * C   # inputs
            + 8 * C + 24 * n + 8 * K + 6 * 8)              # counters


def update_args(eng, seed):
    """One mgpmh call's telemetry-update arguments at the engine's shape:
    (old_x, new_x, updates, accept_delta, stats), cache and D."""
    old = eng.init(seed, C_FULL, start="random")
    new, stats = eng.sweep_stats_fn(old)
    args = (old.x, new.x, eng.updates_per_call, new.accepts - old.accepts,
            stats)
    return args, dict(cache=new.cache, n_values=eng.graph.D)


def telemetry_kernel_times(eng):
    """The telemetry kernel on one mgpmh call's arguments at potts-64x64
    (C=256, n=4096, K=8), in each half: ms per launch as a stream of 20,
    device ms (torch.profiler), host issue ms, against its byte bound;
    beside the plain (eager) update's stream, host issue and device ms."""
    from repro_torch import diagnostics as diag
    args, kw = update_args(eng, 5)
    C, n = args[0].shape
    rec = {}
    for half, half_at in (("first", None), ("second", 0)):
        box = {"tel": eng.init_telemetry(eng.init(1, C_FULL),
                                         half_at=half_at)}

        def update():
            box["tel"] = diag.telemetry_update(box["tel"], *args, **kw)

        K = box["tel"].cross.shape[0]
        nbytes = telemetry_bytes(C, n, K, half == "second", S_FULL)
        bms, by = bound(nbytes, 0)
        rec[half] = dict(
            ms=per_launch_ms(update, 20), host_ms=host_ms(update, 20),
            device_ms=kernel_device_ms(update, 20, "telemetry_update"),
            bound_ms=bms, bound_by=by, bytes=nbytes)
        check(box["tel"].count > 0 and (box["tel"].split <= box["tel"].count)
              == (half == "second"), f"8f telemetry kernel {half} half: "
              f"the carry's split {box['tel'].split} count "
              f"{box['tel'].count}")
    box = {"tel": eng.init_telemetry(eng.init(1, C_FULL), half_at=0)}

    def plain():
        box["tel"] = diag.telemetry_update_plain(box["tel"], *args, **kw)

    rec["plain"] = dict(
        ms=per_launch_ms(plain, 20), host_ms=host_ms(plain, 20),
        device_ms=device_busy(lambda: [plain() for _ in range(10)])[
            "device_busy_ms"] / 10)
    sec = rec["second"]
    rec.update(ms=sec["ms"], device_ms=sec["device_ms"],
               plain_ms=rec["plain"]["ms"], bound_ms=sec["bound_ms"],
               bound_by=sec["bound_by"], library_ms=None,
               shape=f"potts-64x64 mgpmh C={C} n={n} K=8, second half")
    for half in ("first", "second"):
        r = rec[half]
        say("8f telemetry kernel", f"{half} half: {r['ms']:.4f} ms per "
            f"launch as a stream (host issue {r['host_ms']:.4f}), device "
            f"{r['device_ms']:.4f} against its bound {r['bound_ms']:.4f} "
            f"({r['bytes'] / 2 ** 20:.1f} MiB, {r['bound_by']}): "
            f"{r['device_ms'] / r['bound_ms']:.2f}x the bound")
    pl = rec["plain"]
    say("8f telemetry kernel", f"plain (eager) update, second half: "
        f"{pl['ms']:.4f} ms as a stream, host issue {pl['host_ms']:.4f}, "
        f"device {pl['device_ms']:.4f}")
    return rec


def same_bits(a, b):
    """(equal, first differing flat index or None) of two float32 tensors,
    compared as their bits (NaN equals NaN)."""
    ai, bi = a.view(torch.int32), b.view(torch.int32)
    if torch.equal(ai, bi):
        return True, None
    return False, int((ai != bi).flatten().nonzero()[0])


def phase_telemetry_kernel(potts):
    """8f: the telemetry kernel against the plain version on the card, bit
    for bit, every field after every call, in every TEL_CASES case; on a
    mismatch the field, the call and the first differing element are
    printed and the run fails.  Then its times at the main path's shape
    (``telemetry_kernel_times``)."""
    from repro_torch import diagnostics as diag
    from repro_torch.core import engine
    from repro_torch.kernels import parity_inputs as pin
    from repro_torch.kernels import telemetry_update as tu
    T = 2 * 8 + 4
    host = pin.telemetry_inputs(T, 256, TEL_N, TEL_D, seed=21, S=S_FULL)
    data = {k: torch.from_numpy(v).to(potts.device)
            for k, v in host.items()}
    out = {}
    for case, (C, n, K, half_at, drop, bad, form) in TEL_CASES.items():
        steps = 2 * K + 4
        xs, cache = data["xs"][:steps + 1, :C], data["cache"][:steps, :C]
        if bad == "x":
            xs = xs.clone()
            xs[K + 1, 1, 2] = TEL_D
        elif bad == "cache":
            cache = cache.clone()
            cache[K + 1, 1] = float("nan")
        kern = diag.telemetry_init(xs[0], half_at=half_at, lags=K)
        plain = diag.telemetry_init(xs[0], half_at=half_at, lags=K)
        tu.telemetry_update_cuda.launches = 0
        for s in range(steps):
            stats = (diag.SweepStats(data["prop"][s], data["site_acc"][s])
                     if form == "counts" else
                     diag.SiteDraws(data["sites"][s, :C],
                                    moves=form == "moves"))
            kw = dict(accept_delta=data["acc"][s, :C].contiguous(),
                      stats=stats, cache=cache[s].contiguous(),
                      n_values=TEL_D)
            for name in drop:
                kw[name] = None
            x_old, x_new = xs[s].contiguous(), xs[s + 1].contiguous()
            kern = diag.telemetry_update(kern, x_old, x_new, S_FULL, **kw)
            plain = diag.telemetry_update_plain(plain, x_old, x_new, S_FULL,
                                                **kw)
            check((kern.head, kern.count) == (plain.head, plain.count),
                  f"8f {case}: call {s} host copies {kern.head, kern.count} "
                  f"!= {plain.head, plain.count}")
            for f in tu.CARRY_FIELDS:
                a, b = getattr(kern, f), getattr(plain, f)
                same, at = same_bits(a, b)
                if not same:
                    fail(f"8f telemetry kernel {case}: field {f} differs "
                         f"from the plain version after call {s}, first at "
                         f"flat index {at}: kernel "
                         f"{a.flatten()[at].item()!r}, plain "
                         f"{b.flatten()[at].item()!r}")
        launches = tu.telemetry_update_cuda.launches
        check(launches == steps, f"8f {case}: {launches} kernel launches in "
              f"{steps} calls")
        flag = float(kern.bad_state)
        check(flag == (0.0 if bad is None else 1.0),
              f"8f {case}: bad_state {flag}")
        out[case] = dict(C=C, n=n, K=K, half_at=half_at, calls=steps,
                         left_out=list(drop), bad=bad, stats=form,
                         bad_state=flag, bit_equal=True)
        say("8f telemetry kernel", f"{case} (C={C} n={n} K={K}, split at "
            f"{half_at}, {steps} calls): all {len(tu.CARRY_FIELDS)} fields "
            f"bit-equal to the plain version after every call; "
            f"{launches} launches; bad_state {flag}")
    del data
    torch.cuda.empty_cache()
    times = telemetry_kernel_times(engine.make("mgpmh", potts, sweep=S_FULL))
    return dict(cases=out, max_abs_err=0.0, times=times)


def phase_reference_contract(dev, smi):
    """8g: the reference's telemetry contract at its own shape: mgpmh on
    potts-20x20 (C=64, S=64, 48 calls in 4 snapshots) through
    ``run_marginal_experiment`` with and without ``telemetry=True``, host
    wall to a synchronize, in turns after a warm-up; medians against 10%."""
    from repro_torch.core import engine, factor_graph
    g = factor_graph.make_potts_graph(20, 4.6, 10, device=dev)
    eng = engine.make("mgpmh", g, sweep=REF_S)
    expect = lambda calls: {"mgpmh_sweep": calls}
    walls = {"plain": [], "telemetry": []}
    order = ["plain", "telemetry"] + ["plain", "telemetry",
                                      "telemetry", "plain"] * (REF_REPS // 2)
    order += ["plain", "telemetry"] * (REF_REPS % 2)
    for k, label in enumerate(order):
        _, wall, _ = diag_run(f"reference shape {label}", eng, REF_C,
                              REF_CALLS, expect, n_snapshots=REF_SNAPSHOTS,
                              telemetry=label == "telemetry")
        if k >= 2:                       # the first pair warms both up
            walls[label].append(wall)
    med = {k: statistics.median(v) for k, v in walls.items()}
    low = {k: min(v) for k, v in walls.items()}
    rec = dict(walls_s=walls, median_s=med, min_s=low,
               overhead=med["telemetry"] / med["plain"] - 1.0,
               overhead_min=low["telemetry"] / low["plain"] - 1.0,
               limit=REF_LIMIT, card=smi)
    rec["within_limit"] = rec["overhead"] < REF_LIMIT
    say("8g reference contract", f"mgpmh potts-20x20 C={REF_C} S={REF_S} "
        f"{REF_CALLS} calls in {REF_SNAPSHOTS} snapshots on {smi}: "
        f"{REF_REPS} runs each in turns, median {med['telemetry']:.5f} s "
        f"with telemetry, {med['plain']:.5f} without: overhead "
        f"{100 * rec['overhead']:+.2f}% (min-of-runs "
        f"{100 * rec['overhead_min']:+.2f}%) against the reference's < "
        f"{100 * REF_LIMIT:.0f}%: "
        + ("within" if rec["within_limit"] else "MISSED"))
    return rec


def phase_obs(potts, smi):
    """8h: observability on the card.  The mgpmh call at potts-64x64 (with
    telemetry, and without) under an active Recorder (a ``sweep_chunk``
    span around each call, the engine's annotations) against the
    NullRecorder, per call as streams of 10 in turns (the median of the
    turns' ratios), and one span's host time alone; the active loop
    under ``set_sync_debug_mode("error")`` with the same launches per call
    as the null one; then the launcher with ``--metrics-dir``, ``--trace``
    and ``--profile`` (potts-20x20), its files parsed and the profile's
    ranges holding the telemetry kernel."""
    from repro_torch import obs
    from repro_torch.core import engine
    eng = engine.make("mgpmh", potts, sweep=S_FULL)
    active = obs.Recorder()
    labels = active.register_engine(eng, workload="potts-64x64",
                                    chains=C_FULL)
    null = obs.NullRecorder()
    rec = dict(card=smi, limit=OBS_LIMIT)
    for mode in ("telemetry", "plain"):
        boxes = {}
        for name in ("active", "null"):
            st = eng.init(1, C_FULL)
            boxes[name] = {"st": st, "tel": (eng.init_telemetry(st)
                                             if mode == "telemetry"
                                             else None)}

        def call(r, box):
            with r.span("sweep_chunk", **labels):
                if box["tel"] is None:
                    box["st"] = eng.sweep(box["st"])
                else:
                    box["st"], box["tel"] = eng.sweep(box["st"], box["tel"])

        ms_a, ms_n, ratio = alternating_per_launch_ms(
            lambda: call(active, boxes["active"]),
            lambda: call(null, boxes["null"]), 10, OBS_REPS)
        launches = {}
        for name, r in (("active", active), ("null", null)):
            torch.cuda.synchronize()
            reset_launches()
            with obs.using(r), no_host_sync():
                for _ in range(OBS_CALLS):
                    call(r, boxes[name])
            torch.cuda.synchronize()
            launches[name] = {k: v for k, v in read_launches().items() if v}
        want = {"mgpmh_sweep": OBS_CALLS}
        if mode == "telemetry":
            want["telemetry_update"] = OBS_CALLS
        check(launches["active"] == launches["null"] == want,
              f"8h obs {mode}: launches {launches}, expected {want} in "
              f"{OBS_CALLS} calls")
        overhead = ratio - 1.0
        rec[mode] = dict(active_ms=ms_a, null_ms=ms_n, overhead=overhead,
                         within_limit=overhead <= OBS_LIMIT,
                         launches=launches["active"])
        say("8h obs", f"mgpmh call potts-64x64 C={C_FULL} S={S_FULL} "
            f"({mode}) on {smi}: {ms_a:.4f} ms per call under an active "
            f"Recorder, {ms_n:.4f} under the NullRecorder (medians of "
            f"{OBS_REPS} streams of 10 each, in turns): overhead "
            f"{100 * overhead:+.2f}% (median of the turns' ratios) against "
            f"{100 * OBS_LIMIT:.0f}%: "
            + ("within" if overhead <= OBS_LIMIT else "MISSED")
            + f"; no host sync in {OBS_CALLS} active calls, launches "
            f"{launches['active']} (null {launches['null']})")
    rec["span_host_ms"], rec["null_span_host_ms"] = (
        host_ms(lambda: _empty_span(active, labels), 2000),
        host_ms(lambda: _empty_span(null, labels), 2000))
    say("8h obs", f"one sweep_chunk span alone: {rec['span_host_ms']:.5f} "
        f"ms of host time (NullRecorder {rec['null_span_host_ms']:.5f})")
    check(active.metrics.value("span_calls_total", span="sweep_chunk") > 0,
          "8h obs: the active recorder counted no span")
    rec["launcher"] = obs_launcher()
    return rec


def _empty_span(rec, labels):
    with rec.span("sweep_chunk", **labels):
        pass


def _profile_ranges(path):
    """The profiler trace's ``repro.`` ranges and the kernels launched
    inside each: {range name: (count, {kernel names})}, matched by the
    launch's correlation id."""
    doc = json.loads(Path(path).read_text())
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in evs if str(e.get("name", "")).startswith("repro.")
              and e.get("cat") == "user_annotation"]
    launches = [e for e in evs if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
                and "correlation" in e.get("args", {})]
    kernels = {e["args"]["correlation"]: e["name"] for e in evs
               if e.get("cat") == "kernel" and "correlation" in e.get(
                   "args", {})}
    out = {}
    for r in ranges:
        t0, t1 = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        inside = {kernels[e["args"]["correlation"]] for e in launches
                  if t0 <= float(e["ts"]) <= t1
                  and e["args"]["correlation"] in kernels}
        n, names = out.get(r["name"], (0, set()))
        out[r["name"]] = (n + 1, names | inside)
    return out, len(kernels)


def obs_launcher(tries=3):
    """The launcher on the card with --metrics-dir, --trace and --profile:
    metrics.jsonl, metrics.prom and trace.json parse and count every call;
    the profile holds the sweep and telemetry ranges, the telemetry kernel
    inside the latter (a capture that recorded no kernel is taken again,
    up to ``tries`` times: CUPTI drops a window now and then)."""
    from repro_torch import obs
    from repro_torch.launch import gibbs as launcher
    steps = 8
    for attempt in range(tries):
        out = ROOT / "chiprun_out" / "obs" / f"run{attempt}"
        args = ["--config", "potts-20x20", "--engine", "mgpmh", "--steps",
                str(steps), "--chains", str(REF_C), "--sweep", str(REF_S),
                "--telemetry", "--device", "cuda", "--metrics-dir",
                str(out), "--trace", str(out / "trace.json"), "--profile",
                str(out / "prof")]
        torch.cuda.synchronize()
        reset_launches()
        launcher.main(args)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        obs.set_recorder(obs.NullRecorder())      # main() configured one
        ranges, n_kernels = _profile_ranges(out / "prof" /
                                            "profile_trace.json")
        if n_kernels:
            break
    check(launches == {"mgpmh_sweep": steps, "telemetry_update": steps},
          f"8h launcher: launches {launches}")
    series = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1]
                        )["series"]
    by_name = {x["name"]: x for x in series}
    prom = (out / "metrics.prom").read_text()
    spans = [e for e in json.loads((out / "trace.json").read_text())[
        "traceEvents"] if e["ph"] == "X"]
    check(by_name["sweeps_total"]["value"] == steps
          and by_name["updates_total"]["value"] == steps * REF_C * REF_S
          and by_name["sweeps_total"]["labels"]["backend"] == "cuda"
          and "# TYPE repro_sweeps_total counter" in prom
          and [e["name"] for e in spans] == ["sweep_chunk"] * steps,
          f"8h launcher files: {by_name.get('sweeps_total')}, "
          f"{len(spans)} spans")
    sweep = ranges.get("repro.sweep/mgpmh/cuda", (0, set()))
    tel = ranges.get("repro.sweep/telemetry", (0, set()))
    check(n_kernels > 0 and sweep[0] == steps and tel[0] == steps
          and any("telemetry_update" in k for k in tel[1])
          and any("mgpmh_sweep" in k for k in sweep[1])
          and not any("mgpmh_sweep" in k for k in tel[1]),
          f"8h profile: {n_kernels} kernels; ranges "
          f"{ {k: (v[0], sorted(v[1])) for k, v in ranges.items()} }")
    rec = dict(files=sorted(p.name for p in out.iterdir()),
               series=sorted(by_name), spans=len(spans),
               ranges={k: dict(count=v[0], kernels=sorted(v[1]))
                       for k, v in ranges.items()},
               kernels_in_profile=n_kernels, attempts=attempt + 1)
    say("8h obs", f"launcher potts-20x20 mgpmh C={REF_C} S={REF_S} {steps} "
        f"calls --telemetry --metrics-dir --trace --profile: files "
        f"{rec['files']}, {len(series)} series parsed (sweeps_total "
        f"{by_name['sweeps_total']['value']:.0f}), {len(spans)} sweep_chunk "
        f"spans; profile ranges " + "; ".join(
            f"{k} x{v['count']}: {', '.join(v['kernels'])}"
            for k, v in rec["ranges"].items()))
    return rec


def phase_diag_main(potts, lattice, smi):
    """8a: telemetry on the main path and beside every engine."""
    from repro_torch.core import engine
    from repro_torch import diagnostics as diag
    out = {}
    eng = engine.make("mgpmh", potts, sweep=S_FULL)
    expect = lambda calls: {"mgpmh_sweep": calls}
    runs = {"plain": [], "telemetry": []}
    # a warm-up run, then three of each in turns
    for label in ("plain", "plain", "telemetry", "telemetry", "plain",
                  "plain", "telemetry"):
        tr, wall, launches = diag_run(f"mgpmh {label}", eng, C_FULL, SWEEPS,
                                      expect,
                                      telemetry=label == "telemetry")
        runs[label].append((tr, wall))
    runs["plain"].pop(0)
    (tr, wall), (again, _), _ = runs["telemetry"]
    plain = runs["plain"][0][0]
    check(same_run(tr, again), "8a mgpmh: a telemetry'd replay from seed 0 "
          "ended elsewhere")
    check(torch.equal(tr.final.x, plain.final.x)
          and torch.equal(tr.error, plain.error),
          "8a mgpmh: telemetry changed the chains")
    tel = tr.telemetry
    fields = tel_fields(tel)
    check(all(np.isfinite(v).all() for v in fields.values()),
          "8a mgpmh: a telemetry field is not finite")
    summary = diag.summarize(tel, eng.exact_accept, elapsed_sec=wall)
    health = diag.health_report(tel, eng.exact_accept)
    fresh = diag.freshness_report(tel, diag.FreshnessPolicy(),
                                  include_health=True)
    gap = diag.empirical_spectral_gap(tel)
    check(summary["samples"] == SWEEPS
          and summary["updates"] == SWEEPS * S_FULL
          and not health["bad_state"] and 0.0 < gap < 1.0,
          f"8a mgpmh: summary {summary}, health {health}, gap {gap}")
    cost = telemetry_cost(eng)
    walls = {f"{k}_s": [w for _, w in v] for k, v in runs.items()}
    walls["overhead"] = (statistics.median(walls["telemetry_s"])
                         / statistics.median(walls["plain_s"]) - 1.0)
    out["mgpmh"] = dict(summary=summary, health=health, freshness=fresh,
                        spectral_gap=gap, launches=launches, walls=walls,
                        cost=cost, replay_bit_identical=True, card=smi)
    say("8a telemetry", f"mgpmh potts-64x64 C={C_FULL} S={S_FULL} "
        f"{SWEEPS} calls, telemetry=True, no host sync, replay and the run "
        f"without telemetry bit-identical; launches {launches}; summarize "
        f"{json.dumps(summary)}; health {json.dumps(health)}; freshness "
        f"{json.dumps(fresh)}; empirical spectral gap {gap:.6g}")
    fmt = lambda ws: ", ".join(f"{w:.4f}" for w in ws)
    say("8a telemetry", f"on {smi}: 200-call run wall (to a synchronize, "
        f"in turns after a warm-up) with telemetry "
        f"{fmt(walls['telemetry_s'])} s, without {fmt(walls['plain_s'])} s "
        f"(medians: overhead {walls['overhead']:+.3f}); per call as a "
        f"stream of 10: {cost['call_ms']:.4f} ms with, "
        f"{cost['plain_call_ms']:.4f} without (overhead "
        f"{cost['overhead_call']:+.3f}); device busy per call "
        f"{cost['device_busy_ms']:.4f} with, "
        f"{cost['plain_device_busy_ms']:.4f} without (overhead "
        f"{cost['overhead_device']:+.3f}); the update alone "
        f"{cost['update_ms']:.4f} ms as a stream (host issue "
        f"{cost['update_host_ms']:.4f}, device {cost['update_device_ms']:.4f}"
        f", bound {cost['update_bound_ms']:.4f})"
        f"; top device ops per call with telemetry "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    cost["top_device_ops_ms"].items()))
    others = [
        ("gibbs", engine.make("gibbs", potts, sweep=S_FULL), C_FULL,
         lambda calls: {"gibbs_sweep": calls}),
        ("min-gibbs", engine.make("min-gibbs", potts, sweep=S_MIN), C_MIN,
         lambda calls: {"min_gibbs_sweep": calls}),
        ("doublemin", engine.make("doublemin", potts, sweep=S_DMIN), C_DMIN,
         lambda calls: {"double_min_sweep": calls}),
        (f"local-gibbs B={LOCAL_MAIN}",
         engine.make("local-gibbs", potts, sweep=S_FULL,
                     batch_size=LOCAL_MAIN), C_FULL,
         lambda calls: {"local_gibbs_sweep": calls}),
        ("chromatic gibbs lattice-ising-64x64",
         engine.make("gibbs", lattice.graph,
                     schedule=engine.ChromaticBlocks(lattice.colors)),
         C_FULL, lambda calls: {"gibbs_class_sweep": 2 * calls})]
    for name, e, C, exp in others:
        tr, wall, launches = diag_run(name, e, C, DIAG_CALLS, exp,
                                      telemetry=True)
        s = diag.summarize(tr.telemetry, e.exact_accept, elapsed_sec=wall)
        check(s["samples"] == DIAG_CALLS
              and not diag.health_report(tr.telemetry)["bad_state"],
              f"8a {name}: telemetry {s}")
        out[name] = dict(summary=s, launches=launches, seconds=wall)
        say("8a telemetry", f"{name} C={C}: {DIAG_CALLS} calls with "
            f"telemetry, no host sync, launches {launches}; max split-rhat "
            f"{s['max_split_rhat']:.4f}, min ESS {s['ess_min_site']:.2f}, "
            f"flip rate {s['flip_rate']:.6f}, acceptance "
            f"{s['mean_acceptance']:.4f} ({wall:.3f} s)")
    return out


def phase_diag_card_vs_cpu(dev):
    """8b: one trajectory through telemetry_update on the card and on the
    CPU; every field within the CPU tests' tolerance."""
    from repro_torch import diagnostics as diag
    C, n, D = C_FULL, 4096, 10
    rng = np.random.default_rng(8)
    xs = [rng.integers(0, D, size=(C, n), dtype=np.int32)]
    for _ in range(TEL_STEPS):
        fresh = rng.integers(0, D, size=(C, n), dtype=np.int32)
        xs.append(np.where(rng.random((C, n)) < 0.8, xs[-1], fresh))
    acc = rng.integers(0, S_FULL, size=(TEL_STEPS, C), dtype=np.int32)
    prop = rng.integers(0, 9, size=(TEL_STEPS, n)).astype(np.float32)
    sacc = np.minimum(prop, rng.integers(0, 9, size=(TEL_STEPS, n))).astype(
        np.float32)
    cache = rng.normal(size=(TEL_STEPS, C)).astype(np.float32)
    card, cpu = [], []
    for device, fields in ((dev, card), (torch.device("cpu"), cpu)):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        tel = diag.telemetry_init(t(xs[0]), half_at=TEL_STEPS // 2)
        for s in range(TEL_STEPS):
            tel = diag.telemetry_update(
                tel, t(xs[s]), t(xs[s + 1]), S_FULL, t(acc[s]),
                diag.SweepStats(t(prop[s]), t(sacc[s])), cache=t(cache[s]),
                n_values=D)
        fields.append(tel_fields(tel))
    errs = {}
    for f, want in cpu[0].items():
        got = card[0][f]
        errs[f] = float(np.abs(got - want).max())
        check(np.allclose(got, want, **TEL_TOL),
              f"8b telemetry field {f}: card and CPU differ by {errs[f]}")
    say("8b telemetry", f"C={C} n={n} K=8, {TEL_STEPS} steps: every field "
        f"of the card's carry within rtol 1e-6 / atol 1e-6 of the CPU's; "
        f"max abs differences {json.dumps(errs)}")
    return dict(max_abs_err=errs)


def first_hit(tr, target):
    err, iters = tr.error.cpu().numpy(), tr.iters.numpy()
    hit = err < target
    return int(iters[np.argmax(hit)]) if hit.any() else None


def phase_diag_adaptive(potts):
    """8c: AdaptiveScan against uniform at the reference bench's cell, and
    the adaptive minibatch engines at full width."""
    from repro_torch import diagnostics as diag
    from repro_torch.core import engine
    dev = potts.device
    out = {}
    g = engine.make_workload("hetero-pairs-1024", device=dev).graph
    ref = torch.full((g.n, g.D), 0.5, device=dev)
    calls = ADA_CALLS * ADA_SNAPSHOTS
    firsts = {}
    for label, eng in (
            ("uniform", engine.make("gibbs", g, sweep=ADA_S)),
            ("adaptive", engine.make("gibbs", g, schedule=engine.AdaptiveScan(
                sweep_len=ADA_S, refresh_every=4, uniform_mix=0.15)))):
        tr, wall, launches = diag_run(
            f"gibbs {label} hetero-pairs-1024", eng, ADA_C, calls,
            lambda c: {"gibbs_sweep": c}, n_snapshots=ADA_SNAPSHOTS,
            telemetry=True, ref_marginals=ref, site_reduce="max")
        first = firsts[label] = first_hit(tr, ADA_TARGET)
        check(first is not None, f"8c gibbs {label}: worst-site TV never "
              f"fell below {ADA_TARGET} (last {float(tr.error[-1]):.4f})")
        s = diag.summarize(tr.telemetry, True, elapsed_sec=wall)
        out[label] = dict(updates_to_target=first, seconds=wall,
                          launches=launches, final_tv=float(tr.error[-1]),
                          max_split_rhat=s["max_split_rhat"])
        say("8c adaptive", f"gibbs {label} hetero-pairs-1024 S={ADA_S} "
            f"C={ADA_C} {calls} calls: worst-site TV < {ADA_TARGET} after "
            f"{first} updates per chain (final TV "
            f"{out[label]['final_tv']:.4f}, max split-rhat "
            f"{s['max_split_rhat']:.4f}); launches {launches}; {wall:.3f} s")
    out["update_ratio"] = firsts["adaptive"] / firsts["uniform"]
    say("8c adaptive", f"adaptive / uniform updates to the target: "
        f"{out['update_ratio']:.4f} (reference bench 0.407)")
    sched = lambda S: engine.AdaptiveScan(sweep_len=S)
    for name, S, C, calls, falling in (
            ("mgpmh", S_FULL, C_FULL, SWEEPS, True),
            ("min-gibbs", S_MIN, C_MIN, DIAG_CALLS, False),
            ("doublemin", S_DMIN, C_DMIN, DIAG_CALLS, False)):
        eng = engine.make(name, potts, schedule=sched(S))
        kernel = name.replace("-", "_").replace("doublemin", "double_min")
        exp = lambda c, k=kernel: {f"{k}_sweep": c}
        tr, wall, launches = diag_run(f"adaptive {name}", eng, C, calls, exp)
        again, _, _ = diag_run(f"adaptive {name} replay", eng, C, calls, exp)
        fin, fin2 = tr.final, again.final
        check(same_run(tr, again) and torch.equal(fin.cdf, fin2.cdf)
              and torch.equal(fin.accepts, fin2.accepts)
              and same_telemetry(fin.tel, fin2.tel),
              f"8c adaptive {name}: a replay from seed 0 ended elsewhere")
        errs = [float(e) for e in tr.error]
        if falling:
            check(errs[-1] < errs[0], f"8c adaptive {name}: marginal error "
                  f"did not fall: {errs}")
        acc = (1.0 if eng.exact_accept else
               float(fin.accepts.double().sum()) / (C * calls * S))
        out[name] = dict(marg_err=errs, acceptance=acc, launches=launches,
                         seconds=wall, updates_per_s=C * calls * S / wall,
                         replay_bit_identical=True)
        say("8c adaptive", f"adaptive {name} potts-64x64 C={C} S={S} "
            f"{calls} calls, no host sync: marg_err {errs[0]:.6f} -> "
            f"{errs[-1]:.6f}; acc={acc:.4f}; launches {launches}; "
            f"{C * calls * S / wall / 1e6:.3f}M updates/s; replay "
            f"bit-identical (chains, table, telemetry)")
        if name == "mgpmh":
            out["mgpmh_table"] = fin.cdf
            # uniform mgpmh at the same shape, twice, beside the adaptive
            uni = [C * calls * S / diag_run(
                "uniform mgpmh", engine.make(name, potts, sweep=S), C,
                calls, exp)[1] for _ in range(2)]
            out[name]["uniform_updates_per_s"] = uni
            say("8c adaptive", f"mgpmh potts-64x64 C={C} S={S} {calls} "
                f"calls: adaptive {out[name]['updates_per_s'] / 1e6:.3f}M "
                f"updates/s, uniform "
                + ", ".join(f"{u / 1e6:.3f}M" for u in uni))
    return out


def landings(cdf, observed, seed):
    """Observed sites hit by LANDING_DRAWS inverse-CDF draws (read once)."""
    from repro_torch.core import samplers
    gen = torch.Generator(device=cdf.device).manual_seed(seed)
    u = torch.rand(LANDING_DRAWS, generator=gen, device=cdf.device)
    return int(observed[samplers.inverse_cdf_sites(cdf, u).long()].sum())


def phase_diag_evidence(potts, lattice, table):
    """8d: evidence clamping at full width, and draws that must miss every
    observed site."""
    from repro_torch.core import engine, samplers
    from repro_torch.diagnostics import adaptive
    dev = potts.device
    rng = np.random.default_rng(10)

    def evidence(g):
        obs = np.sort(rng.choice(g.n, int(EV_FRACTION * g.n), replace=False))
        idx = torch.from_numpy(obs).to(dev)
        mask = torch.zeros(g.n, device=dev).index_fill_(0, idx, 1.0)
        vals = torch.zeros(g.n, dtype=torch.int32, device=dev)
        vals[idx] = torch.from_numpy(
            rng.integers(0, g.D, size=obs.size, dtype=np.int32)).to(dev)
        return (mask, vals), idx

    out = {}
    for name, eng, C, kernel, per_call in (
            ("gibbs", engine.make("gibbs", potts, sweep=S_FULL), C_FULL,
             "gibbs_sweep", 1),
            ("mgpmh", engine.make("mgpmh", potts, sweep=S_FULL), C_FULL,
             "mgpmh_sweep", 1),
            ("min-gibbs", engine.make("min-gibbs", potts, sweep=S_MIN),
             C_MIN, "min_gibbs_sweep", 1),
            ("doublemin", engine.make("doublemin", potts, sweep=S_DMIN),
             C_DMIN, "double_min_sweep", 1),
            ("chromatic gibbs lattice-ising-64x64",
             engine.make("gibbs", lattice.graph,
                         schedule=engine.ChromaticBlocks(lattice.colors)),
             C_FULL, "gibbs_class_sweep", 2)):
        ev, idx = evidence(eng.graph)
        want = ev[1][idx]
        st = eng.clamp(eng.init(0, C), ev)
        x0 = st.x.clone()
        violations = torch.zeros((), dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        with no_host_sync():
            for _ in range(EV_CALLS):
                st = eng.sweep(st, evidence=ev)
                violations += (st.x[:, idx] != want).sum()
        torch.cuda.synchronize()
        launches = read_launches()
        moved = int((st.x != x0).sum())
        n_viol = int(violations)
        check(launches[kernel] == per_call * EV_CALLS
              and sum(launches.values()) == per_call * EV_CALLS,
              f"8d {name}: launches {launches}")
        check(n_viol == 0, f"8d {name}: {n_viol} observed (chain, site, "
              f"call) values differ from their evidence")
        check(moved > 0, f"8d {name}: no unobserved site moved")
        out[name] = dict(observed=int(idx.numel()), violations=n_viol,
                         values_changed=moved, calls=EV_CALLS, chains=C)
        say("8d evidence", f"{name} C={C}: {idx.numel()} of {eng.graph.n} "
            f"sites observed, {EV_CALLS} calls with evidence, no host sync: "
            f"{n_viol} violations; {moved} unobserved values changed; "
            f"launches {kernel} {launches[kernel]}")
    (mask, _), _ = evidence(potts)
    observed = mask > 0.0
    hits = {"evidence_cdf": landings(samplers.evidence_cdf(mask), observed,
                                     11),
            "masked_adaptive_table": landings(
                adaptive.masked_cdf(table, mask), observed, 12)}
    check(all(h == 0 for h in hits.values()),
          f"8d draws landed on observed sites: {hits}")
    out["landings"] = hits
    say("8d evidence", f"{LANDING_DRAWS} draws each at n={potts.n} "
        f"({int(observed.sum())} observed) landing on observed sites: "
        f"{json.dumps(hits)}")
    return out


def phase_diag_autotune(potts, smi):
    """8e: the lambda auto-tuner on potts-64x64."""
    from repro_torch.diagnostics import adaptive
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, hist = adaptive.autotune_lambda("mgpmh", potts,
                                         target=AUTOTUNE_TARGET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lo, hi = AUTOTUNE_TARGET
    check(lo <= hist[-1]["acceptance"] <= hi
          and eng.params["lam"] == hist[-1]["lam"],
          f"8e autotune_lambda did not land in {AUTOTUNE_TARGET}: {hist}")
    say("8e autotune", f"autotune_lambda mgpmh potts-64x64 target "
        f"{AUTOTUNE_TARGET} on {smi}: {len(hist)} rounds "
        + " -> ".join(f"lam {h['lam']:.3f} acc {h['acceptance']:.4f}"
                      for h in hist) + f"; {wall:.3f} s")
    return dict(rounds=len(hist), history=hist, lam=hist[-1]["lam"],
                seconds=wall, card=smi)


def phase_diagnostics(potts, lattice, smi):
    t0 = time.perf_counter()
    rec = {"telemetry_kernel": phase_telemetry_kernel(potts)}
    rec["main"] = phase_diag_main(potts, lattice, smi)
    rec["card_vs_cpu"] = phase_diag_card_vs_cpu(potts.device)
    ada = phase_diag_adaptive(potts)
    table = ada.pop("mgpmh_table")
    rec["adaptive"] = ada
    rec["evidence"] = phase_diag_evidence(potts, lattice, table)
    rec["autotune"] = phase_diag_autotune(potts, smi)
    rec["reference_contract"] = phase_reference_contract(potts.device, smi)
    rec["obs"] = phase_obs(potts, smi)
    rec["seconds"] = time.perf_counter() - t0
    say("8 diagnostics", f"{rec['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 9: the dist backend (runtime/dist_gibbs.py) on torch.distributed
# ---------------------------------------------------------------------------

def dist_mesh(shape):
    from repro_torch.launch.mesh import make_auto_mesh
    return make_auto_mesh(shape, ("data", "model"), device_type="cuda")


def dist_state_bits(st):
    inner = getattr(st, "inner", st)
    return [inner.x, inner.cache, inner.accepts, inner.marg]


def dist_run(eng, C, calls, snapshots=1, seed=0):
    """``calls`` sweep calls of a dist engine from ``seed`` in
    ``snapshots`` segments, each under ``set_sync_debug_mode("error")``;
    after each segment (outside it) the gathered marginals' error.  Returns
    (state, errors, wall s of the calls alone, all-reduces per call)."""
    from repro_torch.core.chains import marginal_error
    from repro_torch.runtime import dist_gibbs as DG
    st = eng.init(seed, C)
    errs, wall, colls = [], 0.0, 0
    for _ in range(snapshots):
        before = DG.all_reduce.calls
        t0 = time.perf_counter()
        with no_host_sync():
            for _ in range(calls // snapshots):
                st = eng.sweep(st)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        colls += DG.all_reduce.calls - before
        marg, _ = DG.gather_marginals(st, eng.mesh)
        errs.append(float(marginal_error(marg, st.count).mean()))
    return st, errs, wall, colls / calls


def dist_replayed(eng, C, calls, st, seed=0):
    """Whether a second run from ``seed`` ends in the same bits as ``st``."""
    again = eng.init(seed, C)
    for _ in range(calls):
        again = eng.sweep(again)
    return all(torch.equal(a, b) for a, b in
               zip(dist_state_bits(again), dist_state_bits(st)))


def dist_call_profile(eng, st):
    """One sweep call of a dist engine under torch.profiler: the device
    ops it ran (kernels, memcpys, memsets), the device's busy ms and its
    share of the call's wall (host clock to a synchronize, the profiler's
    cost included); and the host's issue ms per call over a stream of 10
    calls."""
    box = [st]

    def call():
        box[0] = eng.sweep(box[0])

    def run():
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()
    dev, wall = device_events(run, cpu=True)
    evs = [e for e in dev if not e.key.startswith("repro.")
           and e.self_device_time_total > 0]
    check(bool(evs), "9 dist: torch.profiler saw no device time")
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    return dict(device_ops=sum(e.count for e in evs), device_busy_ms=busy,
                profiled_wall_ms=1e3 * wall, busy_share=busy / (1e3 * wall),
                host_issue_ms=host_ms(call, 10))


def allreduce_ms(nbytes, group):
    """CUDA-event median ms of one all-reduce of ``nbytes`` of float32
    over ``group`` (timed apart from the engines' counted calls)."""
    import torch.distributed as dist
    buf = torch.zeros(max(nbytes // 4, 1), device="cuda")
    return median_ms(lambda: dist.all_reduce(buf, group=group), 20, 3)


def dist_engine_run(name, eng, C, calls, smi, main_path=None, snapshots=1,
                    profile=False):
    """Drive one dist engine: the run (no host sync), one all-reduce per
    call, a replay to the same bits, finite and in-domain state; with
    ``profile`` the call's device ops, busy share and host issue, and the
    all-reduce's time at the engine's payload."""
    from repro_torch.runtime import dist_gibbs as DG
    torch.cuda.synchronize()
    st, errs, wall, per_call = dist_run(eng, C, calls, snapshots)
    S = eng.updates_per_call
    check(per_call == 1.0, f"9 {name}: {per_call} all-reduces per call")
    check(all(np.isfinite(errs)), f"9 {name}: non-finite marginal error")
    check(int(st.x.min()) >= 0 and int(st.x.max()) < eng.graph.D
          and bool(torch.isfinite(st.inner.cache if hasattr(st, "inner")
                                  else st.cache).all()),
          f"9 {name}: state out of domain or cache not finite")
    check(dist_replayed(eng, C, calls, st),
          f"9 {name}: a replay from seed 0 ended elsewhere")
    acc = (1.0 if eng.exact_accept else
           float(DG.gather_marginals(st, eng.mesh)[1].sum())
           / (calls * S * C))
    fp = DG.psum_footprint(eng.name, C=C, D=eng.graph.D, S=S)
    rec = dict(chains=C, sweep=S, calls=calls, params=eng.params,
               marg_err=errs, acceptance=acc, seconds=wall,
               ms_per_call=1e3 * wall / calls,
               updates_per_s=calls * S * C / wall, allreduce_per_call=per_call,
               moved=int((st.x != 0).sum()), psum_footprint=fp,
               replay_bit_identical=True, card=smi)
    if main_path is not None:
        rec["single_device_updates_per_s"] = main_path["updates_per_s"]
    if profile:
        rec.update(dist_call_profile(eng, st))
        rec["busy_share_of_call"] = rec["device_busy_ms"] / rec["ms_per_call"]
        rec["allreduce_ms"] = allreduce_ms(fp["psum_payload_bytes"],
                                           DG.MeshShard.of(eng.mesh)
                                           .model_group)
    extra = ("" if main_path is None else
             f" (single device, phase 4: "
             f"{main_path['updates_per_s'] / 1e6:.3f}M)")
    say("9a dist", f"{name} C={C} S={S}: {calls} calls, no host sync, "
        f"{per_call:.0f} all-reduce per call, replay bit-identical; "
        f"marg_err {errs[0]:.6f} -> {errs[-1]:.6f}; acc={acc:.4f}; "
        f"{rec['ms_per_call']:.3f} ms per call, "
        f"{rec['updates_per_s'] / 1e6:.3f}M updates/s{extra}; payload "
        f"{fp['psum_payload_bytes']} B per call; on {smi}")
    if profile:
        say("9a dist", f"{name}: one call under torch.profiler: "
            f"{rec['device_ops']} device ops, device busy "
            f"{rec['device_busy_ms']:.4f} ms of {rec['profiled_wall_ms']:.4f}"
            f" ms (busy share {rec['busy_share']:.4f}; "
            f"{rec['busy_share_of_call']:.4f} of the unprofiled call); "
            f"host issue "
            f"{rec['host_issue_ms']:.4f} ms per call (stream of 10); the "
            f"all-reduce alone {rec['allreduce_ms']:.4f} ms at its "
            f"{fp['psum_payload_bytes']} B (CUDA events); on {smi}")
    return rec


def dist_chromatic(lattice, mesh, C, seed=3, sweeps=2):
    """Chromatic gibbs on lattice-ising-64x64 through the dist engine
    against the dense reference on the same shared generator: x the same
    bits after every sweep; two all-reduces per call."""
    from repro_torch.core import engine
    from repro_torch.runtime import dist_gibbs as DG
    g = lattice.graph
    eng = engine.make("gibbs", g, mesh=mesh,
                      schedule=engine.ChromaticBlocks(lattice.colors))
    dense = DG.make_chromatic_gibbs_step(g, lattice.colors)
    gen = torch.Generator(device=g.device)
    gen.manual_seed(DG.shard_seeds(seed, 0, 0)[0])
    st = eng.init(seed, C)
    x_ref = torch.zeros_like(st.x)
    before = DG.all_reduce.calls
    for sweep in range(sweeps):
        for c in range(2):
            x_ref = dense(x_ref, gen, c)
        st = eng.sweep(st)
        check(torch.equal(st.x, x_ref), f"9 chromatic: sweep {sweep} differs "
              f"from the dense reference")
    per_call = (DG.all_reduce.calls - before) / sweeps
    check(per_call == 2.0, f"9 chromatic: {per_call} all-reduces per call")
    return eng, st


def phase_dist_one_rank(potts, lattice, smi, main_path):
    """9a: one rank on NCCL, a (1, 1) mesh, full width."""
    from repro_torch.core import engine
    from repro_torch.launch import gibbs as launcher
    from repro_torch.runtime import dist_gibbs as DG
    mesh = dist_mesh((1, 1))
    # NCCL makes its communicator at the first collective: outside the
    # no-sync loops
    DG.all_reduce(torch.zeros(1, device="cuda"), mesh.get_group("model"))
    torch.cuda.synchronize()
    out = {}
    for name in ("gibbs", "mgpmh"):
        eng = engine.make(name, potts, sweep=S_FULL, mesh=mesh)
        check(eng.backend == "dist", f"9 {name}: backend {eng.backend}")
        rec = dist_engine_run(name, eng, C_FULL, DIST_CALLS, smi,
                              main_path[name], DIST_SNAPSHOTS, profile=True)
        check(rec["marg_err"][-1] < rec["marg_err"][0],
              f"9 {name}: marginal error not falling {rec['marg_err']}")
        out[name] = rec
    check(out["mgpmh"]["acceptance"] > 0.9,
          f"9 mgpmh: acceptance {out['mgpmh']['acceptance']} <= 0.9")
    builds, engines = {}, {}
    for name, S in (("min-gibbs", S_MIN), ("doublemin", S_DIST_SMALL)):
        t0 = time.perf_counter()
        engines[name] = engine.make(name, potts, sweep=S, mesh=mesh)
        builds[name] = time.perf_counter() - t0
    # min-gibbs at its phase-4 shape
    for name, C in (("min-gibbs", C_MIN), ("doublemin", C_DIST_SMALL)):
        eng, build = engines.pop(name), builds[name]
        torch.cuda.reset_peak_memory_stats()
        rec = dist_engine_run(name, eng, C, DIST_SHORT_CALLS, smi)
        rec.update(engine_build_s=build,
                   peak_bytes=torch.cuda.max_memory_allocated())
        check(rec["moved"] > 0 or name == "doublemin",
              f"9 {name}: no chain moved")
        say("9a dist", f"{name}: engine built in {build:.2f} s (sharded "
            f"tables on the host); peak device memory "
            f"{rec['peak_bytes'] / 2 ** 30:.2f} GiB; on {smi}")
        out[name] = rec
    config, C, S, calls, lam = DIST_BENCH
    bench = engine.make_workload(config, device="cuda").graph
    for name, kw in (("gibbs", {}), ("mgpmh", {}), ("min-gibbs",
                     dict(lam=lam)), ("doublemin", dict(lam2=lam))):
        eng = engine.make(name, bench, sweep=S, mesh=mesh, **kw)
        out[f"{name} {config}"] = dist_engine_run(
            f"{name} {config} (the JAX bench's dist shape)", eng, C, calls,
            smi)
    t0 = time.perf_counter()
    eng, st = dist_chromatic(lattice, mesh, C_FULL)
    prof = dist_call_profile(eng, st)
    out["chromatic"] = dict(prof, bit_equal_sweeps=2, chains=C_FULL,
                            seconds=time.perf_counter() - t0, card=smi)
    say("9a dist", f"chromatic gibbs lattice-ising-64x64 C={C_FULL}: 2 "
        f"sweeps bit-equal to make_chromatic_gibbs_step, 2 all-reduces per "
        f"call; one call: {prof['device_ops']} device ops, busy "
        f"{prof['device_busy_ms']:.4f} ms of {prof['profiled_wall_ms']:.4f}"
        f" ms, host issue {prof['host_issue_ms']:.4f} ms; on {smi}")
    # the launcher's run, as torchrun would drive it on this rank
    t0 = time.perf_counter()
    before = DG.all_reduce.calls
    st = launcher.run("potts-64x64", "gibbs", DIST_CALLS, C_FULL,
                      sweep=S_FULL, log_every=DIST_CALLS // 2,
                      backend="dist", mp_shards=1, device="cuda")
    wall = time.perf_counter() - t0
    colls = DG.all_reduce.calls - before
    check(st.count == DIST_CALLS and colls == DIST_CALLS + 2,
          f"9 launcher: {st.count} samples, {colls} all-reduces")
    out["launcher"] = dict(seconds=wall, allreduces=colls, card=smi)
    say("9a dist", f"launcher run(backend='dist') gibbs potts-64x64 "
        f"C={C_FULL} S={S_FULL}: {DIST_CALLS} calls + 2 log-line gathers = "
        f"{colls} all-reduces, {wall:.2f} s with the workload build; on "
        f"{smi}")
    return out


def dist_child(rank, world, store, shape, out):
    """9b rank body: one of two processes sharing the card, on
    DIST_TWO_RANK_BACKEND."""
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(DIST_TWO_RANK_BACKEND,
                                init_method=f"file://{store}", rank=rank,
                                world_size=world)
        from repro_torch.core import engine
        from repro_torch.core.factor_graph import (TabularPairwiseGraph,
                                                   make_potts_graph)
        from repro_torch.launch.mesh import mesh_coords
        from repro_torch.runtime import dist_gibbs as DG
        mesh = dist_mesh(shape)
        g = make_potts_graph(grid=2, beta=0.8, D=3, device="cuda")
        tg = TabularPairwiseGraph.from_match_graph(g)
        # the factors {a, b}; marginals and edge agreements by enumeration
        a, b = torch.nonzero(torch.triu(g.W, 1) > 0, as_tuple=True)
        exact = np.zeros((g.n, g.D))
        exact_agree = np.zeros(len(a))
        for p, s in zip(tg.pi(), tg.all_states()):
            exact[np.arange(g.n), s] += p
            exact_agree += p * (s[a.cpu().numpy()] == s[b.cpu().numpy()])
        mp_index = mesh_coords(mesh)[2]
        C, S, calls = DIST_SMALL
        res = {}
        t0 = time.perf_counter()
        for name in ("gibbs", "mgpmh", "min-gibbs", "doublemin"):
            kw = dict(lam=float(2 * g.psi ** 2)) if name == "min-gibbs" \
                else {}
            eng = engine.make(name, g, mesh=mesh, sweep=S, **kw)
            st = eng.init(0, C)
            agree = torch.zeros(len(a), device="cuda")
            before = DG.all_reduce.calls
            for _ in range(calls):
                st = eng.sweep(st)
                agree += (st.x[:, a] == st.x[:, b]).sum(0)
            per_call = (DG.all_reduce.calls - before) / calls
            marg, _ = DG.gather_marginals(st, mesh)
            err = float(np.abs(marg.sum(0).cpu().numpy() / (st.count * C)
                               - exact).max())
            # model shards hold the same chains: model shard 0 counts them
            agree *= float(mp_index == 0)
            dist.all_reduce(agree)                 # outside the counts
            res[name] = dict(err=err, per_call=per_call, agree_err=float(
                np.abs(agree.cpu().numpy() / (calls * C)
                       - exact_agree).max()))
        res["seconds"] = time.perf_counter() - t0
        if shape == (1, 2):
            lattice = engine.make_workload("lattice-ising-64x64",
                                           device="cuda")
            dist_chromatic(lattice, mesh, 2)
            res["chromatic_bit_equal"] = True
        dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:                  # reported to the parent, which
        import traceback                   # fails the phase
        out.put((rank, False, traceback.format_exc()))
        raise


def phase_dist_two_ranks(smi):
    """9b: two processes on the one card, meshes 1x2 and 2x1."""
    import multiprocessing as mp
    import queue as queue_lib
    import tempfile
    out = {}
    ctx = mp.get_context("spawn")
    for shape in ((1, 2), (2, 1)):
        q = ctx.Queue()
        with tempfile.TemporaryDirectory() as tmp:
            procs = [ctx.Process(target=dist_child,
                                 args=(r, 2, f"{tmp}/store", shape, q))
                     for r in range(2)]
            t0 = time.perf_counter()
            for p in procs:
                p.start()
            results, deadline = {}, time.monotonic() + DIST_JOIN_S
            try:
                while len(results) < 2:
                    try:
                        rank, ok, value = q.get(timeout=1.0)
                    except queue_lib.Empty:
                        dead = [p.exitcode for p in procs
                                if p.exitcode not in (None, 0)]
                        check(not dead, f"9b {shape}: a rank died {dead}")
                        check(time.monotonic() < deadline,
                              f"9b {shape}: ranks passed {DIST_JOIN_S} s")
                        continue
                    check(ok, f"9b {shape}: rank {rank} failed:\n{value}")
                    results[rank] = value
            finally:
                for p in procs:
                    p.join(timeout=max(deadline - time.monotonic(), 5.0))
                    if p.is_alive():
                        p.kill()
                        p.join()
            wall = time.perf_counter() - t0
        for rank, res in sorted(results.items()):
            for name in ("gibbs", "mgpmh", "min-gibbs", "doublemin"):
                r = res[name]
                check(r["err"] < DIST_SMALL_TOL and r["per_call"] == 1.0
                      and r["agree_err"] < DIST_AGREE_TOL,
                      f"9b {shape} rank {rank} {name}: {r}")
        key = f"{shape[0]}x{shape[1]}"
        out[key] = dict(ranks=[results[0], results[1]], seconds=wall,
                        backend=DIST_TWO_RANK_BACKEND, card=smi)
        errs = {n: max(results[r][n]["err"] for r in results)
                for n in ("gibbs", "mgpmh", "min-gibbs", "doublemin")}
        agree = {n: max(results[r][n]["agree_err"] for r in results)
                 for n in ("gibbs", "mgpmh", "min-gibbs", "doublemin")}
        say("9b two ranks", f"mesh {key} on {DIST_TWO_RANK_BACKEND}, two "
            f"processes on one card: potts 2x2 D=3 C={DIST_SMALL[0]} "
            f"S={DIST_SMALL[1]} {DIST_SMALL[2]} calls, max error "
            + ", ".join(f"{n} {e:.4f}" for n, e in errs.items())
            + f" (< {DIST_SMALL_TOL}), max edge-agreement error "
            + ", ".join(f"{n} {e:.4f}" for n, e in agree.items())
            + f" (< {DIST_AGREE_TOL}), one all-reduce per call"
            + ("; chromatic lattice-ising-64x64 C=2 bit-equal to the dense "
               "reference" if shape == (1, 2) else "")
            + f"; {wall:.1f} s with the processes' start; on {smi}")
    return out


def phase_dist(potts, lattice, smi, main_path):
    """9: the dist backend, (a) one NCCL rank in this process, (b) two
    processes sharing the card."""
    import tempfile
    import torch.distributed as dist
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            rec = {"one_rank": phase_dist_one_rank(potts, lattice, smi,
                                                   main_path)}
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    rec["two_ranks"] = phase_dist_two_ranks(smi)
    rec["seconds"] = time.perf_counter() - t0
    say("9 dist", f"{rec['seconds']:.1f} s; on {smi}")
    return rec


# ---------------------------------------------------------------------------
# Phase 10: the supervised runtime (runtime/supervisor.py)
# ---------------------------------------------------------------------------

def guarded_run_class():
    """``SupervisedRun`` with each chunk under
    ``set_sync_debug_mode("error")`` and each health read under "warn",
    its host syncs counted (``health_syncs``, one per read expected), and
    the host times of each chunk's dispatch and each health read kept."""
    import warnings
    from repro_torch.runtime.supervisor import SupervisedRun

    class GuardedRun(SupervisedRun):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.health_syncs, self.chunk_s, self.health_s = [], [], []

        def _outer_step(self, bundle, tel):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return super()._outer_step(bundle, tel)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                self.chunk_s.append(time.perf_counter() - t0)

        def _healthy(self, bundle, tel, step):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    out = super()._healthy(bundle, tel, step)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            self.health_s.append(time.perf_counter() - t0)
            self.health_syncs.append(sum(
                "synchroniz" in str(w.message) for w in seen))
            return out
    return GuardedRun


def sup_config(ckpt_dir, outer=SUP_OUTER, **kw):
    from repro_torch.runtime.supervisor import SupervisorConfig
    return SupervisorConfig(outer_steps=outer, sweeps_per_outer=SUP_CHUNK,
                            chains=C_FULL, seed=0, ckpt_dir=ckpt_dir,
                            backoff_base=0.0, workload="potts-64x64", **kw)


def sup_drive(name, factory, cfg, plan=None, ranks=None):
    """One guarded supervised run, launch counts reset before and read
    after: ``(result, run, wall s, launches, commit times)``."""
    from repro_torch.runtime.faultinject import Fault, FaultPlan
    commits = []
    run = guarded_run_class()(
        name, factory, cfg,
        None if plan is None else FaultPlan([Fault(**f) for f in plan]),
        ranks=ranks, sleep_fn=lambda s: None,
        on_step=lambda step, *a: commits.append((time.time(), step)))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(all(k == 1 for k in run.health_syncs),
          f"10 {name}: host syncs per health read {run.health_syncs}")
    return res, run, wall, launches, commits


def sup_check_faulted(tag, clean, res, run, launches, kernel):
    """10a / 10d: the faulted run bit-equal to the clean one, a restart, a
    rollback, a bad_state health incident and no restart from the nan
    fault; one sweep launch and one telemetry launch per call of every
    chunk run."""
    check(torch.equal(res.state.x, clean.state.x)
          and np.array_equal(res.marginals, clean.marginals)
          and torch.equal(res.state.accepts, clean.state.accepts),
          f"{tag}: faulted run differs from the clean run")
    check(res.restarts >= 1 and res.rollbacks >= 1,
          f"{tag}: restarts {res.restarts}, rollbacks {res.rollbacks}")
    kinds = [i["kind"] for i in res.incidents]
    check(any(i["kind"] == "health" and i["guard"] == "bad_state"
              for i in res.incidents), f"{tag}: no bad_state incident "
          f"{kinds}")
    restarts = [i for i in res.incidents if i["kind"] == "restart"]
    check(all("Preemption" in i["error"] for i in restarts),
          f"{tag}: a restart not caused by the preemption: {restarts}")
    calls = SUP_CHUNK * run._watchdog.total_steps
    if kernel is not None:
        check(launches[kernel] == calls
              and launches["telemetry_update"] == calls,
              f"{tag}: launches {launches}, {calls} calls")
    return kinds


def fault_to_commit(res, commits, kind):
    """Seconds from the first fault of ``kind`` to the next committed
    outer step."""
    t_f = next(i["time"] for i in res.incidents if i["kind"] == "fault"
               and i["fault"]["kind"] == kind)
    return next(t for t, _ in commits if t > t_f) - t_f


def sup_single(potts, smi, tmp):
    """10a and 10b on one device."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import engine
    from repro_torch.core.chains import accumulate_marginals
    from repro_torch.runtime.supervisor import SupervisedRun

    def factory(**fixed):
        return lambda name, ranks, **p: engine.make(
            name, potts, sweep=S_FULL, device=potts.device,
            **{**fixed, **p})

    out = {}
    # 10a: crash-resume
    clean, crun, clean_wall, cl, _ = sup_drive(
        "mgpmh", factory(), sup_config(f"{tmp}/clean"))
    check(clean.outer_steps == SUP_OUTER and clean.restarts == 0,
          f"10a clean: {clean.incidents}")
    res, run, wall, launches, commits = sup_drive(
        "mgpmh", factory(), sup_config(f"{tmp}/fault"), SUP_PLAN)
    kinds = sup_check_faulted("10a", clean, res, run, launches,
                              "mgpmh_sweep")
    out["crash_resume"] = dict(
        kinds=kinds, restarts=res.restarts, rollbacks=res.rollbacks,
        launches=launches, clean_launches=cl, chunks=run._watchdog.total_steps,
        wall_s=wall, clean_wall_s=clean_wall,
        outer_step_ms=1e3 * statistics.median(
            c + h for c, h in zip(crun.chunk_s, crun.health_s)),
        chunk_dispatch_ms=1e3 * statistics.median(crun.chunk_s),
        health_wait_ms=1e3 * statistics.median(crun.health_s),
        preempt_to_commit_s=fault_to_commit(res, commits, "preempt"),
        rollback_to_commit_s=fault_to_commit(res, commits, "nan"))
    # the pieces, on the clean run's final bundle
    bundle = crun._init_bundle()._replace(st=clean.state)
    tel = clean.telemetry
    torch.cuda.synchronize()
    health = []
    for _ in range(20):
        t0 = time.perf_counter()
        crun._healthy(bundle, tel, SUP_OUTER)
        health.append(time.perf_counter() - t0)
    host_ms, write_ms, verify_ms, restore_ms = [], [], [], []
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = ckpt.to_host(bundle)
        t1 = time.perf_counter()
        ckpt._write(f"{tmp}/pieces", 100 + k, host, {})
        t2 = time.perf_counter()
        check(ckpt.verify(f"{tmp}/pieces", 100 + k) == [],
              "10a: a written checkpoint does not verify")
        t3 = time.perf_counter()
        back = ckpt.restore(f"{tmp}/pieces", 100 + k, crun._init_bundle())
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        check(torch.equal(back.st.x, clean.state.x),
              "10a: restore differs from the saved state")
        host_ms.append(t1 - t0)
        write_ms.append(t2 - t1)
        verify_ms.append(t3 - t2)
        restore_ms.append(t4 - t3)
    nbytes = sum(v.nbytes for v in host.values())
    med = lambda v: 1e3 * statistics.median(v)
    out["pieces"] = dict(health_read_ms=med(health), host_copy_ms=med(
        host_ms), write_ms=med(write_ms), verify_ms=med(verify_ms),
        restore_ms=med(restore_ms), bundle_bytes=nbytes)
    del back, host
    # supervised updates/s against the bare runner's, in turns
    upd = SUP_OUTER * SUP_CHUNK * C_FULL * S_FULL

    def bare():
        eng = engine.make("mgpmh", potts, sweep=S_FULL, device=potts.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.init(0, C_FULL)
        marg = torch.zeros((C_FULL, potts.n, potts.D), device=potts.device)
        w = torch.empty((C_FULL, potts.n), device=potts.device)
        for _ in range(SUP_OUTER * SUP_CHUNK):
            st = eng.sweep(st)
            accumulate_marginals(marg, st.x, w)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def supervised(every, k):
        r = SupervisedRun("mgpmh", factory(),
                          sup_config(f"{tmp}/every{every}-{k}",
                                     ckpt_every=every),
                          sleep_fn=lambda s: None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {"bare": [], "ckpt_every_1": [], "ckpt_every_8": []}
    for k in range(SUP_TIME_REPS):
        walls["bare"].append(bare())
        walls["ckpt_every_1"].append(supervised(1, k))
        walls["ckpt_every_8"].append(supervised(8, k))
    out["updates_per_s"] = {k: upd / min(v) for k, v in walls.items()}
    out["walls_s"] = walls
    # 10b: escalation
    deg, drun, _, dl, _ = sup_drive(
        "mgpmh", factory(), sup_config(f"{tmp}/degrade", outer=4,
                                       acceptance_floor=2.0, floor_after=0,
                                       max_strikes=1, retune=False))
    check(deg.engine.name == "gibbs" and deg.outer_steps == 4
          and dl["gibbs_sweep"] > 0
          and any(i["kind"] == "degrade" for i in deg.incidents),
          f"10b degrade: engine {deg.engine.name}, launches {dl}")
    again, _, _, _, _ = sup_drive("mgpmh", factory(),
                                  sup_config(f"{tmp}/degrade", outer=6))
    check(again.engine.name == "gibbs" and again.outer_steps == 6,
          f"10b: a second run over the directory runs "
          f"{again.engine.name}")
    rt, rrun, rwall, rl, _ = sup_drive(
        "mgpmh", factory(lam=SUP_RETUNE["lam"]),
        sup_config(f"{tmp}/retune", outer=4,
                   acceptance_floor=SUP_RETUNE["floor"], floor_after=0,
                   max_strikes=1, retune_target=SUP_RETUNE["target"]))
    retunes = [i for i in rt.incidents if i["kind"] == "retune"]
    acc = float(rt.state.accepts.double().mean()) / (
        4 * SUP_CHUNK * S_FULL)
    check(retunes and rt.engine.name == "mgpmh"
          and rt.engine.params["lam"] == retunes[-1]["lam"] and acc >= 0.5,
          f"10b retune: {retunes}, acceptance {acc}")
    low = [i["win_acceptance"] for i in rt.incidents
           if i["kind"] == "health"]
    out["escalation"] = dict(
        degrade_kinds=[i["kind"] for i in deg.incidents],
        degrade_launches=dl, resumed_engine=again.engine.name,
        retune_lams=[i["lam"] for i in retunes], retune_acceptance=acc,
        floor_readings=low, retune_wall_s=rwall, retune_launches=rl)
    c = out["crash_resume"]
    p = out["pieces"]
    u = out["updates_per_s"]
    say("10a supervisor", f"mgpmh potts-64x64 C={C_FULL} S={S_FULL}, "
        f"{SUP_OUTER} outer steps x {SUP_CHUNK}, plan {SUP_PLAN}: "
        f"bit-equal to the clean run (x, marginals, accepts); incidents "
        f"{c['kinds']}; {c['chunks']} chunks, launches {c['launches']}; "
        f"one host sync per health read, none in a chunk; outer step "
        f"{c['outer_step_ms']:.3f} ms (dispatch {c['chunk_dispatch_ms']:.3f}"
        f", health read with the device's wait {c['health_wait_ms']:.3f}); "
        f"preempt to next commit {c['preempt_to_commit_s']:.4f} s, rollback "
        f"{c['rollback_to_commit_s']:.4f} s; on {smi}")
    say("10a pieces", f"health read alone {p['health_read_ms']:.4f} ms; "
        f"save: device-to-host copy {p['host_copy_ms']:.3f} ms, the write "
        f"{p['write_ms']:.3f} ms ({p['bundle_bytes'] / 2 ** 20:.2f} MiB); "
        f"verify {p['verify_ms']:.3f} ms; restore {p['restore_ms']:.3f} ms;"
        f" updates/s bare {u['bare'] / 1e6:.3f}M, supervised ckpt_every 1 "
        f"{u['ckpt_every_1'] / 1e6:.3f}M, ckpt_every 8 "
        f"{u['ckpt_every_8'] / 1e6:.3f}M; on {smi}")
    say("10b escalation", f"degrade: {out['escalation']['degrade_kinds']}, "
        f"gibbs_sweep launches {dl['gibbs_sweep']}; a second run adopts "
        f"{again.engine.name}; retune from lambda {SUP_RETUNE['lam']}: "
        f"windowed acceptance {low} under {SUP_RETUNE['floor']}, lambda "
        f"{out['escalation']['retune_lams']}, acceptance {acc:.4f}; "
        f"{rwall:.2f} s; on {smi}")
    out["launches"] = {k: c["launches"].get(k, 0) + dl.get(k, 0)
                       for k in ("mgpmh_sweep", "gibbs_sweep",
                                 "telemetry_update")}
    return out


def sup_launcher(smi, tmp, device="cuda"):
    """10c: the launcher as a subprocess on the card."""
    config, C, S, calls = SUP_LAUNCHER
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.gibbs", "--config",
            config, "--engine", "mgpmh", "--chains", str(C), "--sweep",
            str(S), "--device", device]
    plan = json.dumps({"faults": SUP_PLAN})
    sup = base + ["--steps", str(calls), "--supervise", "--supervise-chunk",
                  str(SUP_CHUNK), "--ckpt-dir", f"{tmp}/sup",
                  "--fault-plan", plan]
    first = base + ["--steps", str(calls // 2), "--ckpt-dir", f"{tmp}/plain"]
    second = base + ["--steps", str(calls), "--ckpt-dir", f"{tmp}/plain"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(ROOT)) for cmd in (sup, first)]
    outs = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("10c: the launcher passed 300 s")
        outs.append((p.returncode, o, e))
    done = subprocess.run(second, capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(ROOT))
    outs.append((done.returncode, done.stdout, done.stderr))
    wall = time.perf_counter() - t0
    for rc, o, e in outs:
        check(rc == 0, f"10c: launcher exit {rc}: {e[-2000:]}")
    summary = [l for l in outs[0][1].splitlines()
               if l.startswith("[gibbs] supervised done:")]
    check(len(summary) == 1 and "restarts=1 rollbacks=1" in summary[0],
          f"10c: summary {summary}")
    resumed = f"[gibbs] resumed at step {calls // 2}"
    check(resumed in outs[2][1] and "resumed" not in outs[1][1],
          f"10c: no '{resumed}' in {outs[2][1][-500:]}")
    say("10c launcher", f"{config} mgpmh C={C} S={S}: --supervise "
        f"--fault-plan {plan}: exit 0, '{summary[0]}'; --ckpt-dir twice: "
        f"'{resumed}'; {wall:.1f} s for the three processes; on {smi}")
    return dict(summary=summary[0], resumed=resumed, seconds=wall)


def sup_elastic_child(rank, world, store, tmp, out, device="cuda"):
    """10d (b) rank body: potts 2x2 D=3 on a 2x1 mesh of two gloo
    processes sharing the card, a device loss keeping rank 0."""
    import torch.distributed as dist
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        # every process group ends in a store barrier over the ranks that
        # must make it (a group the whole world had to make would wait for
        # the rank that left)
        os.environ["TORCH_DIST_INIT_BARRIER"] = "1"
        dist.init_process_group(DIST_TWO_RANK_BACKEND,
                                init_method=f"file://{store}", rank=rank,
                                world_size=world)
        from repro_torch.core import engine
        from repro_torch.core.factor_graph import (TabularPairwiseGraph,
                                                   make_potts_graph)
        from repro_torch.launch.mesh import make_device_mesh
        from repro_torch.runtime.faultinject import Fault, FaultPlan
        from repro_torch.runtime.supervisor import (SupervisedRun,
                                                    SupervisorConfig)
        C, S, outer, calls = SUP_ELASTIC
        g = make_potts_graph(grid=2, beta=0.8, D=3, device=device)
        tg = TabularPairwiseGraph.from_match_graph(g)
        # marginals and edge agreements P(x_a == x_b) by enumeration (the
        # marginals are 1/D by colour symmetry; the agreements depend on W)
        a, b = torch.nonzero(torch.triu(g.W, 1) > 0, as_tuple=True)
        exact = np.zeros((g.n, g.D))
        exact_agree = np.zeros(len(a))
        for p, s in zip(tg.pi(), tg.all_states()):
            exact[np.arange(g.n), s] += p
            exact_agree += p * (s[a.cpu().numpy()] == s[b.cpu().numpy()])
        agree = torch.zeros(len(a), device=device)
        seen = []

        def on_step(step, bundle, tel, eng):     # this rank's chains, on
            x = bundle.st.x                       # every committed step
            if step > SUP_ELASTIC_BURN:           # past the burn-in
                agree.add_((x[:, a] == x[:, b]).sum(0))
                seen.append(x.shape[0])

        def make_engine(name, ranks, **params):
            mesh = make_device_mesh((len(ranks), 1), ("data", "model"),
                                    ranks, device_type=device)
            if mesh is None:
                return None
            return engine.make(name, g, mesh=mesh, sweep=S, **params)
        cfg = SupervisorConfig(outer_steps=outer, sweeps_per_outer=calls,
                               chains=C, ckpt_dir=f"{tmp}/elastic",
                               backoff_base=0.0)
        t0 = time.perf_counter()
        res = SupervisedRun(
            "mgpmh", make_engine, cfg,
            FaultPlan([Fault(step=3, kind="device-loss", keep=1)]),
            sleep_fn=lambda s: None, on_step=on_step).run()
        rec = dict(left=res.left, outer_steps=res.outer_steps,
                   seconds=time.perf_counter() - t0,
                   incidents=[{k: v for k, v in i.items() if k != "time"}
                              for i in res.incidents])
        if not res.left:
            rec["err"] = float(np.abs(res.marginals - exact).max())
            rec["agree_err"] = float(np.abs(
                agree.cpu().numpy() / sum(seen) - exact_agree).max())
            rec["snapshots"] = sum(seen)
        dist.destroy_process_group()
        out.put((rank, True, rec))
    except BaseException:
        import traceback
        out.put((rank, False, traceback.format_exc()))
        raise


def sup_elastic(smi, tmp, device="cuda"):
    """10d (b): two spawned processes, joined with a deadline."""
    import multiprocessing as mp
    import queue as queue_lib
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=sup_elastic_child,
                         args=(r, 2, f"{tmp}/store", tmp, q, device))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + DIST_JOIN_S
    try:
        while len(results) < 2:
            try:
                rank, ok, value = q.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                check(not dead, f"10d: a rank died {dead}")
                check(time.monotonic() < deadline,
                      f"10d: ranks passed {DIST_JOIN_S} s")
                continue
            check(ok, f"10d: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    lead, gone = results[0], results[1]
    C, S, outer, calls = SUP_ELASTIC
    check(gone["left"] and not lead["left"] and lead["outer_steps"] == outer
          and any(i["kind"] == "elastic" and i["ranks"] == 1
                  for i in lead["incidents"]) and lead["err"] < 0.05
          and lead["agree_err"] < DIST_AGREE_TOL,
          f"10d elastic: {results}")
    say("10d elastic", f"potts 2x2 D=3 mgpmh C={C} S={S}, mesh 2x1 of two "
        f"{DIST_TWO_RANK_BACKEND} processes on the card, device loss "
        f"keep=1 at outer step 3: rank 1 left, rank 0 ran {outer} outer "
        f"steps x {calls} on 1x1, marginal error {lead['err']:.4f} (< "
        f"0.05), edge-agreement error {lead['agree_err']:.4f} (< "
        f"{DIST_AGREE_TOL}, {lead['snapshots']} chain snapshots of the "
        f"committed steps); {wall:.1f} s with the processes' start; on "
        f"{smi}")
    return dict(lead=lead, gone=gone, seconds=wall)


def sup_nccl(potts, smi, tmp):
    """10d (a): this process as one NCCL rank, a (1, 1) mesh, 10a's shape
    and plan, bit-equal to its clean run."""
    import torch.distributed as dist
    from repro_torch.core import engine
    from repro_torch.launch.mesh import make_device_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                            rank=0, world_size=1)
    try:
        dist.all_reduce(torch.zeros(1, device="cuda"))   # the communicator
        torch.cuda.synchronize()

        def factory(name, ranks, **p):
            mesh = make_device_mesh((len(ranks), 1), ("data", "model"),
                                    ranks, device_type="cuda")
            return engine.make(name, potts, sweep=S_FULL, mesh=mesh, **p)
        clean, _, cwall, _, _ = sup_drive(
            "mgpmh", factory, sup_config(f"{tmp}/dclean",
                                         outer=SUP_DIST_OUTER), ranks=[0])
        res, run, wall, launches, commits = sup_drive(
            "mgpmh", factory, sup_config(f"{tmp}/dfault",
                                         outer=SUP_DIST_OUTER),
            SUP_PLAN, ranks=[0])
        kinds = sup_check_faulted("10d NCCL", clean, res, run, launches,
                                  None)
    finally:
        dist.destroy_process_group()
    say("10d NCCL", f"one rank, mgpmh potts-64x64 C={C_FULL} S={S_FULL}, "
        f"{SUP_DIST_OUTER} outer steps x {SUP_CHUNK}, plan {SUP_PLAN}: "
        f"bit-equal to the clean run; incidents {kinds}; clean "
        f"{cwall:.2f} s, faulted {wall:.2f} s; on {smi}")
    return dict(kinds=kinds, clean_s=cwall, fault_s=wall,
                preempt_to_commit_s=fault_to_commit(res, commits, "preempt"),
                rollback_to_commit_s=fault_to_commit(res, commits, "nan"))


def phase_supervisor(potts, smi):
    """10: the supervised runtime on the card."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rec = sup_single(potts, smi, tmp)
        rec["launcher"] = sup_launcher(smi, tmp)
        torch.cuda.empty_cache()
        rec["nccl"] = sup_nccl(potts, smi, tmp)
        torch.cuda.empty_cache()
        rec["elastic"] = sup_elastic(smi, tmp)
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = smi
    say("10 supervisor", f"{rec['seconds']:.1f} s; on {smi}")
    return rec


# ---------------------------------------------------------------------------
# Phase 11: serving (serving/pool.py, launch/serve.py)
# ---------------------------------------------------------------------------

def pool_make(graph, name, wl, C, S, **kw):
    """A ``ChainPool`` with one registered workload on the card:
    ``(pool, workload)``; ``kw`` takes the pool's policies."""
    from repro_torch.diagnostics.freshness import FreshnessPolicy
    from repro_torch.serving import ChainPool
    pool = ChainPool(policy=kw.pop("policy", FreshnessPolicy()), seed=0,
                     **kw)
    w = pool.register(wl, graph=graph, engine=name, chains=C, sweep=S,
                      sweeps_per_chunk=POOL_CHUNK)
    return pool, w


def pool_lanes(w):
    return [((), w.resident), *w.lanes.items()]


def pool_traffic(pool, queries, **kw):
    """One batch through ``submit``, launch counts reset before and read
    after: ``(answers, host seconds, launches)``."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    answers = pool.submit(queries, **kw)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return answers, wall, {k: v for k, v in read_launches().items() if v}


def pool_chunk_launches(tag, pool, w, kernel):
    """One chunk of every lane under ``set_sync_debug_mode("error")``, each
    lane's launches counted: POOL_CHUNK sweep-kernel and POOL_CHUNK
    telemetry-kernel launches and nothing else, clamped or not."""
    want = {kernel: POOL_CHUNK, "telemetry_update": POOL_CHUNK}
    per_lane = {}
    for sig, lane in pool_lanes(w):
        torch.cuda.synchronize()
        reset_launches()
        with no_host_sync():
            pool._advance_lane(w, lane, 1)
        torch.cuda.synchronize()
        got = {k: v for k, v in read_launches().items() if v}
        check(got == want, f"{tag}: lane {sig} launched {got}, want {want}")
        per_lane[json.dumps(sig)] = got
    return per_lane


PLAIN_SWEEPS = {
    "gibbs_sweep": lambda ref, ops, x, W, i, g, *, D: ref.gibbs_sweep_ref(
        x, W, i, g, D),
    "mgpmh_sweep": lambda ref, ops, x, W, rp, *rest, D, scale:
        ref.mgpmh_sweep_ref(x, W, *ops._unpack(rp), *rest, D, scale),
    "min_gibbs_sweep": lambda ref, ops, x, npk, rpk, *rest, D, lscale:
        ref.min_gibbs_sweep_ref(x, *ops._unpack(npk), *ops._unpack(rpk),
                                *rest, D, lscale),
}
# the chain-indexed arguments of each sweep (ops.py's argument order)
PER_CHAIN = {"gibbs_sweep": (0, 2, 3),
             "mgpmh_sweep": (0, 3, 4, 5, 6, 7, 8),
             "min_gibbs_sweep": (0, 3, 4, 5, 6, 7, 8, 9, 10)}


def pool_chunk_vs_plain(tag, pool, w, lane, kernel, exact, chains=None):
    """One chunk of a clamped lane with each launch held against its plain
    version on the card, on the same inputs: every sweep call's outputs
    through ``compare`` (over the first ``chains`` chains, all when None),
    and every telemetry update against the plain update on a copy of the
    carry taken just before it, bit for bit."""
    from repro_torch.diagnostics import telemetry as T
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.pool import _copy
    kept, tel_equal = [], []
    orig_sweep, orig_tel = getattr(ops, kernel), T.telemetry_update_cuda

    def sweep(*args, **kw):
        out = orig_sweep(*args, **kw)
        c = chains or args[0].shape[0]
        part = [a[:c] if j in PER_CHAIN[kernel] else a
                for j, a in enumerate(args)]
        plain = PLAIN_SWEEPS[kernel](ref, ops, *part, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        kept.append((tuple(o[:c] for o in outs),
                     plain if isinstance(plain, tuple) else (plain,)))
        return out

    def tel_update(tel, *args, **kw):
        before = _copy(tel)
        plan = orig_tel(tel, *args, **kw)
        after = _copy(tel)._replace(head=plan.new_head, count=plan.count_new)
        kw.pop("decay", None)
        plain = T.telemetry_update_plain(before, *args, **kw)
        a, b = tel_fields(after), tel_fields(plain)
        tel_equal.append(all(np.array_equal(a[f].view(np.int32),
                                            b[f].view(np.int32))
                             for f in a))
        return plan

    setattr(ops, kernel, sweep)
    T.telemetry_update_cuda = tel_update
    try:
        pool._advance_lane(w, lane, 1)
        torch.cuda.synchronize()
    finally:
        setattr(ops, kernel, orig_sweep)
        T.telemetry_update_cuda = orig_tel
    check(len(kept) == len(tel_equal) == POOL_CHUNK,
          f"{tag}: {len(kept)} sweep and {len(tel_equal)} telemetry "
          f"launches held, want {POOL_CHUNK}")
    C = kept[0][0][0].shape[0]
    out_k = tuple(o for k, _ in kept for o in k)
    out_p = tuple(o for _, p in kept for o in p)
    n_diff, err = compare(f"{kernel} ({POOL_CHUNK} calls of a clamped "
                          f"lane's chunk)", out_k, out_p, C, exact=exact,
                          phase=tag)
    check(all(tel_equal), f"{tag}: telemetry kernel != plain update at "
          f"calls {[k for k, e in enumerate(tel_equal) if not e]}")
    say(tag, f"telemetry_update: {POOL_CHUNK} launches bit-equal to the "
        f"plain update")
    return dict(chains=C, chains_differ=n_diff, max_abs_err=err,
                telemetry_bit_equal=True)


def pool_overhead(pool, w, sig):
    """The resilience policies' cost on the answer path (the reference's
    ``test_resilience_answer_overhead_within_budget`` measurement, not a
    gate): the armed ``submit`` of one query against the bare freshness
    read + marginal extraction it wraps, min of POOL_REPS each, in turns,
    on a lane that serves stale (no sweeping)."""
    from repro_torch.serving import Query
    lane = w.lanes[sig] if sig else w.resident

    def bare():
        pool._lane_report(w, lane, lane.snap)
        return pool._snap_marginals(lane.snap)

    def armed():
        return pool.submit([Query(w.name, evidence=sig)], max_extra_sweeps=0,
                           serve_stale=True)[0]

    times = {"bare": [], "armed": []}
    for fn in (bare, armed):
        fn()
    for _ in range(POOL_REPS):
        for k, fn in (("bare", bare), ("armed", armed)):
            t0 = time.perf_counter()
            fn()
            times[k].append(time.perf_counter() - t0)
    bare_ms, armed_ms = (1e3 * min(times[k]) for k in ("bare", "armed"))
    return dict(bare_ms=bare_ms, armed_ms=armed_ms,
                ratio=armed_ms / bare_ms)


def pool_gate(pool, w):
    """The freshness gate on the resident: POOL_GATE_EVERY chunks between
    gate reads until it passes or POOL_GATE_S pass."""
    lane = w.resident
    t0 = time.perf_counter()
    reads = []
    while True:
        pool._advance_lane(w, lane, POOL_GATE_EVERY)
        tr = time.perf_counter()
        rep = pool._lane_report(w, lane, lane.snap)
        reads.append(time.perf_counter() - tr)
        if rep["fresh"] or time.perf_counter() - t0 > POOL_GATE_S:
            break
    return dict(fresh=rep["fresh"], reason=rep["reason"],
                chunks=lane.sweeps // POOL_CHUNK, samples=rep["samples"],
                max_rhat=rep["max_rhat"], min_ess=rep["min_ess"],
                seconds=time.perf_counter() - t0,
                gate_read_ms=1e3 * statistics.median(reads))


def pool_full_width(potts, smi):
    """11a: potts-64x64 at the main path's width."""
    from repro_torch.launch.serve import _demo_queries
    from repro_torch.serving import pool as P
    wl = "potts-64x64"
    out, launches = {}, {}
    for name, kernel in (("gibbs", "gibbs_sweep"), ("mgpmh", "mgpmh_sweep")):
        tag = f"11a {name}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pool, w = pool_make(potts, name, wl, C_FULL, S_FULL)
        lane = w.resident
        pool.advance(wl, chunks=1)               # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.advance(wl, chunks=1)
        dispatch_ms = 1e3 * (time.perf_counter() - t0)
        chunk_ms = median_ms(lambda: pool.advance(wl, chunks=1), 5)
        publish_ms = median_ms(lambda: P._publish(lane.work, lane.sweeps), 5)
        copy_bytes = sum(t.numel() * t.element_size()
                         for t in (lane.work.marg, *[
                             v for v in (*lane.work.st, *lane.work.tel)
                             if isinstance(v, torch.Tensor)]))
        queries = _demo_queries(wl, potts, POOL_DEMO, 0)
        batches = []
        for k in range(2):
            answers, wall, got = pool_traffic(pool, queries,
                                              max_extra_sweeps=POOL_BUDGET)
            for kk, v in got.items():
                launches[kk] = launches.get(kk, 0) + v
            check(all(a.status == "ok" for a in answers)
                  and all(np.isfinite(a.marginals).all() for a in answers),
                  f"{tag} batch {k}: {[a.report for a in answers]}")
            for a in answers:            # observed sites are deltas
                for s, v in a.query.evidence:
                    check(a.marginals[s][v] == 1.0, f"{tag}: site {s} of "
                          f"{a.query.evidence} is not a delta")
            batches.append(dict(
                seconds=wall, queries_per_s=len(queries) / wall,
                rungs=[a.source for a in answers],
                fresh=[a.fresh for a in answers],
                samples=[a.report["samples"] for a in answers],
                launches=got))
        check(pool.compiled_cache_size(wl) == 1,
              f"{tag}: {pool.compiled_cache_size(wl)} chunk signatures")
        per_lane = pool_chunk_launches(tag, pool, w, kernel)
        clamped = next(sig for sig, _ in pool_lanes(w) if sig)
        held = pool_chunk_vs_plain(f"{tag} plain", pool, w, w.lanes[clamped],
                                   kernel, exact=False)
        overhead = pool_overhead(pool, w, clamped)
        gate = pool_gate(pool, w) if name == "mgpmh" else None
        torch.cuda.synchronize()
        rec = dict(chunk_ms=chunk_ms, chunk_dispatch_ms=dispatch_ms,
                   publish_ms=publish_ms, publish_bytes=copy_bytes,
                   batches=batches, lanes=len(per_lane),
                   launches_per_chunk=per_lane, plain=held,
                   overhead=overhead, gate=gate,
                   pool_bytes=torch.cuda.memory_allocated() - base,
                   peak_bytes=torch.cuda.max_memory_allocated() - base)
        out[name] = rec
        b1, b2 = batches
        say(tag, f"potts-64x64 C={C_FULL} S={S_FULL}, chunks of "
            f"{POOL_CHUNK}: chunk {chunk_ms:.3f} ms (host dispatch "
            f"{dispatch_ms:.3f}), publish copy {publish_ms:.4f} ms "
            f"({copy_bytes / 2 ** 20:.1f} MiB); {len(per_lane)} lanes, each "
            f"chunk {per_lane[json.dumps([])]} clamped or not, no host "
            f"sync; batch 1 {b1['seconds']:.3f} s ({b1['queries_per_s']:.1f}"
            f" q/s) rungs {b1['rungs']}, batch 2 {b2['seconds']:.3f} s "
            f"({b2['queries_per_s']:.1f} q/s) rungs {b2['rungs']}; answer "
            f"path armed {overhead['armed_ms']:.3f} ms vs bare "
            f"{overhead['bare_ms']:.3f} ms ({overhead['ratio']:.3f}x); pool "
            f"{rec['pool_bytes'] / 2 ** 30:.3f} GiB, peak "
            f"{rec['peak_bytes'] / 2 ** 30:.3f} GiB; on {smi}")
        if gate is not None:
            say(f"{tag} gate", f"resident after {gate['chunks']} chunks "
                f"({gate['samples']} samples, {gate['seconds']:.1f} s): "
                f"fresh {gate['fresh']}, max R-hat {gate['max_rhat']}, min "
                f"ESS {gate['min_ess']} ({gate['reason']}); gate read "
                f"{gate['gate_read_ms']:.1f} ms; on {smi}")
        if name == "mgpmh":
            out["profiled"] = (pool, w)
        del pool, w, lane
    out["launches"] = launches
    return out


def pool_state_bits(snap, carry=True):
    """What of a snapshot must repeat bit for bit: the state, its
    generator, the sums and (``carry``) the telemetry carry."""
    tel = [t for t in snap.tel if isinstance(t, torch.Tensor)] * carry
    return [snap.st.x, snap.st.cache, snap.st.accepts, snap.marg,
            snap.st.gen.get_state(), *tel]


def pool_same(a, b, carry=True):
    return a.count == b.count and all(
        torch.equal(x, y) for x, y in zip(pool_state_bits(a, carry),
                                           pool_state_bits(b, carry)))


def pool_exact(g, sig):
    from repro_torch.diagnostics import exact_conditional_marginals
    return exact_conditional_marginals(g, [s for s, _ in sig],
                                       [v for _, v in sig])


def pool_pairs(g, smi):
    """11b: POOL_PAIRS at C=C_FULL S=S_FULL, gibbs and min-gibbs."""
    from repro_torch.serving import Query
    wl = POOL_PAIRS
    out, launches = {}, {}
    for name, kernel, budget in (("gibbs", "gibbs_sweep", POOL_FRESH_BUDGET),
                                 ("min-gibbs", "min_gibbs_sweep",
                                  POOL_MIN_BUDGET)):
        tag = f"11b {name}"
        pool, w = pool_make(g, name, wl, C_FULL, S_FULL)
        sig = ((0, 1),)
        (ans,), wall, got = pool_traffic(pool, [Query(wl, evidence=sig)],
                                         max_extra_sweeps=budget)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        exact = pool_exact(g, sig)
        rec = dict(fresh=ans.fresh, source=ans.source, seconds=wall,
                   sweeps=ans.sweeps, report=ans.report, launches=got)
        if ans.marginals is not None:
            tv = 0.5 * np.abs(ans.marginals - exact).sum(-1)
            rec.update(tv_mean=float(tv.mean()), tv_max=float(tv.max()))
            check(ans.marginals[0].tolist() == [0.0, 1.0],
                  f"{tag}: observed site not a delta")
        if name == "gibbs" or ans.fresh:
            check(ans.fresh and rec["tv_mean"] < POOL_TV[0]
                  and rec["tv_max"] < POOL_TV[1],
                  f"{tag}: fresh {ans.fresh}, {rec}")
        # a cold lane's exact rung
        cold_sig = ((5, 0), (g.n - 3, 1))
        cold = pool.submit([Query(wl, evidence=cold_sig)],
                           max_extra_sweeps=0)[0]
        cold_err = float(np.abs(cold.marginals - pool_exact(g, cold_sig))
                         .max())
        check(cold.source == "exact" and cold_err <= 1e-12,
              f"{tag}: cold lane {cold.source}, error {cold_err}")
        rec["cold_exact_err"] = cold_err
        rec["plain"] = pool_chunk_vs_plain(
            f"{tag} plain", pool, w, w.lanes[sig], kernel, exact=True,
            chains=POOL_PLAIN_CHAINS if name == "min-gibbs" else None)
        # the resident against an unserved control pool
        served, ws = pool_make(g, name, wl, C_FULL, S_FULL)
        control, _ = pool_make(g, name, wl, C_FULL, S_FULL)
        for k in range(3):
            served.advance(wl, chunks=2)
            served.submit([Query(wl), Query(wl, evidence=((2 * k, 1),))],
                          max_extra_sweeps=0, serve_stale=True)
        control.advance(wl, chunks=ws.resident.sweeps // POOL_CHUNK)
        torch.cuda.synchronize()
        same = pool_same(served.snapshot(wl), control.snapshot(wl))
        check(same and len(ws.lanes) == 3,
              f"{tag}: the served resident differs from the control")
        rec["resident_equal_control"] = same
        say(tag, f"{wl} C={C_FULL} S={S_FULL}: a lane clamped at {sig}: "
            f"{ans.source} after {ans.sweeps} sweeps ({wall:.2f} s), TV to "
            f"exact mean {rec.get('tv_mean')} max {rec.get('tv_max')}; cold "
            f"lane exact rung error {cold_err}; resident bit-equal to an "
            f"unserved control (x, cache, accepts, marg, generator, carry) "
            f"after 6 chunks with 3 forks; on {smi}")
        out[name] = rec
        del pool, w, served, control, ws
        torch.cuda.empty_cache()
    out["chaos"], got = pool_chaos(g, smi)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def pool_chaos(g, smi):
    """11b: the chaos drill of tests/test_resilience.py:375-426 on the card,
    plus a cold lane under an expired deadline every round (the exact
    rung)."""
    from repro_torch.diagnostics.freshness import FreshnessPolicy
    from repro_torch.serving import (AdmissionPolicy, BreakerPolicy,
                                     CircuitBreaker, Query)
    wl, cfg = POOL_PAIRS, POOL_CHAOS
    pool, w = pool_make(
        g, "gibbs", wl, C_FULL, S_FULL,
        policy=FreshnessPolicy(**cfg["policy"]),
        admission=AdmissionPolicy(max_pending=cfg["max_pending"]),
        breaker=BreakerPolicy(open_after=cfg["open_after"], cooldown_s=0.0))
    sig, cold = ((7, 1),), ((11, 0),)
    base = [Query(wl), Query(wl, evidence=sig, priority=1)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    warm = pool.submit(base, max_extra_sweeps=POOL_FRESH_BUDGET)
    check(all(a.fresh for a in warm), f"11b chaos: warm-up not fresh: "
          f"{[a.report for a in warm]}")
    exact = {(): pool_exact(g, ()), sig: pool_exact(g, sig),
             cold: pool_exact(g, cold)}
    pool.inject_lane_fault(wl, sig, target="cache")
    pool.advance(wl, chunks=1)
    statuses, sources, worst = set(), set(), 0.0
    for _ in range(cfg["rounds"]):
        batch = base + [Query(wl, deadline_ms=0.0), Query(wl, evidence=sig),
                        Query(wl, sites=(0, 1), kind="map"),
                        Query(wl, evidence=cold, deadline_ms=0.0,
                              priority=1)]
        answers = pool.submit(batch, max_extra_sweeps=0)
        check(len(answers) == len(batch), "11b chaos: answers missing")
        for a in answers:
            check(a.status in ("ok", "shed", "refused", "error"),
                  f"11b chaos: status {a.status}")
            statuses.add(a.status)
            if a.source:
                sources.add(a.source)
            if a.marginals is not None:
                ref = exact[a.query.signature]
                if a.query.sites is not None:
                    ref = ref[list(a.query.sites)]
                check(np.isfinite(a.marginals).all(), "11b chaos: not finite")
                worst = max(worst, float(np.abs(a.marginals - ref).max()))
    lane = w.lanes[sig]
    opens = lane.breaker.open_count
    recovered = pool.submit([Query(wl, evidence=sig)])[0]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    got = {k: v for k, v in read_launches().items() if v}
    check({"ok", "shed"} <= statuses and {"stale", "exact"} <= sources
          and worst <= cfg["tol"] and opens >= 1
          and recovered.status == "ok"
          and lane.breaker.state == CircuitBreaker.CLOSED
          and pool.admission.in_flight == 0,
          f"11b chaos: statuses {statuses}, sources {sources}, worst "
          f"{worst}, opens {opens}, recovered {recovered.status}, breaker "
          f"{lane.breaker.state}, in flight {pool.admission.in_flight}")
    say("11b chaos", f"{wl} gibbs C={C_FULL}: {cfg['rounds']} rounds under "
        f"a poisoned lane, max_pending {cfg['max_pending']}, expired "
        f"deadlines: statuses {sorted(statuses)}, rungs {sorted(sources)}, "
        f"every estimate within {worst:.4f} of exact (<= {cfg['tol']}); "
        f"breaker opened {opens}x, the probe closed it "
        f"({recovered.source}); in flight 0; {wall:.2f} s; on {smi}")
    return dict(statuses=sorted(statuses), sources=sorted(sources),
                worst=worst, opens=opens, recovered=recovered.source,
                seconds=wall), got


def pool_supervised(g, smi, tmp):
    """11c: ``serve_batch(supervise=True)`` on POOL_PAIRS under phase 10's
    plan against a clean supervised run: the last published snapshots and
    the answers bit-equal, the epoch fences, fault to the next published
    snapshot."""
    from repro_torch import obs
    from repro_torch.launch.serve import _demo_queries, serve_batch
    from repro_torch.runtime.faultinject import Fault, FaultPlan
    from repro_torch.serving import ChainPool
    wl = POOL_PAIRS
    queries = _demo_queries(wl, g, POOL_DEMO, 0)
    runs = {}
    for label, plan in (("clean", None), ("fault", SUP_PLAN)):
        rec = obs.Recorder()
        pool = ChainPool(seed=0)
        published = []

        def on_publish(*a, _pub=pool.publish, _out=published, _pool=pool,
                       _rec=rec):
            _pub(*a)
            _out.append((_rec.now_us(), _pool.snapshot(wl)))
        pool.publish = on_publish
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with obs.using(rec):
            res = serve_batch(
                wl, queries, engine="gibbs", chains=C_FULL, sweep=S_FULL,
                chunk=SUP_CHUNK, supervise=True,
                ckpt_dir=f"{tmp}/serve-{label}", outer_steps=SUP_OUTER,
                pool=pool, max_extra_sweeps=POOL_BUDGET,
                fault_plan=None if plan is None
                else FaultPlan([Fault(**f) for f in plan]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = [e for e in rec.trace.events() if e.get("ph") == "i"]
        runs[label] = dict(res=res, published=published, wall=wall,
                           events=events,
                           launches={k: v for k, v in
                                     read_launches().items() if v})
    clean, fault = runs["clean"], runs["fault"]
    a, b = fault["published"][-1][1], clean["published"][-1][1]
    # the supervisor restarts the carry at every recovery: state, generator
    # and sums must agree, the carry need not
    same = (pool_same(a, b, carry=False)
            and a.sweeps == b.sweeps == SUP_OUTER * SUP_CHUNK)
    same_answers = all(
        x["marginals"] == y["marginals"] and x["source"] == y["source"]
        for x, y in zip(fault["res"]["answers"], clean["res"]["answers"]))
    fences = [e for e in fault["events"] if e["name"] == "epoch_fence"]
    faults = [e["ts"] for e in fault["events"] if e["name"] == "fault"]
    to_publish = [min(t for t, _ in fault["published"] if t > f) - f
                  for f in faults]
    check(same and same_answers and len(fences) == 2
          and all(r["status"] == "ok" for r in fault["res"]["answers"]),
          f"11c: snapshot equal {same}, answers equal {same_answers}, "
          f"fences {len(fences)}")
    say("11c supervised", f"{wl} gibbs C={C_FULL} S={S_FULL}, {SUP_OUTER} "
        f"outer steps x {SUP_CHUNK}, plan {SUP_PLAN}: the last published "
        f"snapshot (step {SUP_OUTER}: x, cache, accepts, marg, generator) "
        f"and all {len(queries)} answers "
        f"bit-equal to the clean run's; {len(fences)} epoch fences; fault "
        f"to the next published snapshot "
        f"{[round(t / 1e6, 4) for t in to_publish]} s; rungs "
        f"{fault['res']['source_counts']}; {fault['wall']:.2f} s (clean "
        f"{clean['wall']:.2f} s); on {smi}")
    launches = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(equal=same, answers_equal=same_answers, fences=len(fences),
                fault_to_publish_s=[t / 1e6 for t in to_publish],
                sources=fault["res"]["source_counts"],
                seconds=fault["wall"], clean_seconds=clean["wall"],
                launches=launches)


def pool_driver(g, smi):
    """11d: POOL_DRIVER_BATCHES batches of the demo traffic with the
    background driver stopped, then running: answer latency and the
    driver's sweeps."""
    from repro_torch.launch.serve import _demo_queries
    wl = POOL_PAIRS
    pool, w = pool_make(g, "gibbs", wl, C_FULL, S_FULL)
    queries = _demo_queries(wl, g, POOL_DRIVER_DEMO, 0)
    pool.submit(queries, max_extra_sweeps=POOL_BUDGET)     # fork the lane

    def batches():
        lat = []
        for _ in range(POOL_DRIVER_BATCHES):
            t0 = time.perf_counter()
            answers = pool.submit(queries, max_extra_sweeps=0,
                                  serve_stale=True)
            lat.append(time.perf_counter() - t0)
            check(all(a.status == "ok" for a in answers),
                  f"11d: {[a.report for a in answers]}")
        return lat

    def sweeps():
        return sum(lane.sweeps for _, lane in pool_lanes(w))

    torch.cuda.synchronize()
    stopped = batches()
    before = sweeps()
    pool.start()
    t0 = time.perf_counter()
    try:
        running = batches()
    finally:
        pool.stop()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    made = sweeps() - before
    check(made > 0 and pool.driver is None,
          f"11d: the driver made {made} sweeps")
    q = lambda v, p: 1e3 * float(np.percentile(v, p))
    rec = dict(stopped_ms=dict(p50=q(stopped, 50), p90=q(stopped, 90)),
               running_ms=dict(p50=q(running, 50), p90=q(running, 90)),
               driver_sweeps=made, driver_sweeps_per_s=made / wall,
               lanes=len(pool_lanes(w)), seconds=wall)
    say("11d driver", f"{wl} gibbs C={C_FULL} S={S_FULL}, {len(queries)} "
        f"queries per batch over {rec['lanes']} lanes, "
        f"{POOL_DRIVER_BATCHES} batches each: latency p50/p90 driver "
        f"stopped {rec['stopped_ms']['p50']:.2f}/"
        f"{rec['stopped_ms']['p90']:.2f} ms, running "
        f"{rec['running_ms']['p50']:.2f}/{rec['running_ms']['p90']:.2f} ms;"
        f" the driver made {made} sweeps ({made / wall:.0f}/s) in "
        f"{wall:.2f} s; on {smi}")
    return rec


def pool_launcher(smi, tmp, device="cuda"):
    """11e: the launcher as subprocesses: plain, and supervised under
    phase 10's plan (its restart restores a checkpoint)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
            POOL_PAIRS, "--engine", "gibbs", "--chains", str(C_FULL),
            "--sweep", str(S_FULL), "--chunk", str(POOL_CHUNK), "--demo",
            str(POOL_DEMO), "--max-extra-sweeps", str(POOL_BUDGET),
            "--device", device]
    cmds = {"plain": base + ["--out", f"{tmp}/serve.json"],
            "supervised": base + [
                "--out", f"{tmp}/serve-sup.json", "--supervise",
                "--ckpt-dir", f"{tmp}/serve-ck", "--outer-steps",
                str(SUP_OUTER), "--fault-plan",
                json.dumps({"faults": SUP_PLAN})]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env,
                                 cwd=str(ROOT)) for k, c in cmds.items()}
    outs = {}
    for k, p in procs.items():
        try:
            o, e = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            fail("11e: the serve launcher passed 300 s")
        check(p.returncode == 0, f"11e {k}: exit {p.returncode}: "
              f"{e[-2000:]}")
        outs[k] = o
    wall = time.perf_counter() - t0
    rec = {}
    for k, path in (("plain", "serve.json"), ("supervised",
                                              "serve-sup.json")):
        res = json.loads(Path(f"{tmp}/{path}").read_text())
        deltas = all(a["marginals"][s][v] == 1.0 for a in res["answers"]
                     for s, v in a["evidence"])
        check(res["compiled_traces"] == 1 and deltas
              and res["n_queries"] == POOL_DEMO,
              f"11e {k}: traces {res['compiled_traces']}, deltas {deltas}")
        rec[k] = dict(compiled_traces=res["compiled_traces"],
                      status_counts=res["status_counts"],
                      source_counts=res["source_counts"],
                      queries_per_s=res["queries_per_sec"])
    resumed = [ln for ln in outs["supervised"].splitlines()
               if ln.startswith("[supervisor] restore:")
               and '"source": "step_' in ln]
    check(resumed, f"11e: no restore from a checkpoint in "
          f"{outs['supervised'][-1500:]}")
    summary = [ln for ln in outs["plain"].splitlines()
               if ln.startswith("[serve]")][0]
    say("11e launcher", f"{' '.join(base[1:])}: exit 0, '{summary}'; with "
        f"--supervise --fault-plan: resumed, '{resumed[0]}'; compiled_traces "
        f"{rec['plain']['compiled_traces']} and "
        f"{rec['supervised']['compiled_traces']}, observed sites delta; "
        f"{wall:.1f} s for both processes; on {smi}")
    rec.update(resumed=resumed, seconds=wall)
    return rec


def pool_profiled(pool, w, smi):
    """11f: the kernels one chunk launches, by name from ``torch.profiler``,
    the same for the resident and a clamped lane (last: a capture slows
    the host for the rest of the process).  Each lane's chunk is the
    active step after a warm-up step: CUPTI has dropped records of a
    window's first launches (every count one or two short), so the names
    are held equal here and the counts are read from the wrappers (11a)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    names = {}

    def keep(prof, sig):
        names[sig] = {e.key: e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("repro.")}

    for sig, lane in pool_lanes(w)[:2]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p, s=json.dumps(sig): keep(p, s)
                     ) as prof:
            for _ in range(2):
                pool._advance_lane(w, lane, 1)
                torch.cuda.synchronize()
                prof.step()
    check(len(names) == 2, f"11f: profiled {list(names)}")
    (_, a), (c, b) = names.items()
    kernels = {k: v for k, v in a.items()
               if "mgpmh_sweep_kernel" in k or "telemetry_update_kernel" in k}
    check(set(a) == set(b) and len(kernels) == 2,
          f"11f: resident {sorted(a)} vs clamped {sorted(b)}")
    say("11f profile", f"mgpmh potts-64x64: one chunk of the resident and "
        f"of the lane clamped at {c}: the same {len(a)} device op names "
        f"(counts equal: {a == b}); the two kernels seen "
        f"{list(kernels.values())} times; on {smi}")
    return dict(ops=a, clamped_ops=b, kernels=kernels, counts_equal=a == b)


def phase_serving(potts, smi):
    """11: serving on the card."""
    import tempfile
    from repro_torch.core import engine
    t0 = time.perf_counter()

    def libs():
        return sorted((p.name, p.stat().st_mtime_ns) for p in
                      (ROOT / "build" / "repro_torch").glob(
                          "libkernels-*.so"))
    before = libs()
    rec = {"full_width": pool_full_width(potts, smi)}
    pool, w = rec["full_width"].pop("profiled")
    torch.cuda.empty_cache()
    pairs = engine.make_workload(POOL_PAIRS, device=potts.device).graph
    rec["pairs"] = pool_pairs(pairs, smi)
    with tempfile.TemporaryDirectory() as tmp:
        rec["supervised"] = pool_supervised(pairs, smi, tmp)
        rec["driver"] = pool_driver(pairs, smi)
        rec["launcher"] = pool_launcher(smi, tmp)
    rec["profile"] = pool_profiled(pool, w, smi)
    del pool, w
    check(libs() == before, f"11: the kernel library was rebuilt: "
          f"{before} -> {libs()}")
    launches = {}
    for part in (rec["full_width"], rec["pairs"], rec["supervised"]):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = smi
    say("11 serving", f"{rec['seconds']:.1f} s, launches {launches}; the "
        f"kernel library not rebuilt; on {smi}")
    return rec


# ---------------------------------------------------------------------------
# phase 12: training on the card
# ---------------------------------------------------------------------------

def bwd_ptxas(log, lib):
    """{kernel: "registers, spills, shared memory"} of the backward's seven
    entry functions (prep; dK/dV and dQ on wgmma, ``*_wg``, at padded head
    dims 64, 128 and 256), from the -Xptxas -v
    log, each block's dynamic shared memory from the library
    (``flash_attention_bwd_smem``)."""
    lines, out = log.splitlines(), {}
    for n, ln in enumerate(lines):
        if "entry function" not in ln or "flash_bwd_" not in ln:
            continue
        name = ln.split("flash_bwd_")[1].split("_kernel")[0]
        smem = 0
        if "_kernelILi" in ln:
            hdp = int(ln.split("_kernelILi")[1].split("E")[0])
            smem = lib.flash_attention_bwd_smem(
                hdp, 0 if name.startswith("dkdv") else 1)
            name = f"{name}<{hdp}>"
        out[name] = "; ".join(
            [x.strip().replace("ptxas info    : ", "")
             for x in lines[n + 1:n + 4] if "spill" in x or "registers" in x]
            + [f"dynamic shared memory {smem} bytes"])
    return out


def bwd_bound(B, Sq, Sk, H, KVH, hd, w, causal):
    """(ms, term, {term: ms}): the larger of the backward's tensor-core
    FLOPs (2.5 times the forward's two products: 10 hd per attended pair,
    the causal mask halving the pairs) at the bf16 dense peak, and its
    bytes (q, k, v, o, dO read once, dq, dk, dv written once, bf16) at the
    HBM rate."""
    pairs = B * H * attended_pairs(Sq, Sk, w, causal)
    terms = {"operations": 10 * hd * pairs / BF16_TC_FLOPS_PER_S,
             "bytes": 2 * (4 * B * Sq * H * hd + 4 * B * Sk * KVH * hd)
             / HBM_BYTES_PER_S}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], term, {k: 1e3 * v for k, v in terms.items()}


def rel_err(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def bwd_parity(dev):
    """12a: the backward kernel against its plain version at BWD_SHAPES, on
    the forward kernel's row statistics (lse2): each gradient within
    BWD_REL_TOL (relative Frobenius), finite, and the same bits on a second
    launch; the forward's output the same bits with and without lse2."""
    from repro_torch.kernels import flash_attention as fa, ref
    errs, rels = {}, {}
    for n, (B, Sq, Sk, H, KVH, hd, w, causal) in enumerate(BWD_SHAPES):
        q, k, v = flash_inputs(B, Sq, Sk, H, KVH, hd, torch.bfloat16, dev,
                               seed=200 + n)
        dout = flash_inputs(B, Sq, Sq, H, H, hd, torch.bfloat16, dev,
                            seed=300 + n)[0]
        shape = (B, Sq, Sk, H, KVH, hd, w, causal)
        out = fa.flash_attention_cuda(q, k, v, window=w, causal=causal)
        out2, lse2 = fa.flash_attention_cuda(q, k, v, window=w,
                                             causal=causal, lse=True)
        check(torch.equal(out, out2), f"flash forward at {shape}: lse=True "
              f"changed the output")
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, window=w,
                                           causal=causal)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse2,
                                          window=w, causal=causal)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse2,
                                            window=w, causal=causal)
        torch.cuda.synchronize()
        for name, g, a, p in zip(("dq", "dk", "dv"), got, again, want):
            key = f"{shape} {name}"
            check(torch.equal(g, a), f"flash backward {key}: two launches "
                  f"gave different bits")
            check(bool(torch.isfinite(g).all()),
                  f"flash backward {key}: not finite")
            rels[key] = r = rel_err(g, p)
            errs[key] = float((g.float() - p.float()).abs().max())
            check(r < BWD_REL_TOL, f"flash backward {key} off the plain "
                  f"version: relative error {r:.3g} (< {BWD_REL_TOL})")
        del q, k, v, dout, out, out2, lse2, want, got, again
    torch.cuda.empty_cache()
    say("12a backward parity", f"{len(BWD_SHAPES)} shapes (B, Sq, Sk, H, "
        f"KVH, hd, window, causal) {BWD_SHAPES}: dq, dk, dv within "
        f"{BWD_REL_TOL} relative (Frobenius) of the plain float32 backward "
        f"(max {max(rels.values()):.3g}; max abs err "
        f"{max(errs.values()):.3g}), "
        f"finite, the same bits on a second launch; the forward's output "
        f"the same bits with lse=True")
    return dict(max_abs_err=max(errs.values()), max_rel_err=max(rels.values()),
                rel_errors=rels)


def bwd_kernel_ms(dev_ev, calls):
    """{kernel: device ms per call} of the backward's kernels in
    ``device_events`` output over ``calls`` calls (prep; dkdv and dq, with
    ``_wg`` for the wgmma kernels)."""
    out = {}
    for e in dev_ev:
        if "flash_bwd_" in e.key:
            name = e.key.split("flash_bwd_")[1].split("_kernel")[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 \
                / calls
    return out


def bwd_times(dev):
    """12a at the model shapes of BWD_SHAPES (tinyllama-1.1b's training
    attention, h2o-danube-3-4b's window, gemma3-12b's local and global
    layers): the wrapper's three launches per call (CUDA events over a
    stream of calls), each kernel's device time (torch.profiler), the
    bound, the plain version and scaled_dot_product_attention's backward
    (fwd + bwd minus fwd; a boolean band mask where a window is set, as
    phase 6 gives the forward, else its fused causal path; timed, never
    called by the port); at tinyllama's shape also the forward with and
    without lse2.  The record is tinyllama's, every shape's under
    "shapes"."""
    from repro_torch.kernels import flash_attention as fa, ref
    shapes = {}
    for n, (B, Sq, Sk, H, KVH, hd, w, causal) in enumerate(
            BWD_SHAPES[:BWD_MODEL_SHAPES]):
        q, k, v = flash_inputs(B, Sq, Sk, H, KVH, hd, torch.bfloat16, dev,
                               60 + 2 * n)
        dout = flash_inputs(B, Sq, Sq, H, H, hd, torch.bfloat16, dev,
                            61 + 2 * n)[0]
        out, lse2 = fa.flash_attention_cuda(q, k, v, window=w, causal=causal,
                                            lse=True)
        bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse2,
                                                  window=w, causal=causal)
        ms = per_launch_ms(bwd, 5, reps=5)
        dev_ev, _ = device_events(lambda: [bwd() for _ in range(3)])
        parts = bwd_kernel_ms(dev_ev, 3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dt = dout.transpose(1, 2)
        mask = None
        if w > 0:                # the band as a boolean mask (True: attended)
            i = torch.arange(Sq, device=dev)[:, None]
            j = torch.arange(Sk, device=dev)[None, :]
            mask = i - j < w
            if causal:
                mask &= i >= j
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        fwd_ms = per_launch_ms(sdpa, 5)
        both_ms = per_launch_ms(
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt), 5)
        bound_ms, term, terms = bwd_bound(B, Sq, Sk, H, KVH, hd, w, causal)
        flops = 10 * hd * B * H * attended_pairs(Sq, Sk, w, causal)
        rec = dict(ms=ms, kernel_device_ms=parts,
                   library_ms=both_ms - fwd_ms, library_fwd_bwd_ms=both_ms,
                   library_fwd_ms=fwd_ms, bound_ms=bound_ms, bound_by=term,
                   bound_terms_ms=terms, flops=flops,
                   tflops_per_s=flops / ms / 1e9,
                   shape=f"B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} hd={hd} "
                         f"window={w} {'causal' if causal else 'bidirectional'}"
                         f" bf16 (dq, dk, dv)")
        rec["plain_ms"] = median_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, dout, window=w, causal=causal), 1, warmup=1)
        if n == 0:
            rec["forward_ms"] = per_launch_ms(lambda: fa.flash_attention_cuda(
                q, k, v, window=w, causal=causal), 10)
            rec["forward_lse_ms"] = per_launch_ms(
                lambda: fa.flash_attention_cuda(q, k, v, window=w,
                                                causal=causal, lse=True), 10)
        shapes[rec["shape"]] = rec
        say("12a backward times", f"[{rec['shape']}] kernel {ms:.4f} ms per "
            f"call of three launches ({rec['tflops_per_s']:.1f} TFLOP/s of "
            f"the bound's FLOPs); device: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f" ms; scaled_dot_product_attention backward "
            f"{rec['library_ms']:.4f} ms (fwd+bwd {both_ms:.4f} - fwd "
            f"{fwd_ms:.4f}{', band mask' if mask is not None else ''}); "
            f"bound {bound_ms:.4f} ms set by {term} ("
            + ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) + " ms)"
            + f"; plain {rec['plain_ms']:.2f} ms"
            + (f"; the forward {rec['forward_ms']:.4f} ms, with lse2 "
               f"{rec['forward_lse_ms']:.4f} ms" if n == 0 else ""))
        del q, k, v, dout, out, lse2, qt, kt, vt, dt, mask
        torch.cuda.empty_cache()
    first = next(iter(shapes.values()))
    return dict(first, shapes=shapes)


def train_step_times(cfg, dev, B=TRAIN_B, S=TRAIN_S):
    """12b, 12e: make_train_step at full width on fresh weights: one
    warm-up step, TRAIN_TIMED steps timed with CUDA events (each to a
    synchronize), the peak memory over them, and one more step under
    torch.profiler (device busy, idle share, top ops, the backward
    kernels' share); ``steps_run``, the steps run (TRAIN_TIMED + 2), and
    the grad norms of all of them."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    model = T.init_params(cfg, TRAIN_SEED, device=dev, master=True)
    opt = adamw_init(model)
    step = steps.make_train_step(cfg, base_lr=3e-4, total_steps=100,
                                 loss_chunk=min(2048, S))
    data = SyntheticTokens(cfg.vocab_size, S, B, seed=TRAIN_SEED)
    state = {"model": model, "opt": opt, "i": 0}
    grad_norms = []

    def one():
        state["model"], state["opt"], m = step(
            state["model"], state["opt"], data.batch(state["i"]))
        state["i"] += 1
        grad_norms.append(m["grad_norm"])
        return m
    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = one()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    def traced():
        t1 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        return time.perf_counter() - t1
    ev, wall_s = device_events(traced, cpu=True)
    name = lambda key: key.replace("(anonymous namespace)::", "").split(
        "(")[0].split("<")[0].split(" ")[-1]
    ops = {}
    for e in ev:
        if e.self_device_time_total > 0 and not e.key.startswith("repro."):
            ops[name(e.key)] = ops.get(name(e.key), 0.0) \
                + e.self_device_time_total / 1e3
    busy = sum(ops.values())
    bwd_ms = sum(t for k, t in ops.items() if k.startswith("flash_bwd_"))
    fwd_ms = sum(t for k, t in ops.items() if k.startswith("flash_bf16"))
    scan_bwd_ms = sum(t for k, t in ops.items()
                      if k.startswith("selective_scan_bwd"))
    scan_fwd_ms = ops.get("selective_scan_kernel", 0.0)
    n_steps = state["i"]
    del state, model, opt
    torch.cuda.empty_cache()
    step_ms = statistics.median(times)
    tokens_s = B * S / step_ms * 1e3
    mfu = (T.model_flops_per_token(cfg, S, "train") * tokens_s
           / BF16_TC_FLOPS_PER_S)
    top = dict(sorted(ops.items(), key=lambda o: -o[1])[:6])
    return dict(steps_run=n_steps, grad_norms=[float(g) for g in grad_norms],
                step_ms=step_ms, step_ms_all=times, losses=losses,
                tokens_per_s=tokens_s, model_flops_share=mfu,
                peak_memory_gb=peak, busy_ms=busy,
                traced_wall_ms=1e3 * wall_s, idle=1 - busy / (1e3 * wall_s),
                top_device_ops_ms=top,
                flash_bwd_device_ms=bwd_ms, flash_fwd_device_ms=fwd_ms,
                flash_bwd_share=bwd_ms / busy,
                scan_bwd_device_ms=scan_bwd_ms, scan_fwd_device_ms=scan_fwd_ms,
                scan_bwd_share=scan_bwd_ms / busy)


def train_full_width(dev, smi):
    """12b: launch.train.train on tinyllama-1.1b at full width (weights
    from a seed) for TRAIN_STEPS steps into a temporary ckpt_dir, every
    launch count reset before and read after: the backward kernel once per
    layer and step, the forward kernel twice (the forward and its
    rematerialisation), no other kernel, and the plain backward never
    called; losses and grad norms finite; then the step's figures."""
    import tempfile
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    cfg = get_arch(TRAIN_ARCH)
    plain_calls = []
    real_plain = ops.flash_attention_bwd_ref

    def counted_plain(*a, **kw):
        plain_calls.append(1)
        return real_plain(*a, **kw)
    ops.flash_attention_bwd_ref = counted_plain
    try:
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches()
            wall, (loss, hist) = _sync_ms(lambda: train_lib.train(
                cfg, steps=TRAIN_STEPS, global_batch=TRAIN_B, seq=TRAIN_S,
                ckpt_dir=os.path.join(tmp, "ck"), ckpt_every=10_000,
                lr=3e-4, seed=TRAIN_SEED, log_every=1, device=dev))
            launches = read_launches()
            saved = train_lib.ckpt.latest_step(os.path.join(tmp, "ck"))
        torch.cuda.empty_cache()
        L = cfg.num_layers
        check(launches["flash_attention_bwd"] == L * TRAIN_STEPS,
              f"12b: {launches['flash_attention_bwd']} backward launches in "
              f"{TRAIN_STEPS} steps, expected {L} per step")
        check(launches["flash_attention"] == 2 * L * TRAIN_STEPS,
              f"12b: {launches['flash_attention']} forward launches, "
              f"expected {2 * L} per step (forward + rematerialisation)")
        check(all(n == 0 for k, n in launches.items()
                  if not k.startswith("flash_attention")),
              f"12b: training launched other kernels: {launches}")
        check(not plain_calls, f"12b: the plain backward was called "
              f"{len(plain_calls)} times")
        check(len(hist) == TRAIN_STEPS and saved == TRAIN_STEPS
              and all(math.isfinite(h["loss"]) and math.isfinite(
                  h["grad_norm"]) for h in hist),
              f"12b: history {hist}, checkpoint at step {saved}")
        step = train_step_times(cfg, dev)
    finally:
        ops.flash_attention_bwd_ref = real_plain
    check(all(math.isfinite(x) for x in step["losses"]),
          f"12b: timed steps' losses {step['losses']}")
    rec = dict(arch=TRAIN_ARCH, B=TRAIN_B, S=TRAIN_S, steps=TRAIN_STEPS,
               train_wall_ms=wall, history=hist, launches=launches,
               plain_backward_calls=len(plain_calls), card=smi, **step)
    say("12b training", f"{TRAIN_ARCH} full width (weights from seed "
        f"{TRAIN_SEED}), B={TRAIN_B} S={TRAIN_S}, on {smi}: train() "
        f"{TRAIN_STEPS} steps + the final checkpoint {wall / 1e3:.1f} s, "
        f"losses {[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}; launches {launches}, "
        f"plain backward calls 0")
    say("12b training", f"step {step['step_ms']:.1f} ms (median of "
        f"{[round(t, 1) for t in step['step_ms_all']]}), "
        f"{step['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
        f"{step['model_flops_share']:.4f} of {BF16_TC_FLOPS_PER_S / 1e12:.0f}"
        f" TFLOP/s, peak memory {step['peak_memory_gb']:.2f} GB; traced "
        f"step: device busy {step['busy_ms']:.1f} ms, flash backward "
        f"{step['flash_bwd_device_ms']:.1f} ms ({step['flash_bwd_share']:.3f}"
        f" of busy), flash forward {step['flash_fwd_device_ms']:.1f} ms, "
        f"wall {step['traced_wall_ms']:.1f} ms (idle {step['idle']:.3f}); top "
        "device ops " + ", ".join(f"{k} {v:.1f}" for k, v in
                                  step["top_device_ops_ms"].items()))
    return rec


def train_resume(dev):
    """12c: crash-resume on the card: RESUME_CFG trained RESUME_STEPS steps
    uninterrupted, and again killed by fail_at_step and resumed from its
    checkpoint, end with the same loss, parameters and AdamW state, bit for
    bit."""
    import tempfile
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch import train as train_lib
    from repro_torch.models import transformer as T
    cfg = ModelConfig(**RESUME_CFG)
    kw = dict(steps=RESUME_STEPS, global_batch=4, seq=512,
              ckpt_every=RESUME_EVERY, lr=1e-3, log_every=1, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t0 = time.perf_counter()
        loss_a, hist_a = train_lib.train(cfg, ckpt_dir=a, **kw)
        try:
            train_lib.train(cfg, ckpt_dir=b, fail_at_step=RESUME_FAIL,
                            **kw)
            fail("12c: fail_at_step did not raise")
        except RuntimeError as e:
            check("injected failure" in str(e), f"12c: {e}")
        loss_b, hist_b = train_lib.train(cfg, ckpt_dir=b, **kw)
        states = []
        for d in (a, b):
            model = T.init_params(cfg, 0, device=dev, master=True)
            opt = train_lib._restore(d, RESUME_STEPS, model)
            states.append((dict(model.named_parameters()), opt))
        seconds = time.perf_counter() - t0
    (pa, oa), (pb, ob) = states
    same = (loss_a == loss_b and oa.step == ob.step == RESUME_STEPS
            and all(torch.equal(pa[k], pb[k]) and torch.equal(oa.m[k], ob.m[k])
                    and torch.equal(oa.v[k], ob.v[k]) for k in pa)
            and [h["loss"] for h in hist_a[RESUME_EVERY:]]
            == [h["loss"] for h in hist_b])
    check(same, f"12c: the resumed run differs from the uninterrupted one "
          f"(losses {loss_a} / {loss_b})")
    del states, pa, pb, oa, ob
    torch.cuda.empty_cache()
    say("12c crash-resume", f"{cfg.name} cut to "
        f"{cfg.num_layers} layers, B=4 S=512, {RESUME_STEPS} steps, "
        f"killed at step {RESUME_FAIL}, resumed from step {RESUME_EVERY}: "
        f"loss {loss_b:.6f}, parameters and AdamW state bit-equal to the "
        f"uninterrupted run ({seconds:.1f} s)")
    return dict(loss=loss_a, bit_equal=True, seconds=seconds)


def run_examples():
    """12d: the port's examples as subprocesses on the card, all started
    together: each exits 0 (its last line kept)."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for args in EXAMPLE_RUNS:
            args = [a.replace("{tmp}", tmp) for a in args]
            procs[args[0]] = subprocess.Popen(
                [sys.executable, *args], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        for name, p in procs.items():
            try:
                text = p.communicate(timeout=EXAMPLE_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                for q in procs.values():
                    q.kill()
                fail(f"12d: {name} overran {EXAMPLE_TIMEOUT_S} s")
            check(p.returncode == 0, f"12d: {name} exited {p.returncode}:\n"
                  f"{text[-3000:]}")
            out[name] = text.strip().splitlines()[-1]
        seconds = time.perf_counter() - t0
    for name, last in out.items():
        say("12d examples", f"{name}: exit 0; {last}")
    return dict(last_lines=out, seconds=seconds)


def train_gemma3(dev, smi):
    """12e: make_train_step on gemma3-12b at full width, cut to
    GEMMA_LAYERS layers (one period of its window pattern), weights from a
    seed, B=GEMMA_B S=GEMMA_S: every launch count reset before and read
    after the steps -- per step the backward kernel once per layer (hd 256)
    and the forward twice (its rematerialisation), no other kernel, the
    plain backward never called; losses and grad norms finite; the step's
    figures as 12b's."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    full = get_arch(GEMMA_ARCH)
    cfg = dataclasses.replace(full, num_layers=GEMMA_LAYERS)
    L = cfg.num_layers
    windows = [cfg.window_pattern[i % cfg.period] for i in range(L)]
    plain_calls = []
    real_plain = ops.flash_attention_bwd_ref

    def counted_plain(*a, **kw):
        plain_calls.append(1)
        return real_plain(*a, **kw)
    ops.flash_attention_bwd_ref = counted_plain
    try:
        reset_launches()
        step = train_step_times(cfg, dev, GEMMA_B, GEMMA_S)
        launches = read_launches()
    finally:
        ops.flash_attention_bwd_ref = real_plain
    torch.cuda.empty_cache()
    n = step["steps_run"]
    check(launches["flash_attention_bwd"] == L * n,
          f"12e: {launches['flash_attention_bwd']} backward launches in {n} "
          f"steps, expected {L} per step")
    check(launches["flash_attention"] == 2 * L * n,
          f"12e: {launches['flash_attention']} forward launches in {n} "
          f"steps, expected {2 * L} per step (forward + rematerialisation)")
    check(all(c == 0 for k, c in launches.items()
              if not k.startswith("flash_attention")),
          f"12e: training launched other kernels: {launches}")
    check(not plain_calls, f"12e: the plain backward was called "
          f"{len(plain_calls)} times")
    check(all(math.isfinite(x) for x in step["losses"] + step["grad_norms"]),
          f"12e: losses {step['losses']}, grad norms {step['grad_norms']}")
    cut = (f"depth cut from {full.num_layers} to {L} layers (windows "
           f"{windows}; the full depth's float32 training state, "
           f"{16 * T.param_count(full) / 1e9:.0f} GB, does not fit one card)")
    rec = dict(arch=GEMMA_ARCH, layers=L, B=GEMMA_B, S=GEMMA_S,
               params=T.param_count(cfg), cut=cut, launches=launches,
               plain_backward_calls=len(plain_calls), card=smi, **step)
    say("12e gemma3 training", f"{GEMMA_ARCH} full width (d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied), {cut}; "
        f"{rec['params'] / 1e9:.3f}B parameters, weights from seed "
        f"{TRAIN_SEED}, B={GEMMA_B} S={GEMMA_S}, on {smi}: {n} steps, "
        f"launches {launches}, plain backward calls 0, losses "
        f"{[round(x, 4) for x in step['losses']]}, grad norms "
        f"{[round(x, 4) for x in step['grad_norms']]}")
    say("12e gemma3 training", f"step {step['step_ms']:.1f} ms (median of "
        f"{[round(t, 1) for t in step['step_ms_all']]}), "
        f"{step['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
        f"{step['model_flops_share']:.4f} of {BF16_TC_FLOPS_PER_S / 1e12:.0f}"
        f" TFLOP/s, peak memory {step['peak_memory_gb']:.2f} GB; traced "
        f"step: device busy {step['busy_ms']:.1f} ms, wall "
        f"{step['traced_wall_ms']:.1f} ms (idle {step['idle']:.3f}), the "
        f"hd-256 backward {step['flash_bwd_device_ms']:.2f} ms "
        f"({step['flash_bwd_share']:.4f} of busy), the forward "
        f"{step['flash_fwd_device_ms']:.2f} ms; top device ops "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    step["top_device_ops_ms"].items()))
    return rec


def scan_bwd_bound(bsz, S, di, N):
    """(least ms, "bytes" or "operations", the terms) of the scan's
    backward: dt, x read as float32, z and dy as bf16, ddt, dx written as
    float32 and dz as bf16 (22 bytes per (b, t, d)), B, C read and dB, dC
    written (float32), A, D read and dA, dD written, over the memory rate;
    N + 1 exponentials per (b, t, d) (the decays, silu's sigma) over the
    MUFU rate; 23 N + 10 float32 operations per (b, t, d) (per state: the
    state's 3, C h 2, dh 3, ddt's term 5, dx's 2, dB's 2, dC's 2, dA's 3,
    dt A 1) over the FP32 rate."""
    elems = bsz * S * di
    terms = {"bytes": (22 * elems + 16 * bsz * S * N + 8 * di * (N + 1))
             / HBM_BYTES_PER_S,
             "exponentials": (N + 1) * elems / EX2_PER_S,
             "fp32": (23 * N + 10) * elems / FP32_OPS_PER_S}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            {k: 1e3 * v for k, v in terms.items()})


SCAN_GRADS = ("ddt", "dx", "dz", "dB", "dC", "dA", "dD")


def scan_device_ms(events):
    """{kernel: device ms per call} of the scan's kernels among a profiled
    window's device events: "forward" (one launch a call), "scan_bwd" (one)
    and "reduce" (the backward's two ordered sums), each the mean of the
    launches the profiler recorded times the launches a call (CUPTI drops
    a record now and then: a window's total divided by the calls made
    would count it as zero)."""
    per_call = {"forward": 1, "scan_bwd": 1, "reduce": 2}
    parts = {}
    for e in events:
        if "selective_scan" in e.key and e.count:
            kn = ("reduce" if "reduce" in e.key else "scan_bwd"
                  if "bwd" in e.key else "forward")
            parts[kn] = (parts.get(kn, 0.0) + e.self_device_time_total
                         / e.count / 1e3 * per_call[kn])
    return parts


def scan_bwd_parity(dev):
    """12f: the scan's backward kernel against its plain version at
    SCAN_BWD_SHAPES (dy a bf16 N(0, 1) from a seed), from the checkpoints
    the forward kernel writes: the forward with checkpoints gives the
    serve path's y bit for bit, its checkpoints are within
    SCAN_CKPT_REL_TOL of the plain forward's states and the same bits for
    the first 64 channels of the first batch row taken alone (another
    lane layout); each gradient within SCAN_BWD_REL_TOL (relative
    Frobenius) of the plain backward, finite, in its input's dtype and
    shape, the same bits on a second launch, the layout the library takes
    equal to ``scan_bwd_layout``'s.  At the SCAN_TIMED shapes: the
    backward's time per call (a stream of 5; three launches a call), its
    kernels' device time (torch.profiler), the forward with and without
    checkpoints (in turns), the pair of the forward with checkpoints and
    the backward (the training path's calls of one layer), the plain
    version's time and the bound.  Returns (parity record, {layer:
    times})."""
    from repro_torch.kernels import ref, selective_scan as ss
    errs, rels, ck_rels, times = {}, {}, {}, {}
    for k, shape in enumerate(SCAN_BWD_SHAPES):
        bsz, S, di, N = shape
        ins = scan_inputs(*shape, dev, seed=500 + k)
        gen = torch.Generator(device=dev).manual_seed(600 + k)
        dy = torch.randn((bsz, S, di), generator=gen, device=dev).to(
            torch.bfloat16)
        y, ck = ss.selective_scan_cuda(*ins, checkpoints=True)
        d64 = min(di, 64)
        sub = [t[:1, :, :d64].contiguous() for t in ins[:2]] + [
            ins[2][:1, :, :d64], ins[3][:1], ins[4][:1], ins[5][:d64],
            ins[6][:d64]]
        ck_sub = ss.selective_scan_cuda(*sub, checkpoints=True)[1]
        want_ck = ref.selective_scan_ref(*ins, checkpoints=True)[1]
        torch.cuda.synchronize()
        check(torch.equal(y, ss.selective_scan_cuda(*ins)),
              f"selective_scan at {shape}: y with checkpoints differs from "
              f"y without")
        check(torch.equal(ck_sub, ck[:1, :, :d64]),
              f"selective_scan at {shape}: the checkpoints of 64 channels "
              f"taken alone (layout {ss.scan_layout(1, S, d64, N)['lanes']} "
              f"lanes) differ from the whole call's "
              f"({ss.scan_layout(*shape)['lanes']} lanes)")
        ck_rels[str(shape)] = r = rel_err(ck, want_ck) if ck.numel() else 0.0
        check(r < SCAN_CKPT_REL_TOL, f"selective_scan at {shape}: "
              f"checkpoints off the plain states, relative error {r:.3g} "
              f"(< {SCAN_CKPT_REL_TOL})")
        del sub, ck_sub, want_ck
        got = ss.selective_scan_bwd_cuda(*ins, dy, ck)
        again = ss.selective_scan_bwd_cuda(*ins, dy, ck)
        want = ref.selective_scan_bwd_ref(*ins, dy)
        torch.cuda.synchronize()
        for name, g, a, p, x in zip(SCAN_GRADS, got, again, want,
                                    (*ins[:5], ins[5], ins[6])):
            key = f"{shape} {name}"
            check(torch.equal(g, a), f"selective_scan_bwd {key}: two "
                  f"launches gave different bits")
            check(g.dtype == x.dtype and g.shape == x.shape,
                  f"selective_scan_bwd {key}: {g.dtype} {tuple(g.shape)}, "
                  f"its input {x.dtype} {tuple(x.shape)}")
            check(bool(torch.isfinite(g).all()),
                  f"selective_scan_bwd {key}: not finite")
            rels[key] = r = rel_err(g, p)
            errs[key] = float((g.float() - p.float()).abs().max())
            tol = SCAN_BWD_REL_TOL["dz" if name == "dz" else "float32"]
            check(r < tol, f"selective_scan_bwd {key} off the plain version: "
                  f"relative error {r:.3g} (< {tol})")
        layout = ss.scan_bwd_layout(*shape)
        built = ss.kernel_bwd_layout(*shape)
        check(built == {key: layout[key] for key in built},
              f"selective_scan_bwd at {shape}: the library's layout "
              f"{built}, scan_bwd_layout's {layout}")
        name = next((a for a, sh in SCAN_TIMED.items() if sh == shape), None)
        if name is not None:
            call = lambda: ss.selective_scan_bwd_cuda(*ins, dy, ck)
            pair = lambda: ss.selective_scan_bwd_cuda(
                *ins, dy, ss.selective_scan_cuda(*ins, checkpoints=True)[1])
            ms = per_launch_ms(call, 5)
            pair_ms = per_launch_ms(pair, 5)
            fwd = {"plain": [], "checkpoints": []}
            for _ in range(3):           # the two forwards in turns
                fwd["plain"].append(per_launch_ms(
                    lambda: ss.selective_scan_cuda(*ins), 10, reps=3))
                fwd["checkpoints"].append(per_launch_ms(
                    lambda: ss.selective_scan_cuda(*ins, checkpoints=True),
                    10, reps=3))
            dev_ev, _ = device_events(lambda: [call() for _ in range(3)])
            parts = scan_device_ms(dev_ev)
            pms = per_launch_ms(lambda: ref.selective_scan_bwd_ref(
                *ins, dy), 1, reps=1)
            bms, by, terms = scan_bwd_bound(*shape)
            fwd_ms = {key: statistics.median(v) for key, v in fwd.items()}
            times[name] = dict(
                ms=ms, kernel_device_ms=parts, pair_ms=pair_ms,
                forward_ms=fwd_ms["plain"],
                forward_checkpoints_ms=fwd_ms["checkpoints"],
                forward_turns_ms=fwd, plain_ms=pms, bound_ms=bms,
                bound_by=by, bound_terms_ms=terms, library_ms=None,
                layout=layout,
                shape=f"bsz={bsz} S={S} d_inner={di} N={N} ({name} layer, "
                      f"backward)")
            say("12f scan backward", f"[{times[name]['shape']}; "
                f"{layout['states_per_lane']} states a lane, "
                f"{layout['lanes']} lanes a channel, "
                f"{layout['warps_per_scheduler']:.2f} warps a scheduler, "
                f"{layout['chunks']} chunks of {layout['tile']}, "
                f"{layout['smem']} bytes of shared memory a block]: kernel "
                f"{ms:.4f} ms per call of three launches (device: "
                + ", ".join(f"{n} {v:.4f}" for n, v in parts.items())
                + f" ms); the forward with checkpoints then the backward "
                f"{pair_ms:.4f} ms; the forward {fwd_ms['plain']:.4f} ms, "
                f"with checkpoints {fwd_ms['checkpoints']:.4f} ms; plain "
                f"{pms:.2f} ms, bound {bms:.4f} ms set by {by} ("
                + ", ".join(f"{n} {v:.4f}" for n, v in terms.items())
                + " ms)")
        del ins, dy, y, ck, got, again, want
        torch.cuda.empty_cache()
    worst = {g: max(r for key, r in rels.items() if key.endswith(" " + g))
             for g in SCAN_GRADS}
    say("12f scan backward", f"selective_scan_bwd at {len(SCAN_BWD_SHAPES)} "
        f"shapes (bsz, S, d_inner, N) {SCAN_BWD_SHAPES}, from the forward "
        f"kernel's checkpoints (y unchanged by them, within "
        f"{SCAN_CKPT_REL_TOL} of the plain states: worst "
        f"{max(ck_rels.values()):.3g}; the same bits under another lane "
        f"layout): every gradient within {SCAN_BWD_REL_TOL} relative "
        f"(Frobenius) of the plain float32 backward (worst per gradient: "
        + ", ".join(f"{g} {r:.3g}" for g, r in worst.items())
        + f"; max abs err {max(errs.values()):.3g}), finite, the same bits "
        f"on a second launch, the library's layout equal to "
        f"scan_bwd_layout's")
    return dict(max_abs_err=max(errs.values()), max_rel_err=max(rels.values()),
                worst_rel_by_gradient=worst, rel_errors=rels,
                checkpoint_rel_errors=ck_rels), times


def same_step_twice(cfg, dev, B, S):
    """(bit-equal, loss): make_train_step's first step taken twice, each
    from the state init_params(TRAIN_SEED) and adamw_init give, on the same
    batch: the parameters after the two steps compared bit for bit (the
    first run's parameters kept, the rest freed before the second)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    step = steps.make_train_step(cfg, base_lr=3e-4, total_steps=100,
                                 loss_chunk=min(2048, S))
    batch = SyntheticTokens(cfg.vocab_size, S, B, seed=TRAIN_SEED).batch(0)
    runs = []
    for _ in range(2):
        model = T.init_params(cfg, TRAIN_SEED, device=dev, master=True)
        model, opt, m = step(model, adamw_init(model), batch)
        runs.append(([p.detach() for p in model.parameters()],
                     float(m["loss"])))
        del model, opt, m
        torch.cuda.empty_cache()
    (pa, la), (pb, lb) = runs
    same = la == lb and all(torch.equal(a, b) for a, b in zip(pa, pb))
    del runs, pa, pb
    torch.cuda.empty_cache()
    return same, la


def train_ssm(dev, smi):
    """12f: make_train_step on each SSM_TRAIN config at full width (hymba
    whole, falcon-mamba cut in depth), weights from a seed: every launch
    count reset before and read after the steps -- per step the scan's
    forward twice per mamba layer (the forward and its rematerialisation)
    and its backward once, the flash forward twice and backward once per
    attention layer, nothing else; the plain scan, scan backward and flash
    backward never called; losses and grad norms finite; one step taken
    twice from the same state gives the same parameters, bit for bit; the
    step's figures as 12b's, with the scan's device time."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T
    recs = {}
    for arch, layers, B, S in SSM_TRAIN:
        full = get_arch(arch)
        cfg = (full if layers is None
               else dataclasses.replace(full, num_layers=layers))
        L = cfg.num_layers
        with plain_calls(("selective_scan_ref", "selective_scan_bwd_ref",
                          "flash_attention_bwd_ref")) as plain:
            reset_launches()
            step = train_step_times(cfg, dev, B, S)
            launches = read_launches()
            same, loss0 = same_step_twice(cfg, dev, B, S)
        torch.cuda.empty_cache()
        n = step["steps_run"]
        attn = int(cfg.has_attention)
        want = {"selective_scan": 2 * L * n, "selective_scan_bwd": L * n,
                "flash_attention": 2 * L * n * attn,
                "flash_attention_bwd": L * n * attn}
        check(all(c == want.get(k, 0) for k, c in launches.items()),
              f"12f {arch}: launches {launches} in {n} steps, expected "
              f"{want} and no other")
        check(not plain, f"12f {arch}: plain versions called: "
              f"{sorted(set(plain))} ({len(plain)} calls)")
        check(all(math.isfinite(x) for x in step["losses"]
                  + step["grad_norms"] + [loss0]),
              f"12f {arch}: losses {step['losses']}, grad norms "
              f"{step['grad_norms']}")
        check(same, f"12f {arch}: one step taken twice from the same state "
              f"gave different parameters")
        cut = ("full depth" if layers is None else
               f"depth cut from {full.num_layers} to {L} layers (the full "
               f"depth's float32 training state, "
               f"{16 * T.param_count(full) / 1e9:.0f} GB, does not fit one "
               f"card)")
        rec = recs[arch] = dict(
            arch=arch, layers=L, B=B, S=S, params=T.param_count(cfg),
            cut=cut, launches=launches, plain_calls=len(plain),
            same_bits_twice=same, card=smi, **step)
        say("12f ssm training", f"{arch} full width (d {cfg.d_model}, "
            f"d_inner {cfg.d_inner}, N {cfg.ssm_state}"
            + (f", {cfg.num_heads}/{cfg.num_kv_heads} heads hd "
               f"{cfg.head_dim} window {cfg.window_pattern[0]}, d_ff "
               f"{cfg.d_ff}" if attn else "")
            + f", vocab {cfg.vocab_size}), {cut}; {rec['params'] / 1e9:.3f}B "
            f"parameters, weights from seed {TRAIN_SEED}, B={B} S={S}, on "
            f"{smi}: {n} steps, launches {launches}, no plain version "
            f"called, losses {[round(x, 4) for x in step['losses']]}, grad "
            f"norms {[round(x, 4) for x in step['grad_norms']]}; one step "
            f"twice from the same state: the same parameters, bit for bit")
        say("12f ssm training", f"{arch} step {step['step_ms']:.1f} ms "
            f"(median of {[round(t, 1) for t in step['step_ms_all']]}), "
            f"{step['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
            f"{step['model_flops_share']:.4f} of "
            f"{BF16_TC_FLOPS_PER_S / 1e12:.0f} TFLOP/s, peak memory "
            f"{step['peak_memory_gb']:.2f} GB; traced step: device busy "
            f"{step['busy_ms']:.1f} ms, wall {step['traced_wall_ms']:.1f} ms "
            f"(idle {step['idle']:.3f}), the scan backward "
            f"{step['scan_bwd_device_ms']:.2f} ms ({step['scan_bwd_share']:.4f}"
            f" of busy), the scan forward {step['scan_fwd_device_ms']:.2f} "
            f"ms, flash backward {step['flash_bwd_device_ms']:.2f} ms, "
            f"forward {step['flash_fwd_device_ms']:.2f} ms; top device ops "
            + ", ".join(f"{k} {v:.1f}" for k, v in
                        step["top_device_ops_ms"].items()))
    launches = {k: sum(r["launches"][k] for r in recs.values())
                for k in next(iter(recs.values()))["launches"]}
    return dict(configs=recs, launches=launches)


def phase_training(dev, smi):
    """12: training on the card."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.load_library()
    ptx = bwd_ptxas(built.log, built.lib)
    for k, v in ptx.items():
        say("12a backward build", f"flash_bwd_{k}: {v}")
    if built.seconds > 0:            # a reused library printed no log
        check(len(ptx) == 7 and all(" 0 bytes spill stores" in v
                                    for k, v in ptx.items() if "_wg" in k),
              f"12a: the backward's kernels {ptx}: expected seven, the "
              f"wgmma ones without spills")
    scan_ptx = {ln.split("entry function '")[1].split("'")[0]:
                "; ".join(x.strip().replace("ptxas info    : ", "")
                          for x in built.log.splitlines()[i + 1:i + 4]
                          if "spill" in x or "registers" in x)
                for i, ln in enumerate(built.log.splitlines())
                if "entry function" in ln and "selective_scan_bwd" in ln}
    for k, v in scan_ptx.items():
        say("12f scan backward build", f"{k}: {v}")
    if built.seconds > 0:
        check(len(scan_ptx) == 5, f"12f: the scan backward's kernels "
              f"{scan_ptx}: expected five")
    rec = dict(ptxas=ptx, scan_ptxas=scan_ptx, parity=bwd_parity(dev),
               times=bwd_times(dev))
    rec["times"]["max_abs_err"] = rec["parity"]["max_abs_err"]
    rec["train"] = train_full_width(dev, smi)
    rec["resume"] = train_resume(dev)
    rec["examples"] = run_examples()
    rec["gemma3"] = train_gemma3(dev, smi)
    rec["scan_parity"], scan_times = scan_bwd_parity(dev)
    rec["scan_times"] = dict(scan_times["falcon-mamba-7b"], configs=scan_times,
                             max_abs_err=rec["scan_parity"]["max_abs_err"])
    rec["ssm"] = train_ssm(dev, smi)
    rec["seconds"] = time.perf_counter() - t0
    say("12 training", f"{rec['seconds']:.1f} s")
    return rec


REPLACES = {
    "gibbs_sweep": "src/repro/kernels/fused_sweep.py:577",
    # gibbs_sweep_pallas on the chromatic path (one launch per color class)
    "gibbs_class_sweep": "src/repro/kernels/fused_sweep.py:577",
    "mgpmh_sweep": "src/repro/kernels/fused_sweep.py:505",
    "mgpmh_sweep_rng": "src/repro/kernels/fused_sweep.py:542",
    "min_gibbs_sweep": "src/repro/kernels/fused_sweep.py:605",
    "min_gibbs_sweep_rng": "src/repro/kernels/fused_sweep.py:650",
    "double_min_sweep": "src/repro/kernels/fused_sweep.py:687",
    "double_min_sweep_rng": "src/repro/kernels/fused_sweep.py:739",
    "bucket_energy": "src/repro/kernels/minibatch_energy.py:54",
    # bucket_energy_pallas on the local path (src/repro/core/samplers.py:161)
    "local_gibbs_sweep": "src/repro/kernels/minibatch_energy.py:54",
    "flash_attention": "src/repro/kernels/flash_attention.py:79",
    # no Pallas kernel: the JAX package's update is jnp, fused by XLA
    "telemetry_update": "src/repro/diagnostics/telemetry.py:125 (jnp)",
    # no Pallas kernel: jax.grad of the JAX package's jnp attention scan
    "flash_attention_bwd": "src/repro/models/attention.py:44 (jnp, jax.grad)",
    # no Pallas kernel: the JAX package's mamba_block scans with jnp
    "selective_scan":
        "src/repro/models/ssm.py:70 (jnp, jax.lax.associative_scan)",
    # no Pallas kernel: jax.grad through the JAX package's jnp scan
    "selective_scan_bwd": "src/repro/models/ssm.py:61-72 (jnp, jax.grad)",
}
SOURCES = {"bucket_energy": "src/repro_torch/kernels/csrc/bucket_energy.cu",
           "gibbs_class_sweep":
               "src/repro_torch/kernels/csrc/chromatic_sweep.cu",
           "local_gibbs_sweep": "src/repro_torch/kernels/csrc/local_sweep.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "telemetry_update":
               "src/repro_torch/kernels/csrc/telemetry_update.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "selective_scan":
               "src/repro_torch/kernels/csrc/selective_scan.cu",
           "selective_scan_bwd":
               "src/repro_torch/kernels/csrc/selective_scan.cu"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # the plain versions' products in full float32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"device": phase_device()}
    record["build"] = phase_build()
    phase_parity(dev)
    record["bucket_parity"] = phase_bucket_parity(dev)
    record["flash_parity"] = phase_flash_parity(dev)
    potts, lattice, pair_table_s = build_graphs(dev)
    record["full_width"] = full = phase_full_width(potts, lattice)
    record["main_path"] = main = phase_main_path(potts, lattice,
                                                 pair_table_s)
    record["steps"] = phase_steps(potts)
    record["rng_path"], rng_inputs = phase_rng_path(potts)
    record["times"] = times = phase_times(potts, lattice, rng_inputs)
    times["flash_attention"] = flash_times(dev)
    record["serve"] = serve = phase_serve(dev, record["device"]["nvidia_smi"])
    record["wide_prefill"] = phase_wide_prefill(
        dev, record["device"]["nvidia_smi"])
    record["ssm_serve"] = ssm = phase_ssm_serve(
        dev, record["device"]["nvidia_smi"])
    record["moe_serve"] = moe = phase_moe_serve(
        dev, record["device"]["nvidia_smi"])
    record["diagnostics"] = phase_diagnostics(
        potts, lattice, record["device"]["nvidia_smi"])
    record["dist"] = phase_dist(potts, lattice,
                                record["device"]["nvidia_smi"], main)
    record["supervisor"] = sup = phase_supervisor(
        potts, record["device"]["nvidia_smi"])
    record["serving"] = pool = phase_serving(
        potts, record["device"]["nvidia_smi"])
    record["training"] = training = phase_training(
        dev, record["device"]["nvidia_smi"])

    src = "src/repro_torch/kernels/csrc/fused_sweep.cu"
    diag = record["diagnostics"]
    times["telemetry_update"] = diag["telemetry_kernel"]["times"]
    times["flash_attention_bwd"] = training["times"]
    times["selective_scan"] = ssm["times"]
    times["selective_scan_bwd"] = training["scan_times"]
    ssm_train = training["ssm"]["launches"]
    kernels = []
    for k in KERNELS:
        if k.endswith("_rng"):
            launches = record["rng_path"]["launches"][k]
        elif k == "flash_attention":  # prefill (7, 7f, 7m), training
            launches = (serve["flash_launches"] + ssm["launches"][k]
                        + moe["launches"][k]
                        + training["train"]["launches"][k]
                        + training["gemma3"]["launches"][k] + ssm_train[k])
        elif k == "selective_scan":  # SSM / hybrid prefills (7f), training
            launches = ssm["launches"][k] + ssm_train[k]
        elif k == "flash_attention_bwd":  # training (12b, 12e, 12f)
            launches = (training["train"]["launches"][k]
                        + training["gemma3"]["launches"][k] + ssm_train[k])
        elif k == "selective_scan_bwd":  # SSM / hybrid training (12f)
            launches = ssm_train[k]
        elif k == "bucket_energy":       # the single-site steps' energy
            launches = sum(r["bucket_energy_launches"]
                           for r in record["steps"].values())
        elif k == "telemetry_update":    # the telemetry'd main path (8a)
            launches = diag["main"]["mgpmh"]["launches"][k]
        else:
            launches = sum(run["launches"].get(k, 0) for run in main.values())
        # the supervised and serving paths' launches (phases 10, 11)
        launches += sup["launches"].get(k, 0) + pool["launches"].get(k, 0)
        check(launches > 0, f"{k} was not launched on its path")
        t = times[k]
        err = (full[k][1] if k in full
               else record["flash_parity"]["max_abs_err"]
               if k == "flash_attention"
               else diag["telemetry_kernel"]["max_abs_err"]
               if k == "telemetry_update"
               else training["parity"]["max_abs_err"]
               if k == "flash_attention_bwd"
               else ssm["parity"]["max_abs_err"] if k == "selective_scan"
               else training["scan_parity"]["max_abs_err"]
               if k == "selective_scan_bwd"
               else record["bucket_parity"]["max_abs_err"])
        kernels.append(dict(
            name=k, route="cuda", source=SOURCES.get(k, src),
            replaces=REPLACES[k], launches=launches,
            max_abs_err=max(err, t.get("max_abs_err", 0.0)),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t.get("library_ms"),
            shape=t["shape"], plain_shape=t.get("plain_shape", t["shape"])))
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    say("done", f"{record['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(record["device"]["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
