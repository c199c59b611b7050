#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`cfd_proxy_tpu_torch/`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; run from the root of a checkout.  It builds
the port's CUDA kernels from `cfd_proxy_tpu_torch/csrc/` and drives the
port's paths at the benchmark size (a 96³-point generated mesh, ~2.8 M
faces, nvar 7, random state from a seed):

- `main_path`: one shard, the `bulk` schedule; then `kernels` (K4 and K1
  against their plain versions), `kernels_update` (the chained update's
  kernel, ops/update.py, bit for bit its plain version: f32 and bf16
  gradients, gg and flux rows, into a new tensor and into `out`), `timing`
  and `main_path_profile` (the P=1 bulk step's device parts, eager and
  under graph: K1 and the update, one launch each, no fill, no other
  kernel; `main_path_profile_p1_all` the same for the overlap step: no
  fill, one update);
- `main_path_p1_all`: one shard with the fused overlap kernel forced
  (`force_rdma`), schedules bulk, early and overlap;
- `main_path_p8`: the mesh cut into 8 shards, all on the card, schedules
  bulk, early, overlap and nocomm, with the halo exchange between shards;
  then `kernels_pack`: the halo pack's kernel (ops/halo_pack.py) bit for
  bit its plain version at that plan in every (source, wire) dtype form,
  pad lanes zero, timed in turns; the overlap step under graph launches
  it once a step and no torch indexing kernel;
- `solver_p1`: one shard, the gather kernel at bp 512 (the solver-mode
  configuration): every schedule, `refresh_state` after an update of the
  owned columns, and the solver-mode runner (`iterate_fn(...,
  solver_mode=True)`: table rebuild, sweep + update, var exchange);
- `solver_p8`: the same at 8 shards, with the var exchange's ghost columns
  checked against their owners;
- `gather_auto_bp`: the gather kernel at the AUTO block size (4096), under
  the body the rule (`blocksweep.gather_body`) picks there; all three
  bodies held against the plain version and each other, and timed in
  turns;
- `gather_large_bp`: the gather kernel at bp 8192, where the staged table
  does not fit a CUDA block's shared memory: the cluster body (two CUDA
  blocks per entry, half the table each), then the direct body forced
  through the same step, both counted, held with the quad body forced
  against the plain version and each other bit for bit, and timed in
  turns;
- `solver_mode_timing`: the solver-mode step at P=1 and P=8, bulk, for
  gather/bp 512 and packed/AUTO at 1, 2 and 4 sweeps per step — the
  numbers `solver.solver_mode_defaults` is decided from;
- `k3_gather_large_bp`: K3's gather form on the cluster body (two CUDA
  blocks per entry, the push region padded to whole clusters), through the
  gather model's bulk, early and overlap steps at P=1 `all` with
  force_rdma at the AUTO bp (4096) and at bp 8192, at P=2 AUTO, through
  the peer transport at P=2 AUTO (bit for bit the loopback step), and at
  P=1 bp 8192 under flux and under bf16 weights, stores and halo; then on
  the quad body (four CUDA blocks per entry, the push region padded to
  whole clusters of four) at P=2 bp 8192, loopback and peer, where K2 and
  K2-init run on it too; then the same plans under flux, loopback and
  peer, which the rule keeps on the direct body (K2, K2-init and K3-gather
  direct, each launch's point-major table built first): each against its
  golden and across schedules,
  its overlap step forced onto the kernel's other bodies that fit bit for
  bit, the fused call under each body against the plain version and timed
  in turns, the peer call against its loopback form in turns (at most
  PEER_OVER_LOOPBACK of its time);
- `flux_p1`: the PSD upwind flux model (`PSDFluxModel`, bench.py's
  secondary row: packed, AUTO bp, bulk) at one shard, timed, then every
  schedule with the fused overlap kernel forced;
- `flux_p8`: the flux model at 8 shards, every schedule under the packed
  kernel, then the gather kernel at bp 512 with `refresh_state` and the
  solver-mode runner, ghost columns checked against their owners;
- `reduced_p1`: bench.py's reduced-precision row (packed, AUTO bp, bulk,
  bf16 source deltas and weights), timed, then with bf16 gradient stores
  as well, timed: faces/s and the speedups over this run's f32 bulk step;
- `reduced_p1_all`: one shard, the fused overlap kernel forced, all four
  reduced-precision options, every schedule;
- `reduced_p8`: 8 shards, all four options under the packed kernel, every
  schedule; the bf16-halo-only model against the f32 model (owned columns
  bitwise, ghosts the bf16 rounding of their owners); the gather kernel at
  bp 512 with bf16 weights, stores and halo, `refresh_state` and the
  solver-mode runner;
- `reduced_flux`: the flux model at one shard with bf16 sources, weights
  and stores, bulk, timed;
- `graph`: the chained step as CUDA graphs (models/compiled.py, the
  dispatch every loop above took) against the same step eager, at P=1
  bulk, P=1 `all` with force_rdma, P=8 every schedule, gather/512 solver
  mode (P=1 one sweep, P=8 two), gather P=2 AUTO overlap (K3-gather's
  cluster launch), P=2 bp 8192 overlap (K2-init's and K3-gather's quad
  launches) and its flux twin (their direct launches, each after its
  table's), the full bf16 stack (P=1 overlap, P=8
  early), flux P=1 `all`, the overlap step through the peer transport
  (P=1 `all` with force_rdma; P=8 packed f32, gather/512 and the full bf16
  stack: the launch epochs are device words, so the step replays; its
  20 steps also equal its loopback twin's graph bit for bit), the ELL
  model (P=1, f32 and f64, bulk and overlap; no kernel of the port, so its
  census is of its torch ops, recorded) and one `solver_attrib` knockout
  per kernel it knocks out (packed tablesonly: K4; packed sweeponly: K1;
  gather/512 sweeponly: K2): the dispatch "graph"; 20 chained steps
  under graph and eager bit for bit, at a coupling (0.1 over the first
  step's max |g|) that makes the state carry every step's gradients; one
  replayed step's output (its gradients; the knockout tablesonly: its
  rebuilt table) bit for bit the eager step's and its gradients within
  the golden bound (f64 ELL 1e-12); the kernels a
  replay launches, read from the captured graphs (`compiled.kernel_nodes`),
  the port's among them equal to the launches an eager step counts and to
  the counts the runner adds (CUPTI's view of an eager step and of the
  replays recorded beside them; the P=1 bulk step's replay K1 and the
  update kernel once each, nothing else); the capture's seconds and peak
  memory;
  the step in turns
  (eager, graph, graph, eager) with each turn's device ms and idle share,
  failing where the graph step is over 1.03x the eager (each turn's step
  at least its held device time: the host's clock read an eager step 7 %
  under it once) or where, in P=1
  overlap (f32 `all`, full bf16 stack, flux), the idle share under graph
  is above 1 % or above an eager share that is above 1 %; the P=1 and P=8
  overlap steps profiled both ways in turns (eager, graph, graph, eager,
  twice; a window's step device ms from each kernel's mean over the
  records it kept, as CUPTI drops some, times the most launches a step
  any window shows), failing unless each side has a window that holds
  every kernel and the median window's device ms per side are within
  5 % (each side's launches a step recorded);
- `kbench`: the kernel bench (`tools/kbench.py`) at its defaults (96³, bp
  4096), driven through `kbench.main` with `--check` three times: the
  full-width variants (K1 as prod, flat, bf16src, w16, bf16sw; the twins
  stream (K5a), wsum (K5b), nv7 (K5c)), the prefix variants (K1 as compact,
  compact_bsw, compact_bso, cflux; the stream twin K5e as cstream_c and
  cstream_bso) and the rungs on the prefix tables (K1 on the bf16 state as
  var16; compact_i8 (K5d), bso_fold and bso_wsum (K5f), bso_acc3 (K5g),
  cflux_fact (K5h), cstream_flux (K5i)); then each twin, each rung and the
  three K1 instances only the bench launches (bf16 deltas alone, bf16
  weights alone, the bf16 state) against their plain versions, timed with
  their bounds; bso_acc3 and bso_fold against compact_bso bit for bit; the
  bench's abs-sum fingerprints (summed in f32) of compact_i8 and
  compact_bso told apart; and the reference's verdict pairs
  (compact/cstream_c, compact_bso/cstream_bso, prod/stream, prod/wsum,
  prod/nv7, cflux/cstream_flux, cflux/cflux_fact, compact_bso over
  bso_fold, bso_wsum, bso_acc3, var16 and compact_i8) timed in turns.
- `peer_p1`, `peer_p8`, `peer_w2`, `nccl_w1`, `icibench`: the multi-rank
  transports and the push bench (see the phases' comments): the overlap
  step through both transports timed in turns under their dispatch
  (graph), K3-peer at most 1.05x its loopback form, the two-process
  overlap chain under graph in both processes (bitwise to eager per rank
  and to the one-process chain), the push bench's rows replayed as graphs
  and K6's chain timed under graph and eager;
- `ell_p1`, `ell_p8`: the ELL model (`--backend xla`, plain torch, no
  kernel of the port) at one and 8 shards, f32 and f64: every schedule
  against the golden (f32 1e-5, f64 1e-12) and bulk, the f64 exact path's
  raw sums bit for bit the golden loop on each shard's plan faces and its
  schedules bit for bit bulk; every schedule's step median and device
  profile (idle share), the bytes its gathered slot table takes and the
  peak memory, beside the kernel path's step;
- `golden_tool`: `tools/golden.py` dump, then check with the golden, a
  perturbed seed (exit 1), the kernel model and the ELL model in f64;
- `fake_phases`: P=8 with `--min-phases 8 --fake-sends 4096`, packed (K3)
  and gather/512 (K3-gather): owned columns against the golden and across
  schedules, the overlap step in turns with the plain model's;
- `profile`: the CLI's `--profile` trace, which must name K1's kernel;
- `solver_attrib`: the five knockout bodies at one shard, packed/AUTO and
  gather/512;
- `dryrun`: `tools/dryrun.py` at 8 shards, every leg;
- `scaling_model`: the scaling model's inputs against the card: its f32
  rate table beside the P=1 bulk step re-measured through the solver at
  nx 24 and 50 and the 96³ rates of `timing` and `reduced_p1` (each within
  2x either way where the table's step is off its launch floor; the steps
  on the floor, `on_launch_floor`, are recorded), its chain defaults beside
  the P=1 fake-phase chain (6 phases × 2432 sends at 48³), and its
  predictions at 96³ for P = 1, 2, 4, 8;
- `bench`: the benchmark entry point, `python -m cfd_proxy_tpu_torch.bench`,
  in a process of its own at its defaults (96³, every schedule, every row,
  the model block on): exit 0, its last line strict JSON with
  `platform: "cuda"`, `value > 0` and every row present, none shed; the
  kernels its FULL_JSON says it launched; its wall time and its P=1 bulk
  step beside the `timing` phase's.

The gather paths print each plan's EP, its live-EP maximum and the body
the rule picks; K2 and K3-gather count each body apart (the cluster body's
row ends in `_cluster`: K2 and K3-gather at bp 8192, K3-gather's peer form
at P=2 AUTO; the quad body's in `_quad`: K2, K2-init and K3-gather,
loopback and peer, at P=2 bp 8192; the direct body's in `_direct`: K2 and
K3-gather at bp 8192 forced, K3's gather flux form at bp 512, which keeps
it, and K2, K2-init and K3-gather-peer flux at P=2 bp 8192, where the rule
keeps it; `gather_table` is the point-major table a direct launch reads
where its plan's sources is "table", which its wrapper builds first; a
direct row's bound is the sweep's own, `bound_ms_with_table` beside it
adds the table's bytes written and read once), so the
kernel table lists each under the body its path launched, with that
instance's registers, local bytes, shared memory and resident blocks per
SM (the cluster and quad bodies also the clusters the card can hold at
once).

Each path is driven with every kernel's launch count set to 0 just before
and read just after, and checked against the f64 golden of its op
(Green-Gauss or flux; the reduced-precision paths inside the reference's
bands), across schedules and (P=8) ghost column against owner column.
Then each kernel is compared with its plain PyTorch version on the card at
the paths' shapes (f32 outputs within 1e-6 of max|plain|, bf16 outputs
within one bf16 ulp, packs and pushes bitwise), and the kernels and every
schedule's step are timed; at P=8 a `torch.profiler` trace of 20 chained
steps per schedule gives each step's device time and so its idle share.
Each
kernel's row carries its bound: the larger of the bytes it must move (each
input read once, each output written once, at its stored width — 2 bytes
for a bf16 operand — counting only the columns and table lanes of the
block entries the call computes) over 3.35 TB/s and its f32 operations
over 67 TFLOP/s (the H100 SXM's published peaks).

Phases print one JSON line each on stdout, each with `dispatch`: how the
phase's chained loops ran (runner calls under "graph" and "eager", the
eager ones' reasons: torch.distributed, gloo; "none" without a loop);
any failure raises and exits non-zero.  The last lines are the kernel table (JSON), the card's name and
power limit as nvidia-smi reports them, and

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA card, or outside a checkout, it exits non-zero before
printing anything on stdout.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

NX = 96          # the benchmark mesh: nx = ny = nz
NVAR = 7
SEED = 0
P_MULTI = 8      # shards of the multi-shard path (the reference's mpirun -n 8)
TIMED_STEPS = 200
SOLVER_STEPS = 100   # timed solver-mode steps per configuration
SOLVER_RUN = 4       # solver-mode steps of the counted runner
GRAPH_STEPS = 20     # chained steps held graph against eager, bit for bit
GRAPH_ITERS = 100    # timed steps per turn of the graph phase
GRAPH_SLOWER = 1.03  # the graph step may not pass the eager one by more
GRAPH_MOVE = 0.1     # the bitwise runs' coupling: GRAPH_MOVE / max|g| (the
                     # reference's 1e-30 leaves an f32 state as it was)
GRAPH_CHECK_N = 2    # replays whose kernels CUPTI counts, per configuration
PROFILE_BAND = (0.95, 1.05)  # profiled device ms, graph over eager
PROFILE_TURNS = 2    # rounds of profiled windows (eager, graph, graph, eager)
IDLE_FLOOR = 0.01    # an idle share at or under it leaves the host no share
IDLE_CFGS = ("p1_all_overlap", "full_p1_overlap", "flux_p1_all_overlap")
PORT_KERNEL = re.compile(r"\b(?:sweep|pack|chain)_\w*kernel\b")  # csrc's
SCHEDULES_ALL = ("bulk", "early", "overlap", "nocomm")
GATHER_BP = 512      # the gather kernel's solver-mode block size
LARGE_BP = 8192      # a block size whose gather table no block's shared
                     # memory holds: the gather sweep's cluster body
SWEEPS = (1, 2, 4)   # sweeps per solver-mode step
K1_TOL = 1e-6    # sweep kernels vs plain: FMA contraction, relative to max|ref|
GOLDEN_TOL = 1e-5   # every schedule vs f64 golden (the reference's gate)
SCHED_TOL = 1e-6    # early vs bulk, overlap vs early, relative to max|bulk|
BF = "bfloat16"
FULL = {"src_dtype": BF, "meta_dtype": BF, "grad_dtype": BF,
        "halo_dtype": BF}     # the reduced-precision options, all four
# vs the f64 golden, the reference's bands (tests/test_pallas_model.py):
# bf16 sources and weights; the full stack.  bench.py's with_bf16_grads
# row (bf16 sources, weights and stores) is held to the full stack's band:
# at one shard the bulk step does not read the halo option, so it is the
# full stack's step, and at 96^3 its error (5.18e-3, the plain version's
# too) passes the 5e-3 that the reference's tests set for bf16 stores alone
BAND_SRC_META = (1e-7, 5e-3)
BAND_FULL = (1e-5, 2e-2)
FLUX_BF16_TOL = 5e-3   # flux with bf16 sources/stores vs the flux golden
SCHED_TOL_BF16 = 1e-2  # schedules with bf16 stores, relative to max|bulk|
HBM_BYTES_PER_MS = 3.35e9      # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9          # H100 SXM: 67 TFLOP/s f32 outside tensor cores
# f32 operations per slot lane (FMA = 2): the sweep ops, and kbench's
# twins (ops/twins.py): stream 11 adds, wsum 24 FMAs + 3, nv7 gg on 7 rows;
# its rungs: fold 8 adds + 24 FMAs, fold_wsum 24 FMAs, acc3 and var16 gg's,
# i8 gg's + 8 multiplies, flux_fact two 3-term dots, |.|, max, cu, cg and
# 8 × (multiply, FMA, add), stream_flux 11 adds
OPS_PER_SLOT_LANE = {"gg": 64, "flux": 85, "stream": 11, "wsum": 51,
                     "nv7": 56, "fold": 56, "fold_wsum": 48, "acc3": 64,
                     "var16": 64, "i8": 72, "flux_fact": 49,
                     "stream_flux": 11}
FLUX_ROWS = ("flux", "flux_fact", "stream_flux")    # ops writing NV rows
KB_BP = 4096      # kbench's default block size (its mesh is NX³, seed 0)
KB_ITERS = 100    # kbench's default chained-loop length
# kbench's three drives: variants (each --check'ed where it has gg or flux
# semantics) and the K1 instances they must launch
KB_RUNS = {
    "full": (("prod", "flat", "bf16src", "w16", "bf16sw", "stream", "wsum",
              "nv7"),
             ("pack_srcs", "pack_srcs_d16", "sweep_blocks", "sweep_blocks_d16",
              "sweep_blocks_w16", "sweep_blocks_w16_d16")),
    "prefix": (("compact", "compact_bsw", "compact_bso", "cflux", "cstream_c",
                "cstream_bso"),
               ("pack_srcs", "pack_srcs_d16", "sweep_blocks",
                "sweep_blocks_w16_d16", "sweep_blocks_w16_d16_o16",
                "sweep_blocks_flux")),
    "rungs": (("var16", "compact_i8", "bso_fold", "bso_wsum", "bso_acc3",
               "cflux_fact", "cstream_flux"),
              ("pack_srcs", "pack_srcs_d16", "sweep_blocks_v16_w16_d16_o16")),
}
# the twin rows of the kernel table: (kbench variant, drive, instance)
TWIN_ROWS = {"stream": ("stream", "full", "stream_twin"),
             "wsum": ("wsum", "full", "wsum_twin"),
             "nv7": ("nv7", "full", "nv7_sweep"),
             "cstream_c": ("cstream_c", "prefix", "stream_twin"),
             "cstream_bso": ("cstream_bso", "prefix",
                             "stream_twin_w16_d16_o16"),
             "compact_i8": ("compact_i8", "rungs", "i8_sweep"),
             "bso_fold": ("bso_fold", "rungs", "bso_twin"),
             "bso_wsum": ("bso_wsum", "rungs", "bso_twin_hoist"),
             "bso_acc3": ("bso_acc3", "rungs", "bso_acc3_twin"),
             "cflux_fact": ("cflux_fact", "rungs", "flux_fact_twin"),
             "cstream_flux": ("cstream_flux", "rungs", "stream_flux_twin")}
# the reference's recorded verdicts (kbench.py docstring), as A / B
KB_VERDICTS = (("compact", "cstream_c"), ("compact_bso", "cstream_bso"),
               ("prod", "stream"), ("prod", "wsum"), ("prod", "nv7"),
               ("cflux", "cstream_flux"), ("cflux", "cflux_fact"),
               ("compact_bso", "bso_fold"), ("compact_bso", "bso_wsum"),
               ("compact_bso", "bso_acc3"), ("compact_bso", "var16"),
               ("compact_bso", "compact_i8"))
# the variants whose output K1-w16-d16-o16's (compact_bso) equals bitwise
KB_BITWISE = ("bso_acc3", "bso_fold")
KERNELS = {      # name: (route, source, the TPU kernel it replaces)
    "pack_srcs": ("cuda", "cfd_proxy_tpu_torch/csrc/pack_srcs.cu",
                  "cfd_proxy_tpu/ops/blocksweep.py:940"),
    "sweep_blocks": ("cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                     "cfd_proxy_tpu/ops/blocksweep.py:549"),
    "sweep_blocks_init": ("cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                          "cfd_proxy_tpu/ops/blocksweep.py:549"),
    "sweep_blocks_overlap": ("cuda",
                             "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
                             "cfd_proxy_tpu/ops/blocksweep.py:687"),
    "sweep_blocks_gather": ("cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
                            "cfd_proxy_tpu/ops/blocksweep.py:549"),
    # K2's cluster body, which the gather_body rule picks where the staged
    # table does not fit one CUDA block but half of it does (bp 8192), and
    # its direct body, forced there (the rule keeps it for bp or EP not a
    # multiple of 4)
    "sweep_blocks_gather_cluster": ("cuda",
                                    "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
                                    "cfd_proxy_tpu/ops/blocksweep.py:549"),
    "sweep_blocks_gather_direct": ("cuda",
                                   "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
                                   "cfd_proxy_tpu/ops/blocksweep.py:549"),
    "sweep_blocks_gather_init": ("cuda",
                                 "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
                                 "cfd_proxy_tpu/ops/blocksweep.py:549"),
    "sweep_blocks_overlap_gather": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:687"),
    # the flux bodies: _block_compute_packed :495-504 (K1), _block_compute
    # :420-426 (K2), sweep_blocks_overlap's packed / gather bodies :744-747
    "sweep_blocks_flux": ("cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                          "cfd_proxy_tpu/ops/blocksweep.py:495"),
    "sweep_blocks_flux_init": ("cuda",
                               "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                               "cfd_proxy_tpu/ops/blocksweep.py:495"),
    "sweep_blocks_overlap_flux": ("cuda",
                                  "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
                                  "cfd_proxy_tpu/ops/blocksweep.py:744"),
    "sweep_blocks_gather_flux": ("cuda",
                                 "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
                                 "cfd_proxy_tpu/ops/blocksweep.py:420"),
    "sweep_blocks_gather_flux_init": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:420"),
    # K3's gather flux form keeps its direct body (blocksweep.gather_body)
    "sweep_blocks_overlap_gather_flux_direct": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:747"),
    # the reduced-precision instances the counted paths launch: w16 bf16
    # weights, d16 bf16 source deltas (K1 body :490-491 gg, :496-497 flux;
    # K4's delta pack :969-975), o16 bf16 output and init (store :514,
    # :428); K3's push moves bf16 buffers
    "pack_srcs_d16": ("cuda", "cfd_proxy_tpu_torch/csrc/pack_srcs.cu",
                      "cfd_proxy_tpu/ops/blocksweep.py:973"),
    "sweep_blocks_w16_d16": ("cuda",
                             "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                             "cfd_proxy_tpu/ops/blocksweep.py:490"),
    "sweep_blocks_w16_d16_o16": ("cuda",
                                 "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                                 "cfd_proxy_tpu/ops/blocksweep.py:490"),
    "sweep_blocks_init_w16_d16_o16": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:490"),
    "sweep_blocks_overlap_w16_d16_o16": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:744"),
    "sweep_blocks_gather_w16_o16": ("cuda",
                                    "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
                                    "cfd_proxy_tpu/ops/blocksweep.py:414"),
    "sweep_blocks_gather_init_w16_o16": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:414"),
    "sweep_blocks_overlap_gather_w16_o16": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:747"),
    "sweep_blocks_flux_w16_d16_o16": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:496"),
    # K1 instances only kbench launches: bf16 deltas alone (bf16src, the
    # delta body :491), bf16 weights alone (w16, the weight upcast :487)
    "sweep_blocks_d16": ("cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                         "cfd_proxy_tpu/ops/blocksweep.py:491"),
    "sweep_blocks_w16": ("cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
                         "cfd_proxy_tpu/ops/blocksweep.py:487"),
    # kbench's twins (ops/twins.py), one row per bench variant: K5a stream,
    # K5b wsum, K5c nv7, K5e cstream_c (f32) and cstream_bso (bf16)
    "stream": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_twins.cu",
               "cfd_proxy_tpu/tools/kbench.py:269"),
    "wsum": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_twins.cu",
             "cfd_proxy_tpu/tools/kbench.py:278"),
    "nv7": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_twins.cu",
            "cfd_proxy_tpu/tools/kbench.py:300"),
    "cstream_c": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_twins.cu",
                  "cfd_proxy_tpu/tools/kbench.py:476"),
    "cstream_bso": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_twins.cu",
                    "cfd_proxy_tpu/tools/kbench.py:476"),
    # kbench's rungs on the prefix tables: K1 on the bf16 state (var16, the
    # own upcast :469), K5d compact_i8, K5f bso_fold and bso_wsum, K5g
    # bso_acc3, K5h cflux_fact, K5i cstream_flux
    "sweep_blocks_v16_w16_d16_o16": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:469"),
    "compact_i8": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_rungs.cu",
                   "cfd_proxy_tpu/tools/kbench.py:424"),
    "bso_fold": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_rungs.cu",
                 "cfd_proxy_tpu/tools/kbench.py:546"),
    "bso_wsum": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_rungs.cu",
                 "cfd_proxy_tpu/tools/kbench.py:546"),
    "bso_acc3": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_rungs.cu",
                 "cfd_proxy_tpu/tools/kbench.py:614"),
    "cflux_fact": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_rungs.cu",
                   "cfd_proxy_tpu/tools/kbench.py:691"),
    "cstream_flux": ("cuda", "cfd_proxy_tpu_torch/csrc/kbench_rungs.cu",
                     "cfd_proxy_tpu/tools/kbench.py:743"),
}
# K3's peer form (address table, readiness barrier :783-789, arrival waits
# :796-801) and K6, the push bench's kernel, one row per mode
KERNELS.update({
    "sweep_blocks_overlap_peer": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:783"),
    "sweep_blocks_overlap_gather_peer": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:783"),
    "sweep_blocks_overlap_peer_w16_d16_o16": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:783"),
    **{f"push_phases_{m}": ("cuda", "cfd_proxy_tpu_torch/csrc/push_bench.cu",
                            "cfd_proxy_tpu/tools/icibench.py:75")
       for m in ("full", "nobar", "baronly", "empty")},
})
# K3's gather form on the cluster body (blocksweep.gather_body: where two
# staged tables do not fit one SM but half of one fits a CUDA block; the
# push blocks share the cluster launch), its direct body forced there, and
# the K2 cluster instances the P=2 paths of that phase launch besides
# K2-cluster (the early schedule's init sweeps, flux, bf16 weights and out)
KERNELS.update({
    **{"sweep_blocks_overlap_gather" + tag: (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:747")
       for tag in ("_cluster", "_direct", "_flux_cluster",
                   "_w16_o16_cluster")},
    "sweep_blocks_overlap_gather_peer_cluster": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:783"),
    "sweep_blocks_gather_init_cluster": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:549"),
    **{"sweep_blocks_gather" + tag: (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:420")
       for tag in ("_flux_cluster", "_flux_init_cluster")},
    **{"sweep_blocks_gather" + tag: (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:414")
       for tag in ("_w16_o16_cluster", "_init_w16_o16_cluster")},
})
# the quad body (blocksweep.gather_body: where half the table passes a CUDA
# block and a quarter fits), which the two-shard paths at LARGE_BP launch:
# K2 (bulk), K2-init (boundary and interior) and K3-gather, loopback and
# peer
KERNELS.update({
    **{"sweep_blocks_gather" + tag: (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:549")
       for tag in ("_quad", "_init_quad")},
    "sweep_blocks_overlap_gather_quad": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:747"),
    "sweep_blocks_overlap_gather_peer_quad": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:783"),
})
# the direct body where the rule keeps it at the two-shard paths at LARGE_BP
# (K3_DIRECT_CFGS: flux, half the table past a block): K2 (bulk), K2-init
# (boundary) and K3-gather's peer form (its loopback form is the
# eight-shard flux row above), and the point-major table every direct
# launch reads, built by its wrapper first (the reference's block table
# [own ‖ exts] of _block_compute)
KERNELS.update({
    **{"sweep_blocks_gather" + tag: (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:420")
       for tag in ("_flux_direct", "_flux_init_direct")},
    "sweep_blocks_overlap_gather_peer_flux_direct": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:783"),
    "gather_table": ("cuda", "cfd_proxy_tpu_torch/csrc/sweep_gather.cu",
                     "cfd_proxy_tpu/ops/blocksweep.py:391"),
    # the chained update v + c·g[:, :NV] (ops/update.py), f32 and bf16
    # gradients: XLA's fusion of the reference's `v + 1e-30 * g[:, :NV, :]`
    # in its jitted loops (no pallas_call)
    **{"chain_update" + tag: ("cuda", "cfd_proxy_tpu_torch/csrc/update.cu",
                              "cfd_proxy_tpu/models/gradients_pallas.py:1102")
       for tag in ("", "_g16")},
    # the halo pack (ops/halo_pack.py), every (source, wire) dtype form:
    # XLA's slices and take of the reference's `_pack_buf` (no pallas_call)
    **{"pack_halo" + tag: ("cuda", "cfd_proxy_tpu_torch/csrc/halo_pack.cu",
                           "cfd_proxy_tpu/models/gradients_pallas.py:807")
       for tag in ("", "_x16", "_o16", "_x16_o16")},
})
# that phase's configurations of the gather model: name: (shards, model
# options); each runs bulk, early and overlap.  At one shard (force_rdma)
# the interior plan's EP is about the bulk plan's (1920 at AUTO's bp 4096,
# 2688 at bp 8192), K2's cluster shapes in `gather_*_bp`; at two shards it is
# 5760 at bp 4096 (the half table, 154 KB, still fits a block).  At two
# shards and bp 8192 (K3_QUAD_CFGS) the interior EP is 10496 and the bulk
# and boundary EP 16768: half of each table (292 and 390 KB) passes a
# block, a quarter (146 and 195 KB) fits, and the rule picks the quad body
# for K2, K2-init and K3-gather
K3_CLUSTER_CFGS = {
    "p1_all_auto": (1, {"force_rdma": True}),
    "p1_all_large": (1, {"force_rdma": True, "bp": LARGE_BP}),
    "p2_auto": (2, {}),
    "p2_auto_peer": (2, {"transport": "peer"}),
    "p1_all_large_flux": (1, {"force_rdma": True, "bp": LARGE_BP,
                              "op": "flux"}),
    "p1_all_large_w16_o16": (1, {"force_rdma": True, "bp": LARGE_BP,
                                 "meta_dtype": "bfloat16",
                                 "grad_dtype": "bfloat16",
                                 "halo_dtype": "bfloat16"}),
}
K3_QUAD_CFGS = {
    "p2_large": (2, {"bp": LARGE_BP}),
    "p2_large_peer": (2, {"bp": LARGE_BP, "transport": "peer"}),
}
# the same plans under flux, which the rule keeps on the direct body there
# (its quad form reads three remote planes a source): K2, K2-init and
# K3-gather direct, loopback and peer
K3_DIRECT_CFGS = {
    "p2_large_flux": (2, {"bp": LARGE_BP, "op": "flux"}),
    "p2_large_flux_peer": (2, {"bp": LARGE_BP, "op": "flux",
                               "transport": "peer"}),
}
PEER_STEPS = 5        # timed steps of a two-process run (time-sliced)
PEER_MIN_BLOCKS = 6   # K3's resident blocks per SM (sweep_overlap.cu kMinBlocks)
PEER_OVER_LOOPBACK = 1.05  # K3-peer's time over its loopback form's, at most
# the same of K3's staged gather instances (kStagedMinBlocks), which the
# 48 KB table of the P=8 interior plan admits
STAGED_MIN_BLOCKS = 4
PEER_W2_LIMIT_S = 420     # the two-process phase is killed past this
ICI_PHASES = (1, 2, 4)                  # the push bench's grid: the
ICI_MB = (0.125, 1.0, 8.0, 32.0)        # reference's defaults
ICI_ROW = (4, 8.0)    # (phases, MB per phase) of K6's kernel-table rows
ICI_CHAIN_ITERS = 100  # chained pushes per two-point sample of the chain
PACKED = ("pack_srcs", "sweep_blocks", "sweep_blocks_init",
          "sweep_blocks_overlap")
GATHER = ("sweep_blocks_gather", "sweep_blocks_gather_init",
          "sweep_blocks_overlap_gather")
FLUX_PACKED = ("pack_srcs", "sweep_blocks_flux", "sweep_blocks_flux_init",
               "sweep_blocks_overlap_flux")
FLUX_GATHER = ("sweep_blocks_gather_flux", "sweep_blocks_gather_flux_init",
               "sweep_blocks_overlap_gather_flux_direct")
# the ELL model (--backend xla) and the tools beside the solver
ELL_STEPS = 30       # timed ELL steps per schedule (a step takes ms)
ELL_PROFILE_STEPS = 10
ELL_GRAPH_ITERS = 20  # timed ELL steps per turn of the graph phase
ELL_F64_TOL = 1e-12  # f64 vs the golden (ULP level expected) and schedules
GT_NX = 24           # the golden tool's mesh (its --nx)
FAKE = {"min_phases": 8, "fake_sends": 4096}   # 6 real phases at P=8
PROF_NX = 48         # the --profile run's mesh
ATTRIB_STEPS = 50    # solver_attrib's chained-loop length per mode
DRYRUN_N = 8
SM_NX = (24, 50)     # rate-table sizes the smoke run re-measures
SM_RATIO = 2.0       # a re-measured rate off the table by more: table wrong
SM_FLOOR_X = 2.0     # a table step under this x its fastest: the launch floor
SM_CHAIN = (48, 2432, 1000)   # nx, fake sends, iters (6 phases)
SM_CROSS_ABS = 1e-3  # schedules vs bulk, abs (f32 rounding ~1e-5 at 48³)
SM_PARTS = (1, 2, 4, 8)
ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_TIMEOUT_S = 600
# the rows of the bench's compact line, each present and none shed
BENCH_KEYS = ("sched_ms", "reduced", "small", "flux_gfps", "solver_ms",
              "solver_ms_per_sweep", "mc_model", "node")
# what its rows launch: set-up and the P=1 schedules (main run, small mesh),
# reduced precision, flux, solver mode at gather/512
BENCH_LAUNCHED = ("pack_srcs", "sweep_blocks", "sweep_blocks_init",
                  "sweep_blocks_overlap", "pack_srcs_d16",
                  "sweep_blocks_w16_d16", "sweep_blocks_w16_d16_o16",
                  "sweep_blocks_flux", "sweep_blocks_gather",
                  "chain_update", "chain_update_g16")
REDUCED_PACKED = ("pack_srcs_d16", "sweep_blocks_w16_d16_o16",
                  "sweep_blocks_init_w16_d16_o16",
                  "sweep_blocks_overlap_w16_d16_o16")
# the halo pack's rows: (source dtype, wire dtype)
PACK_FORMS = {"pack_halo": ("float32", "float32"),
              "pack_halo_x16": ("bfloat16", "float32"),
              "pack_halo_o16": ("float32", "bfloat16"),
              "pack_halo_x16_o16": ("bfloat16", "bfloat16")}
REDUCED_GATHER = ("sweep_blocks_gather_w16_o16",
                  "sweep_blocks_gather_init_w16_o16",
                  "sweep_blocks_overlap_gather_w16_o16")


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started and
    `dispatch`: how the phase's chained runners ran since the last line
    (`compiled.take_calls`: calls per "graph" / "eager", the eager ones'
    reasons), "none" where it ran none."""
    compiled = sys.modules.get("cfd_proxy_tpu_torch.models.compiled")
    calls = compiled.take_calls() if compiled is not None else {}
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0,
                      "dispatch": calls or "none", **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed (rc {res.returncode}): {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean device milliseconds per call over n calls (CUDA events, after a
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def paired_ms(kern, plain, n: int = 50) -> dict:
    """Kernel and plain version in turns (plain, kernel, kernel, plain);
    the better of each pair."""
    p1, k1 = cuda_ms(plain, n), cuda_ms(kern, n)
    k2, p2 = cuda_ms(kern, n), cuda_ms(plain, n)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2)}


def held_paired_ms(kern, plain, n: int = 100) -> dict:
    """`paired_ms` with each side's n calls held behind a sleep kernel
    (`kernel_device_ms`): for calls shorter than their launches, whose
    event means time the host."""
    p1, k1 = kernel_device_ms(plain, n), kernel_device_ms(kern, n)
    k2, p2 = kernel_device_ms(kern, n), kernel_device_ms(plain, n)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": moved, "bound_ops": ops}


def sweep_bound(op: str, args, gather: bool, init: bool = False,
                push=None, out_bytes: int = 4, extra: str = "") -> dict:
    """Bound of one sweep call on args = (var_T, table, plan operands...),
    counting only what the call touches, each operand at its stored width
    (bf16 weights, deltas, outputs and state 2 bytes, int8 deltas 1;
    out_bytes: the output's; extra: "wsum", three more f32 per listed
    column, or "i8_scale", NV f32 per listed entry).  The listed entries
    (not a pad entry, which repeats its predecessor and is skipped) read
    their own
    columns of var_T and scale, and per slot k the table lanes [0, wks[k]):
    packed, sources and weights; gathered, the W-index and weights, plus
    each ext column a live lane names (a source in the block's own columns
    is already read).  block_ids and the slot table are read once.  The
    init forms read and write the output at the listed columns only (the
    rest of init is left as it is); the zero-filled forms write the whole
    output they return.  The push reads the send buffers and writes the
    receive buffers once."""
    import torch

    var_T, tbl, *plan = args
    scale, block_ids, slots = plan[-3:]
    P, nv, ndev = var_T.shape
    bp = scale.shape[-1]
    first = torch.ones_like(block_ids, dtype=torch.bool)
    first[:, 1:] = block_ids[:, 1:] != block_ids[:, :-1]
    entries = int(first.sum())
    widths = slots[0].long()
    lanes = entries * int(widths.sum())
    cols = entries * bp
    moved = (cols * (nv * var_T.element_size() + 4)          # own, scale
             + nbytes(block_ids, slots))
    moved += {"": 0, "wsum": cols * 12, "i8_scale": entries * nv * 4}[extra]
    w_bytes = plan[-4].element_size()                        # slot_w
    if gather:        # slot_idx (i32) and slot_w (3 weights) per live lane
        idx = plan[0][first].long()                        # (entries, K, bp)
        live = torch.arange(bp, device=idx.device) < widths[:, None]
        ext = (idx >= bp) & live
        ep = tbl.shape[-1]
        entry = torch.arange(entries, device=idx.device)[:, None, None]
        n_ext = int(torch.unique((entry * ep + idx - bp)[ext]).numel())
        moved += lanes * (4 + 3 * w_bytes) + n_ext * nv * 4
    else:             # sources (NV values or deltas) and 3 weights per lane
        moved += lanes * (nv * tbl.element_size() + 3 * w_bytes)
    rows = nv if op in FLUX_ROWS else 3 * nv
    moved += (2 * cols if init else P * ndev) * rows * out_bytes
    if push is not None:
        moved += 2 * nbytes(push)
    # listed entries whose scale is zero (ghost region, trash block): the
    # plan hands them to the kernel, which reads their operands all the same
    zero = int((scale[first] == 0).flatten(1).all(1).sum())
    return {**bound(moved, lanes * OPS_PER_SLOT_LANE[op] + cols * rows),
            "entries": entries, "zero_scale_entries": zero}


def table_bound(bs, b: dict, args, kw: dict) -> dict:
    """A direct-body call's bound `b` (`sweep_bound`'s, on args = (var_T,
    exts, plan operands...) and the gather keywords kw), and beside it,
    where kw's sources is "table", the bound with the point-major table
    the wrapper builds first: each column the table holds (`table_written`)
    written once and read once, NV f32 each (bound_ms_with_table).  The
    table is the direct body's own intermediate, not the function's, so
    bound_ms (and the row's share) stays the sweep's."""
    var_T, exts = args[:2]
    scale, block_ids = args[-3], args[-2]
    bp, ep = scale.shape[-1], exts.shape[-1]
    sources = kw.get("sources", "columns")
    extra = 0
    if sources == "table":
        cols = int(bs.table_written(block_ids, bp, ep,
                                    kw.get("ext_cnt")).sum())
        extra = 2 * cols * var_T.shape[1] * 4
    return {**b, "bound_ms_with_table": bound(b["bound_bytes"] + extra,
                                              b["bound_ops"])["bound_ms"],
            "table_bytes": extra, "sources": sources}


@contextlib.contextmanager
def gather_body_forced(bs, body: str):
    """The gather wrappers of module bs on one body while the block runs
    (the rule's own pick is what every counted path launches)."""
    rule = bs.gather_body
    bs.gather_body = lambda *args, **kw: body
    try:
        yield
    finally:
        bs.gather_body = rule


def gather_bodies_compared(path: str, bs, args, kw, bodies) -> tuple:
    """K2 on `args` (and keywords kw) under each of `bodies`, forced:
    against the plain version (within K1_TOL of max|plain|) and the first
    body bit for bit, then timed in turns (the bodies in order, then in
    reverse; CUDA-event means of 50 calls).  Returns ({body: {max_abs_err,
    ms (the better turn)}}, {body: [ms of each turn]}); fails on a
    difference."""
    import torch

    want = bs.sweep_blocks_gather_ref(*args)
    scale = float(want.abs().max())
    res, first = {}, None
    for b in bodies:
        with gather_body_forced(bs, b):
            out = bs.sweep_blocks_gather(*args, **kw)
            torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if not err <= K1_TOL * scale:
            fail(f"{path}: the {b} body differs from the plain version: "
                 f"{err:.3e} > {K1_TOL} x {scale:.3e}")
        if first is None:
            first = out
        elif not torch.equal(out, first):
            fail(f"{path}: the {b} and {bodies[0]} bodies differ")
        res[b] = {"max_abs_err": err}
        del out
    del want, first
    ms = {b: [] for b in bodies}
    for b in (*bodies, *reversed(bodies)):
        with gather_body_forced(bs, b):
            ms[b].append(cuda_ms(lambda: bs.sweep_blocks_gather(*args, **kw),
                                 50))
    for b in bodies:
        res[b]["ms"] = min(ms[b])
    return res, ms


def fused_bodies_compared(path: str, bs, model, args, init, sendbufs,
                          bodies) -> tuple:
    """K3's gather form as `model`'s overlap step calls it (its op, live
    ext counts and push: its loopback map, or its peer transport) on the
    interior operands `args`, onto `init` with `sendbufs`, under each of
    `bodies`, forced: grad against the plain version (f32 within K1_TOL of
    max|plain|, bf16 within one bf16 ulp plus that) and recv bit for bit,
    grad and recv bit for bit the first body's; then timed in turns (the
    bodies in order, then in reverse; CUDA-event means of 50 calls onto one
    buffer).  Returns ({body: {max_abs_err, ms (the better turn)}},
    {body: [ms of each turn]}); fails on a difference."""
    import torch

    peer = model.peer
    kw = {"op": model.op, "peer": peer, **model._gather_kw("interior")}
    push = (None, None) if peer is not None else (model.dsts, model.srcs)

    def call(buf):
        g, r = bs.sweep_blocks_overlap_gather(*args, buf, sendbufs, *push,
                                              **kw)
        return g, r.clone()

    g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
        *args, init.clone(), sendbufs, model.dsts, model.srcs, op=model.op)
    want = g_ref.float()
    scale = float(want.abs().max())
    tol = K1_TOL * scale + (bs.bf16_ulp(want) if g_ref.dtype == torch.bfloat16
                            else 0.0)
    res, first = {}, None
    for b in bodies:
        with gather_body_forced(bs, b):
            g, r = call(init.clone())
            torch.cuda.synchronize()
        err = (g.float() - want).abs()
        if not bool((err <= tol).all()) or not torch.equal(r, r_ref):
            fail(f"{path}: K3-gather's {b} body differs from the plain "
                 f"version (grad {float(err.max()):.3e}, max|plain| "
                 f"{scale:.3e}; recv equal {torch.equal(r, r_ref)})")
        if first is None:
            first = (g, r)
        elif not (torch.equal(g, first[0]) and torch.equal(r, first[1])):
            fail(f"{path}: K3-gather's {b} and {bodies[0]} bodies differ")
        res[b] = {"max_abs_err": float(err.max())}
        del g, r, err
    del first, g_ref, r_ref, want
    buf = init.clone()
    ms = {b: [] for b in bodies}
    for b in (*bodies, *reversed(bodies)):
        with gather_body_forced(bs, b):
            ms[b].append(cuda_ms(lambda: bs.sweep_blocks_overlap_gather(
                *args, buf, sendbufs, *push, **kw), 50))
    for b in bodies:
        res[b]["ms"] = min(ms[b])
    return res, ms


def gather_facts(bs, model, cls: str, fused: bool = False,
                 peer: bool = False) -> dict:
    """The gather plan of class cls (EP, the live-EP maximum, the body the
    rule picks for K2, or, fused, for K3's gather form) and that body's
    instance (K2, or K3's loopback or peer form) of the model's op:
    registers, local bytes, shared memory and resident blocks per SM, at
    this plan's shapes and the model's precision."""
    import torch

    from cfd_proxy_tpu_torch.ops import _cuda

    pl = model.plans[cls]
    ep = int(pl["ext_idx"].shape[2])
    body = bs.gather_body(model.bp, ep, model.op, fused)
    return {"ep": ep, "ep_live_max": int(pl["ext_cnt"].max()), "body": body,
            "kernel": gather_kernel_facts(bs, body, model.bp, ep, model.op,
                                          model.w_t, model.grad_t, fused,
                                          peer)}


def gather_kernel_facts(bs, body: str, bp: int, ep: int, op: str = "gg",
                        w_t=None, o_t=None, fused: bool = False,
                        peer: bool = False) -> dict:
    """Registers, local bytes, shared memory and resident blocks per SM of
    the gather instance of `body` (K2, or K3's loopback or peer form) at
    these shapes and dtypes (None: f32); the cluster and quad bodies' at
    `blocksweep.body_threads` threads, with the clusters the card can hold
    at once."""
    import torch

    from cfd_proxy_tpu_torch.ops import _cuda

    smem = {"staged": bs.staged_bytes(bp, ep),
            "cluster": bs.cluster_bytes(bp, ep),
            "quad": bs.quad_bytes(bp, ep)}.get(body, 0)
    code = bs.GATHER_BODY_CODES[body]
    args = (bs.OPS.index(op), int(w_t == torch.bfloat16),
            int(o_t == torch.bfloat16), smem, bs.body_threads(body, bp, ep))
    facts = (_cuda.kernel_info("cfd_overlap_gather_info", int(peer), code,
                               *args) if fused else
             _cuda.kernel_info("cfd_sweep_gather_info", code, 0, *args))
    return {**facts, "dynamic_smem": smem,
            **({"threads": args[-1]} if body in ("cluster", "quad")
               else {})}


def device_profile(model, state, schedule: str, n: int = 20,
                   graph: bool | None = None, detail: bool = False) -> dict:
    """Device time of one step of n chained steps under torch.profiler
    (`step_device_ms` over the window's `kernels`, name: [records, device
    us], and `launches`, name: its records over n, rounded), beside the
    profiled wall time per step, the largest parts, and the records the
    window holds and lacks (`records`, `dropped`).  Late in a long process
    CUPTI drops records, a few a window or half of one; a sum over the
    window divided by n then read low (by one K3 launch in 20, 5 %), the
    per-name means do not.  A run's own copies (the graph runner's copy of
    the state in and out) round to no launch a step.  `device_ms` is None
    when the profiler saw no device activity.  graph: the runner's
    dispatch (`iterate_fn`; None: the model's rule, on the card the step's
    CUDA graphs replayed n times).  detail: also return `kernels` and
    `launches`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = model.iterate_fn(schedule, n, graph=graph)
    args = model.iter_args(state)
    run(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            k = kernels.setdefault(e.key[:96], [0, 0.0])
            k[0] += e.count
            k[1] += us
    launches = {k: round(r / n) for k, (r, _) in kernels.items()
                if round(r / n) > 0}
    parts = {k: kernels[k][1] / kernels[k][0] / 1e3 * c
             for k, c in launches.items()}
    top = dict(sorted(parts.items(), key=lambda kv: -kv[1])[:8])
    device = step_device_ms(kernels, launches)
    return {"device_ms": device if device else None,
            "wall_ms": wall * 1e3 / n, "steps": n,
            "records": sum(r for r, _ in kernels.values()),
            "dropped": sum(max(0, c * n - kernels[k][0])
                           for k, c in launches.items()),
            "top_ms": top,
            **({"kernels": kernels, "launches": launches} if detail else {})}


def step_device_ms(kernels: dict, launches: dict) -> float | None:
    """Device ms of a step that launches `launches` (name: launches a
    step), each launch at its name's mean over a profiled window's
    records (`kernels`, name: [records, device us]); None where the
    window holds no record of a name."""
    if any(k not in kernels for k in launches):
        return None
    return sum(kernels[k][1] / kernels[k][0] / 1e3 * c
               for k, c in launches.items())


def kernel_device_ms(fn, n: int) -> float:
    """Mean device milliseconds per call of n calls of fn that run back to
    back on the card (`utils.devtime.held_device_ms`: a sleep kernel holds
    the stream while the host enqueues all n)."""
    from cfd_proxy_tpu_torch.utils.devtime import held_device_ms

    return held_device_ms(fn, n)


def pack_facts(kw: dict) -> dict:
    """K4's staging at these operands (rows per CUDA block, EP) and the
    instance's registers, local bytes, shared memory and resident blocks
    per SM."""
    from cfd_proxy_tpu_torch.ops import _cuda
    from cfd_proxy_tpu_torch.ops import blocksweep as bs

    ep = kw["ext_idx"].shape[2]
    rows = bs.pack_rows(kw["bp"], ep)
    smem = rows * bs._pack_stride(kw["bp"], ep) * 4
    delta = int(kw.get("src_format") == "bf16d")
    return {"rows": rows, "ep": ep,
            "kernel": {**_cuda.kernel_info("cfd_pack_srcs_info", delta, smem),
                       "dynamic_smem": smem}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this run needs "
              "a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
        from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
        from cfd_proxy_tpu_torch.models import compiled
        from cfd_proxy_tpu_torch.models.gradients import (GreenGaussTorch,
                                                          PSDFluxModel)
        from cfd_proxy_tpu_torch.ops import _cuda
        from cfd_proxy_tpu_torch.ops import blocksweep as bs
        from cfd_proxy_tpu_torch.ops import halo_pack, push, twins, update
        from cfd_proxy_tpu_torch.parallel import launch, workers
        from cfd_proxy_tpu_torch.parallel.transport import (Dist, Loopback,
                                                            Peer)
        from cfd_proxy_tpu_torch.models.gradients_ell import (DTYPES,
                                                              GreenGaussModel)
        from cfd_proxy_tpu_torch.ops.golden import compute_gradients_gg
        from cfd_proxy_tpu_torch.ops.sweep_ell import reduce_bytes, sweep_bulk
        from cfd_proxy_tpu_torch.solver import (golden, solver_mode_defaults,
                                                time_schedule)
        from cfd_proxy_tpu_torch.solver import main as solver_main
        from cfd_proxy_tpu_torch.utils.timing import two_point_sampler
        from cfd_proxy_tpu_torch.tools import (dryrun, icibench, kbench,
                                               scaling_inputs, scaling_model,
                                               solver_attrib)
        from cfd_proxy_tpu_torch.tools import golden as golden_tool
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              f"root of a checkout", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)

    # every kernel instance: (wrapper, its count attribute), by instance
    # name (the rows' names, but for the twins': TWIN_ROWS)
    counters = {**bs.launch_counters(), **twins.launch_counters(),
                **push.launch_counters(), **update.launch_counters(),
                **halo_pack.launch_counters()}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        """The instances launched since reset_counts, with their counts."""
        torch.cuda.synchronize()
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()
                if getattr(fn, attr)}

    launches = dict.fromkeys(KERNELS, 0)    # summed over the counted paths
    # of them, the bench tools' loop iterations (kbench, icibench): what a
    # ranking by launches on the model's paths leaves out
    bench_launches = dict.fromkeys(KERNELS, 0)

    def expect_counts(path, counts, names):
        for k, n in counts.items():
            if k not in launches:
                fail(f"{path} launched {k}, which has no kernel row")
            launches[k] += n
            if path.startswith(("kbench", "icibench", "solver_attrib")):
                bench_launches[k] += n
        missing = [k for k in names if counts.get(k, 0) <= 0]
        if missing:
            fail(f"{path} launched no {missing} kernel")

    def golden_relmax(model, g, scale=1.0, gold=None):
        """Max error against a golden over max(1, max|golden|): by default
        the Green-Gauss golden of scale·gvar (it is linear in the state);
        the flux golden, which is not, is passed in as `gold`."""
        got = model.gather_global(g)
        if gold is None:
            gold = ref if scale == 1.0 else scale * ref
        if got.shape != gold.shape or not np.isfinite(got).all():
            fail(f"output shape {got.shape} (expected {gold.shape}) or "
                 f"non-finite values")
        return float(np.abs(got - gold).max()
                     / max(1.0, float(np.abs(gold).max())))

    def ghost_check(path, model, arr, wire=False):
        """Every ghost column of the (P, rows, ndev) array (a card tensor or
        a host array) equals its owner's column bitwise — with wire, the
        bf16 rounding of the owner's column (a bf16 halo on f32 stores);
        returns the columns checked."""
        if isinstance(arr, torch.Tensor):
            arr = arr.float().cpu().numpy()     # bf16 widens exactly
        nghost = 0
        for i, p in enumerate(model.parts):
            for e in p.comm:
                q = model.parts[e.partner]
                back = [x for x in q.comm
                        if x.partner == p.part_id and x.round == e.round]
                send_cols = model.locmap[e.partner][back[0].sendidx]
                recv_cols = model.locmap[i][e.recvidx]
                if len(send_cols) == 0:
                    continue
                owner = arr[e.partner][:, send_cols]
                if wire:
                    owner = torch.from_numpy(owner).to(
                        torch.bfloat16).float().numpy()
                if not np.array_equal(arr[i][:, recv_cols], owner):
                    fail(f"{path}: ghost columns of shard {i} from "
                         f"{e.partner} round {e.round} differ from the "
                         f"owner's")
                nghost += len(recv_cols)
        if nghost == 0:
            fail(f"{path}: no ghost column to check")
        return nghost

    def owned_scaled(model, var_T, factor):
        """var_T with each shard's owned columns times factor, ghosts
        left stale (a solver's state update)."""
        mask = torch.zeros((len(model.parts), 1, model.ndev), dtype=torch.bool,
                           device=dev)
        for i, p in enumerate(model.parts):
            mask[i, 0, : p.nowned] = True
        return torch.where(mask, var_T * factor, var_T)

    def check_schedules(path, model, outs, gold=None, band=(None, GOLDEN_TOL),
                        cross_tol=SCHED_TOL):
        """Every schedule vs the golden (relmax <= band[1], and > band[0]
        where given: a reduced-precision result must differ from f32);
        early vs bulk, overlap vs early within cross_tol of max|bulk|."""
        lo, hi = band
        rel = {s: golden_relmax(model, g, gold=gold) for s, g in outs.items()}
        f = {s: g.float() for s, g in outs.items()}
        scale = float(f["bulk"].abs().max())
        cross = {
            "early_vs_bulk": float((f["early"] - f["bulk"]).abs().max()),
            "overlap_vs_early": float(
                (f["overlap"] - f["early"]).abs().max())}
        for s, r in rel.items():
            if not (r <= hi and (lo is None or r > lo)):
                fail(f"{path}: {s} vs golden relmax {r:.3e} outside "
                     f"({lo}, {hi}]")
        for k, v in cross.items():
            if not v <= cross_tol * scale:
                fail(f"{path}: {k} {v:.3e} > {cross_tol} x {scale:.3e}")
        return rel, cross, scale

    # ---- device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build (cold: force a compile from the checkout's sources)
    b = _cuda.build(force=True)
    _cuda.lib()
    ptxas = [ln.strip() for ln in b["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=b["seconds"], library=os.path.relpath(b["path"]),
         ptxas=ptxas)

    # ---- host setup
    t0 = time.perf_counter()
    gmesh = generate_mesh(NX, NX, NX, jitter=0.05, diag_frac=0.2, seed=SEED)
    parts = partition_mesh(gmesh, 1)
    gvar = make_state(gmesh.npoint, NVAR, seed=SEED + 1)
    ref = golden("gg", gmesh, gvar)
    emit("mesh", npoint=gmesh.npoint, nface=gmesh.nface,
         seconds=time.perf_counter() - t0)

    # ---- main path, counted: model → state (pack) → bulk step → gather.
    # The model forces the fused overlap kernel (used by the next path);
    # the bulk path does not read that option.
    reset_counts()
    t0 = time.perf_counter()
    model = GreenGaussTorch(parts, NVAR, force_rdma=True, device=dev)
    t_model = time.perf_counter() - t0
    state = model.distribute_state(gvar, schedules=["bulk"])
    relmax = golden_relmax(model, model.step(state, "bulk"))
    counts = read_counts()
    pl = model.plans["bulk"]
    emit("main_path", bp=model.bp, ndev=model.ndev, wks=list(model.wks["bulk"]),
         nblocks=int(pl["block_ids"].shape[1]),
         L=int(pl["src_cols"].shape[2]), model_seconds=t_model,
         bulk_vs_golden_relmax=relmax, tol=GOLDEN_TOL, launches=counts)
    if not relmax <= GOLDEN_TOL:
        fail(f"bulk vs golden relmax {relmax:.3e} > {GOLDEN_TOL}")
    expect_counts("main_path", counts, ("pack_srcs", "sweep_blocks"))

    # ---- kernels vs their plain versions, at the main path's shapes
    var_T = state["var_T"]
    args = (pl["slot_w"], pl["scale"], pl["block_ids"], pl["slots"])
    pk32 = dict(bp=model.bp, **model.pack_operands("bulk"))
    tbl = bs.pack_srcs(var_T, pl["src_cols"], **pk32)
    tbl_ref = bs.pack_srcs_ref(var_T, pl["src_cols"])
    torch.cuda.synchronize()
    errs = {"pack_srcs": float((tbl - tbl_ref).abs().max())}
    out = bs.sweep_blocks(var_T, tbl_ref, *args)
    out_ref = bs.sweep_blocks_ref(var_T, tbl_ref, *args)
    torch.cuda.synchronize()
    errs["sweep_blocks"] = float((out - out_ref).abs().max())
    k1_scale = float(out_ref.abs().max())
    emit("kernels", pack_srcs_max_abs_err=errs["pack_srcs"],
         sweep_blocks_max_abs_err=errs["sweep_blocks"],
         sweep_blocks_max_abs_ref=k1_scale, sweep_blocks_tol=K1_TOL * k1_scale)
    if errs["pack_srcs"] != 0.0:
        fail(f"pack_srcs differs from its plain version "
             f"(max {errs['pack_srcs']})")
    if not errs["sweep_blocks"] <= K1_TOL * k1_scale:
        fail(f"sweep_blocks differs from its plain version: "
             f"{errs['sweep_blocks']:.3e} > {K1_TOL} x {k1_scale:.3e}")

    # the chained update against its plain version, bit for bit, on the
    # P=1 bulk step's state and gradients: f32 and bf16 gradients, gg (24
    # rows) and flux (its first 8 rows as a flux output), into a new tensor
    # and into `out`, at a coupling that moves the state and at the
    # reference's; v never written
    upd_g = {"chain_update": out, "chain_update_g16": out.to(torch.bfloat16)}
    var0 = var_T.clone()
    upd_cases = 0
    for row, g_ in upd_g.items():
        for g_rows in (g_, g_[:, :var_T.shape[1]].contiguous()):
            for c_ in (GRAPH_MOVE, compiled.COUPLING):
                for buf_ in (None, torch.empty_like(var_T)):
                    got_ = update.chain_update(var_T, g_rows, c_, out=buf_)
                    want_ = update.chain_update_ref(var_T, g_rows, c_)
                    torch.cuda.synchronize()
                    if not torch.equal(got_.view(torch.int32),
                                       want_.view(torch.int32)):
                        fail(f"{row} differs from its plain version "
                             f"(rows {g_rows.shape[1]}, coupling {c_}, out "
                             f"{buf_ is not None}): max abs "
                             f"{float((got_ - want_).abs().max()):.3e}")
                    upd_cases += 1
        errs[row] = 0.0
    if not torch.equal(var_T, var0):
        fail("chain_update wrote its input state")
    del var0, got_, want_
    emit("kernels_update", cases=upd_cases, bitwise=True,
         rows=[int(out.shape[1]), int(var_T.shape[1])])

    # bounds; K4's one-call PyTorch counterpart: torch.gather straight
    # into the table's layout (its int64 index made outside the timing)
    P1, nb1, L1 = pl["src_cols"].shape
    work = {"pack_srcs": bound(nbytes(var_T, pl["src_cols"], tbl_ref), 0),
            "sweep_blocks": sweep_bound("gg", (var_T, tbl_ref, *args),
                                        gather=False)}
    idx64 = pl["src_cols"].long()[:, :, None].expand(P1, nb1, var_T.shape[1],
                                                     L1)
    src4 = var_T[:, None].expand(P1, nb1, *var_T.shape[1:])
    if not torch.equal(torch.gather(src4, 3, idx64), tbl_ref):
        fail("torch.gather does not reproduce the packed table")
    library = {"pack_srcs": cuda_ms(lambda: torch.gather(src4, 3, idx64),
                                    50)}
    del idx64, src4
    # the update's bound: v and out f32, g's first NV rows at their width,
    # each once; two operations an element.  Its one-call torch yardstick,
    # torch.add(v, g[:, :NV], alpha=c), rounds the product otherwise (not
    # on the path)
    upd_buf = torch.empty_like(var_T)
    for row, g_ in upd_g.items():
        nv_ = var_T.shape[1]
        work[row] = bound(nbytes(var_T, upd_buf)
                          + var_T.numel() * g_.element_size(),
                          2 * var_T.numel())
        library[row] = cuda_ms(lambda g_=g_: torch.add(
            var_T, g_[:, :nv_], alpha=compiled.COUPLING, out=upd_buf), 50)

    # ---- timing: kernels vs plain (same call, in turns), then the bulk step
    times = {
        "pack_srcs": {**paired_ms(
            lambda: bs.pack_srcs(var_T, pl["src_cols"], **pk32),
            lambda: bs.pack_srcs_ref(var_T, pl["src_cols"])),
            **pack_facts(pk32)},
        "sweep_blocks": paired_ms(
            lambda: bs.sweep_blocks(var_T, tbl, *args),
            lambda: bs.sweep_blocks_ref(var_T, tbl, *args)),
        # the update as the graph runner calls it (into its static buffer)
        **{row: paired_ms(
            lambda g_=g_: update.chain_update(var_T, g_, compiled.COUPLING,
                                              out=upd_buf),
            lambda g_=g_: update.chain_update_ref(var_T, g_,
                                                  compiled.COUPLING,
                                                  out=upd_buf))
           for row, g_ in upd_g.items()}}
    del tbl, tbl_ref, out, out_ref, upd_g, upd_buf
    st = time_schedule(model, state, "bulk", TIMED_STEPS, warmup=2,
                       repeats=5)
    f32_bulk_s = st.median          # reduced_p1's speedup denominator
    nface = gmesh.nface
    emit("timing", card=smi, kernels=dict(times),
         bulk_step_ms=st.median * 1e3,
         bulk_step_ms_all=[t * 1e3 for t in st.times],
         faces_per_sec=nface / st.median, steps=TIMED_STEPS)
    if not np.isfinite(st.median):
        fail("bulk step timing fell below the two-point noise floor")

    def step_parts(path, m, st_, schedule, port_only, fills=0):
        """The step's device parts (`device_profile` over 20 chained steps,
        eager and under the graph the timed loops replay): one launch a
        step of the update kernel, `fills` fill launches (a fill kernel or
        a memset; the overlap step keeps one, its push's receive buffer,
        `sweep_blocks_overlap`), and with port_only no kernel but the
        port's (no multiply, no add)."""
        res_ = {}
        for mode_, graph_ in (("eager", False), ("graph", None)):
            prof_ = device_profile(m, st_, schedule, graph=graph_,
                                   detail=True)
            per_step = prof_.pop("launches")
            del prof_["kernels"]
            upd_ = sum(n_ for k_, n_ in per_step.items()
                       if "chain_update" in k_)
            fills_ = {k_: n_ for k_, n_ in per_step.items()
                      if "Fill" in k_ or k_.startswith("Memset")}
            other_ = [k_ for k_ in per_step if not PORT_KERNEL.search(k_)]
            if (upd_ != 1 or sum(fills_.values()) != fills
                    or (port_only and other_)):
                fail(f"{path} {schedule} ({mode_}): {upd_} update launches "
                     f"a step, fills {fills_}, launches {per_step}")
            res_[mode_] = {**prof_, "launches": per_step}
        return res_

    emit("main_path_profile", card=smi, schedule="bulk",
         parts=step_parts("main_path_profile", model, state, "bulk", True))

    # ---- P=1, every schedule, the fused overlap kernel forced
    reset_counts()
    state = model.distribute_state(gvar)
    outs = {s: model.step(state, s) for s in ("bulk", "early", "overlap")}
    counts = read_counts()
    rel, cross, scale = check_schedules("main_path_p1_all", model, outs)
    emit("main_path_p1_all", force_rdma=True, has_comm=model.has_comm,
         vs_golden_relmax=rel, tol=GOLDEN_TOL, cross=cross, max_abs_bulk=scale,
         cross_tol=SCHED_TOL * scale, launches=counts)
    expect_counts("main_path_p1_all", counts, PACKED)
    del outs
    step_ms = {1: {}, P_MULTI: {}}
    for s in ("bulk", "early", "overlap", "nocomm"):
        st = time_schedule(model, state, s, TIMED_STEPS, warmup=2, repeats=5)
        step_ms[1][s] = st.median * 1e3
    emit("main_path_profile_p1_all", card=smi, schedule="overlap",
         parts=step_parts("main_path_profile_p1_all", model, state,
                          "overlap", False, fills=1))
    packed_models = {1: model}    # timed again in solver mode
    del state

    # ---- P=8 shards on the one card
    t0 = time.perf_counter()
    parts8 = partition_mesh(gmesh, P_MULTI)
    t_part = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    model = GreenGaussTorch(parts8, NVAR, device=dev)
    t_model = time.perf_counter() - t0
    state = model.distribute_state(gvar)
    outs = {s: model.step(state, s)
            for s in ("bulk", "early", "overlap", "nocomm")}
    counts = read_counts()
    rel, cross, scale = check_schedules("main_path_p8", model, outs)
    # every ghost column equals its owner's column, bitwise (early)
    nghost = ghost_check("main_path_p8", model, outs["early"].cpu().numpy())
    # the f32 outputs the bf16-halo model is held to (reduced_p8)
    f32_p8 = {s: outs[s].cpu() for s in ("bulk", "early", "overlap")}
    emit("main_path_p8", parts=P_MULTI, partition_seconds=t_part,
         model_seconds=t_model, bp=model.bp, ndev=model.ndev,
         nphases=model.nphases, s_max=model.s_max,
         wks={c: list(w) for c, w in model.wks.items()},
         vs_golden_relmax=rel, tol=GOLDEN_TOL, cross=cross,
         max_abs_bulk=scale, cross_tol=SCHED_TOL * scale,
         ghost_columns_checked=nghost, launches=counts)
    expect_counts("main_path_p8", counts, PACKED)

    # ---- K1-init and K3 vs their plain versions, at the P=8 shapes
    var_T = state["var_T"]
    tb = state["tables"]
    pi = model.plans["interior"]
    iargs = (var_T, tb["interior"], pi["slot_w"], pi["scale"],
             pi["block_ids"], pi["slots"])
    gb = outs["nocomm"].clone()          # any finite (P, 24, ndev) init
    sendbufs = model._pack(gb, model.pack_scale)
    got = bs.sweep_blocks(*iargs, init=gb.clone())
    want = bs.sweep_blocks_ref(*iargs, init=gb.clone())
    g3, r3 = bs.sweep_blocks_overlap(*iargs, gb.clone(), sendbufs, model.dsts,
                                     model.srcs)
    g3r, r3r = bs.sweep_blocks_overlap_ref(*iargs, gb.clone(), sendbufs,
                                           model.dsts, model.srcs)
    torch.cuda.synchronize()
    errs["sweep_blocks_init"] = float((got - want).abs().max())
    errs["sweep_blocks_overlap"] = float((g3 - g3r).abs().max())
    s_init, s_ovl = float(want.abs().max()), float(g3r.abs().max())
    recv_equal = bool(torch.equal(r3, r3r))
    emit("kernels_p8", sweep_blocks_init_max_abs_err=errs["sweep_blocks_init"],
         sweep_blocks_init_max_abs_ref=s_init,
         sweep_blocks_overlap_max_abs_err=errs["sweep_blocks_overlap"],
         sweep_blocks_overlap_max_abs_ref=s_ovl,
         sweep_blocks_overlap_recv_bitwise=recv_equal,
         recv_max_abs=float(r3r.abs().max()), tol_rel=K1_TOL)
    if not errs["sweep_blocks_init"] <= K1_TOL * s_init:
        fail(f"sweep_blocks (init) differs from its plain version: "
             f"{errs['sweep_blocks_init']:.3e} > {K1_TOL} x {s_init:.3e}")
    if not errs["sweep_blocks_overlap"] <= K1_TOL * s_ovl:
        fail(f"sweep_blocks_overlap grad differs from its plain version: "
             f"{errs['sweep_blocks_overlap']:.3e} > {K1_TOL} x {s_ovl:.3e}")
    if not recv_equal:
        fail("sweep_blocks_overlap recv differs from its plain version")
    del got, want, g3, r3, g3r, r3r, outs
    work["sweep_blocks_init"] = sweep_bound("gg", iargs, gather=False,
                                            init=True)
    work["sweep_blocks_overlap"] = sweep_bound("gg", iargs, gather=False,
                                               init=True, push=sendbufs)

    # ---- timing at P=8: K1-init and K3 vs plain, then every schedule.  The
    # timed calls accumulate onto one buffer again and again; its values
    # stop meaning anything, the bytes moved do not change.
    buf = gb.clone()
    times["sweep_blocks_init"] = paired_ms(
        lambda: bs.sweep_blocks(*iargs, init=buf),
        lambda: bs.sweep_blocks_ref(*iargs, init=buf))
    times["sweep_blocks_overlap"] = paired_ms(
        lambda: bs.sweep_blocks_overlap(*iargs, buf, sendbufs, model.dsts,
                                        model.srcs),
        lambda: bs.sweep_blocks_overlap_ref(*iargs, buf, sendbufs,
                                            model.dsts, model.srcs))
    del buf
    for s in ("bulk", "early", "overlap", "nocomm"):
        st = time_schedule(model, state, s, TIMED_STEPS, warmup=2, repeats=5)
        step_ms[P_MULTI][s] = st.median * 1e3
    bad = [(p, s) for p, d in step_ms.items() for s, v in d.items()
           if not np.isfinite(v)]
    profiles = {"gg": {s: device_profile(model, state, s)
                       for s in ("bulk", "nocomm")}}
    emit("timing_schedules", card=smi, step_ms=step_ms,
         faces_per_sec={p: {s: nface / (v * 1e-3) for s, v in d.items()}
                        for p, d in step_ms.items()},
         kernels=times, steps=TIMED_STEPS, profile_p8=profiles["gg"],
         idle_p8={s: (None if p["device_ms"] is None
                      else 1.0 - p["device_ms"] / step_ms[P_MULTI][s])
                  for s, p in profiles["gg"].items()})
    if bad:
        fail(f"step timing fell below the two-point noise floor: {bad}")
    packed_models[P_MULTI] = model

    # ---- the halo pack (ops/halo_pack.py) against its plain version at
    # the 96³ eight-shard plan: every (source, wire) dtype form, on the
    # gradient rows and the state's, by send_mask and by pack_scale; every
    # lane bit for bit (a pad lane, scale 0, reads zero), one launch a
    # call.  Timed in turns on the overlap step's operands (the boundary
    # sums' 24 rows by pack_scale), each side's calls held behind a sleep
    # kernel: a 7 us kernel launches slower than it runs.  Then the overlap step under graph:
    # one pack launch a step and no torch indexing kernel among the
    # records
    pack_cases = 0
    for row, forms_ in PACK_FORMS.items():
        x_t, w_t = (getattr(torch, f_) for f_ in forms_)
        attr = halo_pack.COUNT_ATTRS[x_t == torch.bfloat16,
                                     w_t == torch.bfloat16]
        iview = torch.int16 if w_t == torch.bfloat16 else torch.int32
        for src_ in (gb, var_T):
            xs_ = src_.to(x_t)
            for sc_ in (model.send_mask, model.pack_scale):
                before_ = getattr(halo_pack.pack_halo, attr)
                got_ = halo_pack.pack_halo(xs_, model.pack_cols, sc_, w_t)
                want_ = halo_pack.pack_halo_ref(xs_, model.pack_cols, sc_,
                                                w_t)
                torch.cuda.synchronize()
                dead_ = (sc_ == 0).expand_as(got_)
                if (getattr(halo_pack.pack_halo, attr) != before_ + 1
                        or not torch.equal(got_.view(iview),
                                           want_.view(iview))
                        or bool((got_[dead_] != 0).any())):
                    fail(f"{row} differs from its plain version (rows "
                         f"{xs_.shape[1]}): max abs "
                         f"{float((got_ - want_).float().abs().max()):.3e}")
                pack_cases += 1
        errs[row] = 0.0
        xs_ = gb.to(x_t)
        times[row] = {**held_paired_ms(
            lambda: halo_pack.pack_halo(xs_, model.pack_cols,
                                        model.pack_scale, w_t),
            lambda: halo_pack.pack_halo_ref(xs_, model.pack_cols,
                                            model.pack_scale, w_t)),
            "kernel": _cuda.kernel_info(
                "cfd_pack_halo_info", int(x_t == torch.bfloat16),
                int(w_t == torch.bfloat16))}
        # the buffer written once; each live lane's source rows, every
        # lane's index and scale read once
        out_b = got_.element_size() * (model.nlocal * model.nphases
                                       * gb.shape[1] * model.s_max)
        work[row] = bound(out_b + model.live_cols * gb.shape[1]
                          * xs_.element_size()
                          + nbytes(model.pack_cols, model.pack_scale), 0)
    del got_, want_, dead_, xs_
    reset_counts()
    prof = device_profile(model, state, "overlap", detail=True)
    counts = read_counts()
    per_step = prof.pop("launches")
    kern_ = prof.pop("kernels")
    packs = {k_: n_ for k_, n_ in per_step.items() if "pack_halo" in k_}
    indexing = [k_ for k_ in kern_ if "index_elementwise" in k_]
    if (sum(packs.values()) != 1 or indexing
            or counts.get("pack_halo") != 2 * prof["steps"]):
        fail(f"kernels_pack: the overlap step under graph launches "
             f"{packs} pack kernels a step, torch indexing {indexing}; the "
             f"counters read {counts}")
    emit("kernels_pack", cases=pack_cases, bitwise=True,
         rows=[int(gb.shape[1]), int(var_T.shape[1])],
         live_cols=model.live_cols,
         wire_cols=model.nlocal * model.nphases * model.s_max,
         overlap_graph={"pack_launches_per_step": packs,
                        "launches_per_step": per_step, **prof},
         times={r: times[r] for r in PACK_FORMS},
         bounds={r: work[r] for r in PACK_FORMS})
    del state, gb, sendbufs, iargs

    # ---- solver mode, the gather kernel: P=1 (fused kernel forced), P=8
    gather_models = {}
    for npart, path in ((1, "solver_p1"), (P_MULTI, "solver_p8")):
        t0 = time.perf_counter()
        gm = GreenGaussTorch(parts if npart == 1 else parts8, NVAR,
                             bp=GATHER_BP, kernel="gather",
                             force_rdma=npart == 1, device=dev)
        t_model = time.perf_counter() - t0
        reset_counts()
        state = gm.distribute_state(gvar)
        scheds = ("bulk", "early", "overlap") + (("nocomm",) if npart > 1
                                                 else ())
        outs = {s: gm.step(state, s) for s in scheds}
        counts = read_counts()
        rel, cross, scale = check_schedules(path, gm, outs)
        expect_counts(path, counts, GATHER)
        if counts.get("pack_srcs", 0):
            fail(f"{path}: the gather model launched the source pack")
        info = {}
        if npart > 1:
            info["step_ghost_columns_checked"] = ghost_check(
                path, gm, outs["early"].cpu().numpy())
        del outs
        # a solver's state update: owned columns x1.5, ghosts stale; the
        # var exchange refreshes them and the next step sees 1.5·gvar
        reset_counts()
        st2 = gm.refresh_state(owned_scaled(gm, state["var_T"], 1.5),
                               schedules=["bulk"])
        rel15 = golden_relmax(gm, gm.step(st2, "bulk"), scale=1.5)
        counts = read_counts()
        expect_counts(path, counts, ("sweep_blocks_gather",))
        if not rel15 <= GOLDEN_TOL:
            fail(f"{path}: bulk after refresh_state vs the golden of "
                 f"1.5·gvar: {rel15:.3e} > {GOLDEN_TOL}")
        if npart > 1:
            info["var_ghost_columns_checked"] = ghost_check(
                path, gm, st2["var_T"].cpu().numpy())
        del st2
        # the solver-mode runner: SOLVER_RUN steps, each rebuilding the
        # bulk ext tables, sweeping once and exchanging the state
        reset_counts()
        v = gm.iterate_fn("bulk", SOLVER_RUN, solver_mode=True)(
            *gm.iter_args(state))
        counts = read_counts()
        expect_counts(path, counts, ("sweep_blocks_gather",))
        if counts.get("sweep_blocks_gather", 0) != SOLVER_RUN:
            fail(f"{path}: {SOLVER_RUN} solver steps launched K2 "
                 f"{counts.get('sweep_blocks_gather', 0)} times")
        if v.shape != state["var_T"].shape or not bool(
                torch.isfinite(v).all()):
            fail(f"{path}: solver-mode state {tuple(v.shape)} or "
                 f"non-finite")
        emit(path, parts=npart, kernel="gather", bp=gm.bp, ndev=gm.ndev,
             model_seconds=t_model,
             ep={c: int(gm.plans[c]["ext_idx"].shape[2]) for c in gm.plans},
             ep_live_max={c: int(gm.plans[c]["ext_cnt"].max())
                          for c in gm.plans},
             body={c: bs.gather_body(gm.bp, int(pl_["ext_idx"].shape[2]))
                   for c, pl_ in gm.plans.items()},
             kslots={c: len(w) for c, w in gm.wks.items()},
             wks={c: list(w) for c, w in gm.wks.items()},
             vs_golden_relmax=rel, tol=GOLDEN_TOL, cross=cross,
             max_abs_bulk=scale, cross_tol=SCHED_TOL * scale,
             refresh_vs_golden_15_relmax=rel15, solver_steps=SOLVER_RUN,
             solver_launches=counts, **info)
        gather_models[npart] = gm
        del state, v

    # ---- the gather kernel at the AUTO block size (4096 at one shard), the
    # body the rule picks there counted; then all three bodies against the
    # plain version and each other, timed in turns (the rule's evidence at
    # one CUDA block per SM)
    reset_counts()
    gm = GreenGaussTorch(parts, NVAR, kernel="gather", device=dev)
    state = gm.distribute_state(gvar, schedules=["bulk"])
    rel_auto = golden_relmax(gm, gm.step(state, "bulk"))
    counts = read_counts()
    auto = gather_facts(bs, gm, "bulk")
    expect_counts("gather_auto_bp", counts, (
        "sweep_blocks_gather" + ("_" + auto["body"]) * (
            auto["body"] != "staged"),))
    if not rel_auto <= GOLDEN_TOL:
        fail(f"gather at bp {gm.bp}: bulk vs golden {rel_auto:.3e}")
    k2a = (state["var_T"], *gm._operands("bulk", state["tables"]))
    kw = gm._gather_kw("bulk")
    bodies, auto_ms = gather_bodies_compared("gather_auto_bp", bs, k2a, kw,
                                             bs.GATHER_BODIES)
    emit("gather_auto_bp", parts=1, bp=gm.bp, ep=auto["ep"],
         ep_live_max=auto["ep_live_max"], body=auto["body"],
         staged_bytes=bs.staged_bytes(gm.bp, auto["ep"]),
         cluster_bytes=bs.cluster_bytes(gm.bp, auto["ep"]),
         kernel=auto["kernel"], bulk_vs_golden_relmax=rel_auto,
         tol=GOLDEN_TOL, launches=counts, card=smi, bodies=bodies,
         turns_ms=auto_ms, bodies_equal_bitwise=True, tol_rel=K1_TOL)
    del gm, state, k2a

    # ---- the gather kernel at bp 8192 (one shard), where the staged table
    # passes one CUDA block's shared memory but half of it fits: the cluster
    # body, counted, then the direct body forced through the same step,
    # counted; both, and the quad body forced, against the plain version and
    # each other, timed in turns (the cluster and direct bodies' kernel-table
    # rows)
    reset_counts()
    gm = GreenGaussTorch(parts, NVAR, kernel="gather", bp=LARGE_BP,
                         device=dev)
    state = gm.distribute_state(gvar, schedules=["bulk"])
    g_rule = gm.step(state, "bulk")
    rel_large = golden_relmax(gm, g_rule)
    counts = read_counts()
    large = gather_facts(bs, gm, "bulk")
    if large["body"] != "cluster":
        fail(f"gather_large_bp: the rule picks {large['body']} at bp "
             f"{gm.bp}, EP {large['ep']}; the kernel table expects cluster")
    expect_counts("gather_large_bp", counts, ("sweep_blocks_gather_cluster",))
    if not rel_large <= GOLDEN_TOL:
        fail(f"gather at bp {gm.bp}: bulk vs golden {rel_large:.3e}")
    reset_counts()
    with gather_body_forced(bs, "direct"):
        g_direct = gm.step(state, "bulk")
    direct_counts = read_counts()
    expect_counts("gather_large_bp (direct, forced)", direct_counts,
                  ("sweep_blocks_gather_direct",))
    if not torch.equal(g_rule, g_direct):
        fail("gather_large_bp: the cluster and direct steps differ")
    del g_rule, g_direct
    k2l = (state["var_T"], *gm._operands("bulk", state["tables"]))
    kw = gm._gather_kw("bulk")
    bodies, large_ms = gather_bodies_compared("gather_large_bp", bs, k2l, kw,
                                              ("cluster", "quad", "direct"))
    want = bs.sweep_blocks_gather_ref(*k2l)
    scale_l = float(want.abs().max())
    scales = {}         # max|plain| per kernel-table row, from here on
    del want
    facts = {b: gather_kernel_facts(bs, b, gm.bp, large["ep"])
             for b in ("cluster", "direct")}
    for b in ("cluster", "direct"):
        row = "sweep_blocks_gather_" + b
        errs[row] = bodies[b]["max_abs_err"]
        scales[row] = scale_l
        work[row] = sweep_bound("gg", k2l, gather=True)
        if b == "direct":
            work[row] = table_bound(bs, work[row], k2l, kw)
        with gather_body_forced(bs, b):
            times[row] = {**paired_ms(
                lambda: bs.sweep_blocks_gather(*k2l, **kw),
                lambda: bs.sweep_blocks_gather_ref(*k2l)),
                "ep": large["ep"], "ep_live_max": large["ep_live_max"],
                "body": b, "kernel": facts[b]}
    emit("gather_large_bp", parts=1, bp=gm.bp, ep=large["ep"],
         ep_live_max=large["ep_live_max"], body=large["body"],
         staged_bytes=bs.staged_bytes(gm.bp, large["ep"]),
         cluster_bytes=bs.cluster_bytes(gm.bp, large["ep"]),
         bulk_vs_golden_relmax=rel_large, tol=GOLDEN_TOL, launches=counts,
         direct_launches=direct_counts, card=smi, bodies=bodies,
         max_abs_ref=scale_l, tol_rel=K1_TOL, turns_ms=large_ms,
         cluster_threads=bs.cluster_threads(gm.bp, large["ep"]),
         bodies_equal_bitwise=True,
         times={b: times["sweep_blocks_gather_" + b]
                for b in ("cluster", "direct")})
    del gm, state, k2l

    # ---- K2, K2-init and K3-gather vs their plain versions: K2 at the P=1
    # bulk shapes, K2-init and K3-gather at the P=8 interior + push
    gm = gather_models[1]
    state = gm.distribute_state(gvar, schedules=["bulk"])
    k2 = (state["var_T"], *gm._operands("bulk", state["tables"]))
    kw = gm._gather_kw("bulk")
    out = bs.sweep_blocks_gather(*k2, **kw)
    out_ref = bs.sweep_blocks_gather_ref(*k2)
    torch.cuda.synchronize()
    errs["sweep_blocks_gather"] = float((out - out_ref).abs().max())
    scales["sweep_blocks_gather"] = float(out_ref.abs().max())
    work["sweep_blocks_gather"] = sweep_bound("gg", k2, gather=True)
    times["sweep_blocks_gather"] = {
        **paired_ms(lambda: bs.sweep_blocks_gather(*k2, **kw),
                    lambda: bs.sweep_blocks_gather_ref(*k2)),
        **gather_facts(bs, gm, "bulk")}
    del out, out_ref, state, k2
    gm = gather_models[P_MULTI]
    state = gm.distribute_state(gvar)
    iargs = (state["var_T"], *gm._operands("interior", state["tables"]))
    kw = gm._gather_kw("interior")
    gb = gm.step(state, "nocomm")               # any finite init
    sendbufs = gm._pack(gb, gm.pack_scale)
    got = bs.sweep_blocks_gather(*iargs, init=gb.clone(), **kw)
    want = bs.sweep_blocks_gather_ref(*iargs, init=gb.clone())
    g3, r3 = bs.sweep_blocks_overlap_gather(*iargs, gb.clone(), sendbufs,
                                            gm.dsts, gm.srcs, **kw)
    g3r, r3r = bs.sweep_blocks_overlap_gather_ref(*iargs, gb.clone(),
                                                  sendbufs, gm.dsts, gm.srcs)
    torch.cuda.synchronize()
    errs["sweep_blocks_gather_init"] = float((got - want).abs().max())
    errs["sweep_blocks_overlap_gather"] = float((g3 - g3r).abs().max())
    scales["sweep_blocks_gather_init"] = float(want.abs().max())
    scales["sweep_blocks_overlap_gather"] = float(g3r.abs().max())
    recv_equal = bool(torch.equal(r3, r3r))
    del got, want, g3, r3, g3r, r3r
    work["sweep_blocks_gather_init"] = sweep_bound("gg", iargs, gather=True,
                                                   init=True)
    work["sweep_blocks_overlap_gather"] = sweep_bound(
        "gg", iargs, gather=True, init=True, push=sendbufs)
    buf = gb.clone()
    times["sweep_blocks_gather_init"] = {
        **paired_ms(lambda: bs.sweep_blocks_gather(*iargs, init=buf, **kw),
                    lambda: bs.sweep_blocks_gather_ref(*iargs, init=buf)),
        **gather_facts(bs, gm, "interior")}
    times["sweep_blocks_overlap_gather"] = {
        **paired_ms(
            lambda: bs.sweep_blocks_overlap_gather(*iargs, buf, sendbufs,
                                                   gm.dsts, gm.srcs, **kw),
            lambda: bs.sweep_blocks_overlap_gather_ref(*iargs, buf, sendbufs,
                                                       gm.dsts, gm.srcs)),
        **gather_facts(bs, gm, "interior", fused=True)}
    emit("kernels_gather", card=smi,
         max_abs_err={k: errs[k] for k in GATHER}, max_abs_ref=scales,
         tol_rel=K1_TOL, sweep_blocks_overlap_gather_recv_bitwise=recv_equal,
         times={k: times[k] for k in GATHER})
    for k in GATHER:
        if not errs[k] <= K1_TOL * scales[k]:
            fail(f"{k} differs from its plain version: {errs[k]:.3e} > "
                 f"{K1_TOL} x {scales[k]:.3e}")
    if not recv_equal:
        fail("sweep_blocks_overlap_gather recv differs from its plain "
             "version")
    del buf, gb, sendbufs, iargs, state

    # ---- solver-mode step, bulk: gather/bp 512 against packed/AUTO at 1,
    # 2 and 4 sweeps per step, P=1 and P=8 (the crossover the CLI default
    # is decided from); the launches per step of one counted run each
    solver_ms, per_step = {}, {}
    configs = {"gather_bp512": gather_models, "packed_auto": packed_models}
    for npart in (1, P_MULTI):
        for name, ms in configs.items():
            m = ms[npart]
            state = m.distribute_state(gvar, schedules=["bulk"])
            for n in SWEEPS:
                key = f"P{npart}/{name}/N{n}"
                st = time_schedule(m, state, "bulk", SOLVER_STEPS, warmup=1,
                                   repeats=3, solver_mode=True,
                                   sweeps_per_step=n)
                solver_ms[key] = {"bp": m.bp, "step_ms": st.median * 1e3,
                                  "sweep_ms": st.median * 1e3 / n,
                                  "step_ms_all": [t * 1e3 for t in st.times]}
                reset_counts()
                m.iterate_fn("bulk", SOLVER_RUN, solver_mode=True,
                             sweeps_per_step=n)(*m.iter_args(state))
                counts = read_counts()
                per_step[key] = {k: c / SOLVER_RUN
                                 for k, c in counts.items() if c}
                sweep = ("sweep_blocks_gather" if m.kernel == "gather"
                         else "sweep_blocks")
                want = {sweep: float(n), "chain_update": float(n)}
                if m.kernel == "packed":
                    want["pack_srcs"] = 1.0   # one rebuilt class (bulk)
                if npart > 1:     # each sweep's exchange, the var exchange
                    want["pack_halo"] = float(n + 1)
                if per_step[key] != want:
                    fail(f"solver_mode_timing {key}: launches per step "
                         f"{per_step[key]}, expected {want}")
            del state
    bad = [k for k, v in solver_ms.items() if not np.isfinite(v["step_ms"])]
    emit("solver_mode_timing", card=smi, steps=SOLVER_STEPS,
         solver_ms=solver_ms, launches_per_step=per_step,
         defaults={n: solver_mode_defaults(n) for n in SWEEPS},
         faster={f"P{p}/N{n}": min(configs, key=lambda c: solver_ms[
             f"P{p}/{c}/N{n}"]["step_ms"]) for p in (1, P_MULTI)
             for n in SWEEPS})
    if bad:
        fail(f"solver-mode timing fell below the two-point noise floor: "
             f"{bad}")
    del configs, m      # the models stay: the peer phases hold their results
    # against these same plans

    ulp_stats = {}

    def compare_and_time(name, kern, plain, init=None, push=False):
        """Kernel `name` against its plain version on the same operands:
        an f32 output within K1_TOL of max|plain|; a bf16 output elementwise
        within one bf16 ulp of plain plus K1_TOL of max|plain| (FMA
        contraction moves the f32 sum, which can cross a rounding boundary;
        how many elements differ and by how many ulps is kept); the pushed
        buffers bitwise.  Then both timed in turns.  kern/plain take the
        init tensor (None without) and return the output, or (grad, recv)
        for a fused push.  The timed calls accumulate onto one buffer again
        and again; its values stop meaning anything, the bytes moved do not
        change."""
        got = kern(None if init is None else init.clone())
        want = plain(None if init is None else init.clone())
        torch.cuda.synchronize()
        if push:
            (got, recv), (want, recv_ref) = got, want
            if not torch.equal(recv, recv_ref):
                fail(f"{name} recv differs from its plain version")
        if got.dtype != want.dtype:
            fail(f"{name}: dtype {got.dtype}, plain {want.dtype}")
        w = want.float()
        diff = (got.float() - w).abs()
        errs[name] = float(diff.max())
        scales[name] = float(w.abs().max())
        if got.dtype == torch.bfloat16:
            ulp = bs.bf16_ulp(w)
            bad = int((diff > ulp + K1_TOL * scales[name]).sum())
            ulp_stats[name] = {
                "elements_differing": int((diff > 0).sum()),
                "elements": diff.numel(),
                "max_ulps": float((diff / ulp.clamp_min(1e-38)).max()),
                "over_2e-8_rel": int((diff > 2.0 ** -8 * w.abs()
                                      + K1_TOL * scales[name]).sum())}
            if bad:
                fail(f"{name} differs from its plain version by more than "
                     f"one bf16 ulp at {bad} elements")
        elif not errs[name] <= K1_TOL * scales[name]:
            fail(f"{name} differs from its plain version: {errs[name]:.3e} "
                 f"> {K1_TOL} x {scales[name]:.3e}")
        del got, want, w, diff
        buf = None if init is None else init.clone()
        times[name] = paired_ms(lambda: kern(buf), lambda: plain(buf))

    def kernel_summary(names):
        return {k: {"max_abs_err": errs[k], "max_abs_ref": scales[k],
                    **ulp_stats.get(k, {}), **times[k], **work[k]}
                for k in names}

    # ---- K3's gather form at large block sizes, on the cluster body: the
    # gather model's overlap step at P=1 `all` with force_rdma at the AUTO
    # bp (4096) and at LARGE_BP, at P=2 AUTO, through the peer transport at
    # P=2 AUTO (bit for bit the loopback step), and at P=1 LARGE_BP under
    # flux and under bf16 weights, stores and halo (K3_CLUSTER_CFGS); on the
    # quad body at P=2 LARGE_BP, loopback and peer (K3_QUAD_CFGS).  Each
    # model's bulk, early and overlap steps counted (the cluster instance
    # among them) and held against the golden of its op (the bf16 one
    # inside BAND_FULL) and across schedules; its overlap step under each
    # other body the fused kernel has there whose table (or share) fits
    # one block, and direct, forced, bit for bit the rule's; the fused call
    # at the interior + push shapes under each body against the plain
    # version and bit for bit, timed in turns.  The kernel-table rows:
    # K3-gather's cluster instances at P=1 LARGE_BP (the peer one at P=2
    # AUTO), its direct body forced there, the K2 cluster instances these
    # paths launch, and the quad instances of P=2 LARGE_BP (K2 bulk, K2-init
    # boundary, K3-gather loopback and peer; the flux golden is the flux
    # phases' too)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    flux_ref = golden("flux", gmesh, gvar)
    t_gold = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts2 = partition_mesh(gmesh, 2)
    t_part2 = time.perf_counter() - t0

    def fused_row(row, m, st_, gb, sendbufs, body=None):
        """Kernel-table row `row`: K3-gather as m's overlap step calls it
        (under `body`, forced, else the rule's) against its plain version,
        timed in turns, its bound and facts."""
        iargs = (st_["var_T"], *m._operands("interior", st_["tables"]))
        push = (None, None) if m.peer is not None else (m.dsts, m.srcs)
        kw = {"op": m.op, "peer": m.peer, **m._gather_kw("interior")}

        def kern(i):
            with (gather_body_forced(bs, body) if body
                  else contextlib.nullcontext()):
                return bs.sweep_blocks_overlap_gather(*iargs, i, sendbufs,
                                                      *push, **kw)

        compare_and_time(
            row, kern, lambda i: bs.sweep_blocks_overlap_gather_ref(
                *iargs, i, sendbufs, m.dsts, m.srcs, op=m.op),
            init=gb, push=True)
        work[row] = sweep_bound(m.op, iargs, gather=True, init=True,
                                push=sendbufs, out_bytes=gb.element_size())
        facts_ = gather_facts(bs, m, "interior", fused=True,
                              peer=m.peer is not None)
        if (body or facts_["body"]) == "direct":
            work[row] = table_bound(bs, work[row], iargs, kw)
        if body:
            facts_.update(body=body, kernel=gather_kernel_facts(
                bs, body, m.bp, facts_["ep"], m.op, m.w_t, m.grad_t, True,
                m.peer is not None))
        times[row].update(bp=m.bp, **facts_)

    def k2_row(row, m, st_, cls, init=None):
        """Kernel-table row `row`: K2 (with init: its init form) on m's
        class cls, against its plain version, timed in turns."""
        args_ = (st_["var_T"], *m._operands(cls, st_["tables"]))
        kw = {"op": m.op, "out_dtype": m.grad_t}
        compare_and_time(
            row, lambda i: bs.sweep_blocks_gather(
                *args_, init=i, **kw, **m._gather_kw(cls)),
            lambda i: bs.sweep_blocks_gather_ref(*args_, init=i, **kw),
            init=init)
        work[row] = sweep_bound(
            m.op, args_, gather=True, init=init is not None,
            out_bytes=2 if m.grad_t == torch.bfloat16 else 4)
        facts_ = gather_facts(bs, m, cls)
        if facts_["body"] == "direct":
            work[row] = table_bound(bs, work[row], args_,
                                    m._gather_kw(cls))
        times[row].update(bp=m.bp, **facts_)

    def table_row(row, m, st_, cls):
        """Kernel-table row `row`: the direct body's table of m's class cls
        (`gather_table`) against its plain version, bit for bit on the
        columns it writes, timed in turns; bound: those columns read and
        written once."""
        args_ = (st_["var_T"], *m._operands(cls, st_["tables"]))
        var_T_, exts_, block_ids_ = args_[0], args_[1], args_[-2]
        cnt = m._gather_kw(cls).get("ext_cnt")
        ep_ = exts_.shape[-1]

        def kern():
            return bs.gather_table(var_T_, exts_, block_ids_, m.bp,
                                   ext_cnt=cnt)

        def plain():
            return bs.gather_table_ref(var_T_, exts_, block_ids_, m.bp)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        mask = bs.table_written(block_ids_, m.bp, ep_, cnt).to(dev)
        if not torch.equal(got[mask], want[mask]):
            fail(f"{row} differs from its plain version on the columns "
                 f"it writes")
        errs[row] = 0.0
        scales[row] = float(want[mask].abs().max())
        cols = int(mask.sum())
        del got, want, mask
        times[row] = {**paired_ms(kern, plain), "bp": m.bp, "ep": ep_,
                      "columns": cols,
                      "kernel": _cuda.kernel_info("cfd_gather_table_info")}
        work[row] = bound(2 * cols * var_T_.shape[1] * 4
                          + nbytes(block_ids_, cnt), 0)

    k3_info, k3_rows, k3_models, loop_overlap = {}, [], {}, {}
    for name, (nparts, opts) in {**K3_CLUSTER_CFGS, **K3_QUAD_CFGS,
                                 **K3_DIRECT_CFGS}.items():
        path = "k3_gather_" + name
        rule_body = ("quad" if name in K3_QUAD_CFGS
                     else "direct" if name in K3_DIRECT_CFGS else "cluster")
        bf = opts.get("grad_dtype") == BF
        reset_counts()
        t0 = time.perf_counter()
        m = GreenGaussTorch(parts2 if nparts == 2 else parts, NVAR,
                            kernel="gather", device=dev, **opts)
        t_model = time.perf_counter() - t0
        st_ = m.distribute_state(gvar)
        outs = {s: m.step(st_, s) for s in ("bulk", "early", "overlap")}
        counts = read_counts()
        rel, cross, scale = check_schedules(
            path, m, outs, gold=flux_ref if m.op == "flux" else None,
            band=BAND_FULL if bf else (None, GOLDEN_TOL),
            cross_tol=SCHED_TOL_BF16 if bf else SCHED_TOL)
        peer = m.peer is not None
        fused = gather_facts(bs, m, "interior", fused=True, peer=peer)
        inst = ("sweep_blocks_overlap_gather" + "_peer" * peer
                + "_flux" * (m.op == "flux") + "_w16_o16" * bf + "_"
                + rule_body)
        if fused["body"] != rule_body:
            fail(f"{path}: the rule picks {fused['body']} for K3-gather at "
                 f"bp {m.bp}, EP {fused['ep']}; the phase expects "
                 f"{rule_body}")
        k2_insts = ()
        if rule_body != "cluster":  # every class of the plan on that body
            for cls in ("bulk", "boundary"):
                if gather_facts(bs, m, cls)["body"] != rule_body:
                    fail(f"{path}: the rule does not pick {rule_body} for "
                         f"K2 on the {cls} plan")
            tag = "_flux" * (m.op == "flux")
            k2_insts = (f"sweep_blocks_gather{tag}_{rule_body}",
                        f"sweep_blocks_gather{tag}_init_{rule_body}")
            if (rule_body == "direct"
                    and m.sources["interior"] == "table"):
                k2_insts += ("gather_table",)
        expect_counts(path, counts, (inst, *k2_insts))
        info = {"parts": nparts, "bp": m.bp, "ndev": m.ndev,
                "nphases": m.nphases, "s_max": m.s_max,
                "model_seconds": t_model, "transport": m.transport_name,
                "interior": fused, "vs_golden_relmax": rel,
                "band": BAND_FULL if bf else (None, GOLDEN_TOL),
                "cross": cross, "max_abs_bulk": scale,
                "cross_tol": (SCHED_TOL_BF16 if bf else SCHED_TOL) * scale,
                "launches": counts}
        if not peer:
            loop_overlap[name] = outs["overlap"]     # the peer step's twin
        else:
            twin = name[:-len("_peer")]
            if not torch.equal(outs["overlap"], loop_overlap.pop(twin)):
                fail(f"{path}: the peer overlap step differs from the "
                     f"loopback one (k3_gather_{twin})")
            info["overlap_equals_loopback_bitwise"] = True
        # the overlap step under each other body whose table (or its
        # share) fits one block, forced: bit for bit the rule's
        ep = fused["ep"]
        fits = {"staged": bs.staged_bytes, "cluster": bs.cluster_bytes,
                "quad": bs.quad_bytes}
        bodies = (rule_body,) + tuple(
            b for b in bs.GATHER_BODIES if b != rule_body
            and (b == "direct" or fits[b](m.bp, ep) <= bs.GATHER_STAGE_MAX))
        for b in bodies[1:]:
            reset_counts()
            with gather_body_forced(bs, b):
                g_b = m.step(st_, "overlap")
            forced = read_counts()
            want_b = inst.replace("_" + rule_body, "_" + b).replace(
                "_staged", "")
            if forced.get(want_b, 0) != 1:
                fail(f"{path}: the overlap step forced onto the {b} body "
                     f"launched {forced}")
            if not torch.equal(g_b, outs["overlap"]):
                fail(f"{path}: the overlap step on the {b} body differs "
                     f"from the {rule_body} body's")
            if name == "p1_all_large" and b == "direct":
                expect_counts(path + " (direct, forced)", {want_b: 1},
                              (want_b,))
            del g_b
        info["overlap_forced_bodies_equal_bitwise"] = list(bodies)
        # the fused call under each body at the interior + push shapes
        gb = outs["bulk"].clone()                # any finite init
        sendbufs = m._pack(gb, m.pack_scale, m.halo_t)
        iargs = (st_["var_T"], *m._operands("interior", st_["tables"]))
        res, turns = fused_bodies_compared(path, bs, m, iargs, gb, sendbufs,
                                           bodies)
        info.update(card=smi, bodies=res, turns_ms=turns,
                    bound=sweep_bound(m.op, iargs, gather=True, init=True,
                                      push=sendbufs,
                                      out_bytes=gb.element_size()),
                    bodies_equal_bitwise=True, tol_rel=K1_TOL,
                    facts={b: gather_kernel_facts(bs, b, m.bp, ep, m.op,
                                                  m.w_t, m.grad_t, True, peer)
                           for b in bodies},
                    **{f"{b}_over_{rule_body}":
                       res[b]["ms"] / res[rule_body]["ms"]
                       for b in bodies[1:]})
        if peer:
            # the peer launch beside its loopback form on the same
            # operands, in turns (loopback, peer, peer, loopback), the
            # better of each side's turns under the K3-peer rows' gate
            buf = gb.clone()
            kw = {"op": m.op, **m._gather_kw("interior")}
            kp = lambda: bs.sweep_blocks_overlap_gather(
                *iargs, buf, sendbufs, None, None, peer=m.peer, **kw)
            kl = lambda: bs.sweep_blocks_overlap_gather(
                *iargs, buf, sendbufs, m.dsts, m.srcs, **kw)
            turns_ = {"loopback": [], "peer": []}
            for side in ("loopback", "peer", "peer", "loopback"):
                turns_[side].append(cuda_ms(kl if side == "loopback" else kp,
                                            50))
            ratio = min(turns_["peer"]) / min(turns_["loopback"])
            info.update(peer_ms=min(turns_["peer"]),
                        loopback_ms=min(turns_["loopback"]),
                        peer_over_loopback=ratio, peer_turns_ms=turns_)
            if ratio > PEER_OVER_LOOPBACK:
                fail(f"{path}: the peer {rule_body} launch took "
                     f"{ratio:.4f}x its loopback form, above "
                     f"{PEER_OVER_LOOPBACK}")
            del buf, kp, kl
        del iargs
        if name == "p1_all_large":
            fused_row(inst, m, st_, gb, sendbufs)
            fused_row("sweep_blocks_overlap_gather_direct", m, st_, gb,
                      sendbufs, body="direct")
            k2_row("sweep_blocks_gather_init_cluster", m, st_, "interior",
                   gb)
            k3_rows += [inst, "sweep_blocks_overlap_gather_direct",
                        "sweep_blocks_gather_init_cluster"]
        elif name == "p2_large":
            fused_row(inst, m, st_, gb, sendbufs)
            k2_row("sweep_blocks_gather_quad", m, st_, "bulk")
            k2_row("sweep_blocks_gather_init_quad", m, st_, "boundary",
                   torch.zeros_like(gb))
            k3_rows += [inst, "sweep_blocks_gather_quad",
                        "sweep_blocks_gather_init_quad"]
        elif name == "p2_large_flux":
            # K3-gather's loopback flux direct instance is the eight-shard
            # row (flux_p8); here its times and bound are in `turns_ms`,
            # `bodies` and `bound`
            k2_row("sweep_blocks_gather_flux_direct", m, st_, "bulk")
            k2_row("sweep_blocks_gather_flux_init_direct", m, st_,
                   "boundary", torch.zeros_like(gb))
            table_row("gather_table", m, st_, "bulk")
            k3_rows += ["sweep_blocks_gather_flux_direct",
                        "sweep_blocks_gather_flux_init_direct",
                        "gather_table"]
        elif name in ("p2_auto_peer", "p2_large_peer", "p1_all_large_flux",
                      "p1_all_large_w16_o16", "p2_large_flux_peer"):
            fused_row(inst, m, st_, gb, sendbufs)
            k3_rows.append(inst)
            if not peer:
                tag = "_flux" if m.op == "flux" else ""
                tag16 = "_w16_o16" * bf
                k2_row(f"sweep_blocks_gather{tag}{tag16}_cluster", m, st_,
                       "bulk")
                k2_row(f"sweep_blocks_gather{tag}_init{tag16}_cluster", m,
                       st_, "interior", gb)
                k3_rows += [f"sweep_blocks_gather{tag}{tag16}_cluster",
                            f"sweep_blocks_gather{tag}_init{tag16}_cluster"]
        k3_info[name] = info
        del outs, gb, sendbufs, st_
        if name in ("p2_auto", "p2_large", "p2_large_flux"):
            k3_models[name] = m         # the graph phase's P=2 overlap steps
        else:
            m.close()
        del m
    torch.cuda.empty_cache()
    emit("k3_gather_large_bp", card=smi, configs=k3_info,
         partition_seconds=t_part2, golden_flux_seconds=t_gold,
         kernels=kernel_summary(k3_rows),
         phase_s=time.perf_counter() - t_phase)

    # ---- flux, one shard: the PSD upwind flux model (bench.py's secondary
    # row: packed, AUTO bp, bulk) on the same mesh and state, against the
    # f64 compute_psd_flux golden (not linear in the state: each state
    # checked here gets its own golden; this one, flux_ref, was computed
    # above); then every schedule with the fused overlap kernel forced
    reset_counts()
    t0 = time.perf_counter()
    fm = PSDFluxModel(parts, NVAR, force_rdma=True, device=dev)
    t_model = time.perf_counter() - t0
    state = fm.distribute_state(gvar, schedules=["bulk"])
    relf = golden_relmax(fm, fm.step(state, "bulk"), gold=flux_ref)
    counts = read_counts()
    expect_counts("flux_p1", counts, ("pack_srcs", "sweep_blocks_flux"))
    if not relf <= GOLDEN_TOL:
        fail(f"flux_p1: bulk vs the flux golden relmax {relf:.3e} > "
             f"{GOLDEN_TOL}")
    bulk_counts = counts
    st = time_schedule(fm, state, "bulk", TIMED_STEPS, warmup=2, repeats=5)
    if not np.isfinite(st.median):
        fail("flux_p1: bulk step timing fell below the two-point noise floor")
    flux_p1_s = st.median           # reduced_flux's speedup denominator
    k1f = (state["var_T"], *fm._operands("bulk", state["tables"]))
    compare_and_time("sweep_blocks_flux",
                     lambda i: bs.sweep_blocks(*k1f, op="flux"),
                     lambda i: bs.sweep_blocks_ref(*k1f, op="flux"))
    work["sweep_blocks_flux"] = sweep_bound("flux", k1f, gather=False)
    del state, k1f
    reset_counts()
    state = fm.distribute_state(gvar)
    outs = {s: fm.step(state, s) for s in ("bulk", "early", "overlap")}
    counts = read_counts()
    rel, cross, scale = check_schedules("flux_p1", fm, outs, gold=flux_ref)
    expect_counts("flux_p1", counts, FLUX_PACKED)
    emit("flux_p1", card=smi, parts=1, kernel="packed", bp=fm.bp,
         ndev=fm.ndev, wks=list(fm.wks["bulk"]), model_seconds=t_model,
         golden_seconds=t_gold, bulk_vs_golden_relmax=relf, tol=GOLDEN_TOL,
         launches=bulk_counts, bulk_step_ms=st.median * 1e3,
         bulk_step_ms_all=[t * 1e3 for t in st.times],
         faces_per_sec=nface / st.median, steps=TIMED_STEPS,
         all_force_rdma={"vs_golden_relmax": rel, "cross": cross,
                         "max_abs_bulk": scale,
                         "cross_tol": SCHED_TOL * scale, "launches": counts},
         kernels=kernel_summary(["sweep_blocks_flux"]))
    graph_models = {"flux_p1": fm}      # timed again by the graph phase
    del outs, state, fm

    # ---- flux, 8 shards: every schedule under the packed kernel, then
    # the gather kernel at bp 512 in solver mode
    reset_counts()
    t0 = time.perf_counter()
    fm = PSDFluxModel(parts8, NVAR, device=dev)
    t_model = time.perf_counter() - t0
    state = fm.distribute_state(gvar)
    outs = {s: fm.step(state, s)
            for s in ("bulk", "early", "overlap", "nocomm")}
    counts = read_counts()
    rel, cross, scale = check_schedules("flux_p8", fm, outs, gold=flux_ref)
    nghost = ghost_check("flux_p8", fm, outs["early"].cpu().numpy())
    expect_counts("flux_p8", counts, FLUX_PACKED)
    packed_info = {"bp": fm.bp, "model_seconds": t_model,
                   "vs_golden_relmax": rel, "cross": cross,
                   "max_abs_bulk": scale, "cross_tol": SCHED_TOL * scale,
                   "ghost_columns_checked": nghost, "launches": counts}
    iargs = (state["var_T"], *fm._operands("interior", state["tables"]))
    gb = outs["nocomm"].clone()          # any finite (P, NV, ndev) init
    sendbufs = fm._pack(gb, fm.pack_scale)
    del outs
    compare_and_time(
        "sweep_blocks_flux_init",
        lambda i: bs.sweep_blocks(*iargs, init=i, op="flux"),
        lambda i: bs.sweep_blocks_ref(*iargs, init=i, op="flux"), init=gb)
    compare_and_time(
        "sweep_blocks_overlap_flux",
        lambda i: bs.sweep_blocks_overlap(*iargs, i, sendbufs, fm.dsts,
                                          fm.srcs, op="flux"),
        lambda i: bs.sweep_blocks_overlap_ref(*iargs, i, sendbufs, fm.dsts,
                                              fm.srcs, op="flux"),
        init=gb, push=True)
    work["sweep_blocks_flux_init"] = sweep_bound("flux", iargs, gather=False,
                                                 init=True)
    work["sweep_blocks_overlap_flux"] = sweep_bound(
        "flux", iargs, gather=False, init=True, push=sendbufs)
    del iargs, gb, sendbufs
    flux_ms = {}
    for s in ("bulk", "early", "overlap", "nocomm"):
        st = time_schedule(fm, state, s, TIMED_STEPS, warmup=2, repeats=5)
        flux_ms[s] = st.median * 1e3
    profiles["flux"] = {s: device_profile(fm, state, s) for s in flux_ms}
    del state, fm

    t0 = time.perf_counter()
    gm = PSDFluxModel(parts8, NVAR, bp=GATHER_BP, kernel="gather",
                      device=dev)
    t_model = time.perf_counter() - t0
    reset_counts()
    state = gm.distribute_state(gvar)
    outs = {s: gm.step(state, s) for s in ("bulk", "early", "overlap")}
    counts = read_counts()
    rel, cross, scale = check_schedules("flux_p8", gm, outs, gold=flux_ref)
    expect_counts("flux_p8", counts, FLUX_GATHER)
    if counts.get("pack_srcs", 0):
        fail("flux_p8: the gather model launched the source pack")
    gather_info = {"bp": gm.bp, "model_seconds": t_model,
                   "plans": {c: gather_facts(bs, gm, c) for c in gm.plans},
                   "vs_golden_relmax": rel, "cross": cross,
                   "max_abs_bulk": scale, "cross_tol": SCHED_TOL * scale,
                   "step_ghost_columns_checked": ghost_check(
                       "flux_p8", gm, outs["early"].cpu().numpy()),
                   "launches": counts}
    del outs
    # a solver's state update: owned columns x1.5 on the card, ghosts
    # stale; the var exchange refreshes them, and the next step is checked
    # against the golden of that state, computed anew
    reset_counts()
    st2 = gm.refresh_state(owned_scaled(gm, state["var_T"], 1.5),
                           schedules=["bulk"])
    gold15 = golden("flux", gmesh, gvar.astype(np.float32) * np.float32(1.5))
    rel15 = golden_relmax(gm, gm.step(st2, "bulk"), gold=gold15)
    counts = read_counts()
    expect_counts("flux_p8", counts, ("sweep_blocks_gather_flux",))
    if not rel15 <= GOLDEN_TOL:
        fail(f"flux_p8: bulk after refresh_state vs the flux golden of "
             f"1.5·gvar: {rel15:.3e} > {GOLDEN_TOL}")
    gather_info["refresh_vs_golden_15_relmax"] = rel15
    gather_info["var_ghost_columns_checked"] = ghost_check(
        "flux_p8", gm, st2["var_T"].cpu().numpy())
    del st2, gold15
    reset_counts()
    v = gm.iterate_fn("bulk", SOLVER_RUN, solver_mode=True)(
        *gm.iter_args(state))
    counts = read_counts()
    expect_counts("flux_p8", counts, ("sweep_blocks_gather_flux",))
    if counts.get("sweep_blocks_gather_flux", 0) != SOLVER_RUN:
        fail(f"flux_p8: {SOLVER_RUN} solver steps launched K2-flux "
             f"{counts.get('sweep_blocks_gather_flux', 0)} times")
    if v.shape != state["var_T"].shape or not bool(torch.isfinite(v).all()):
        fail(f"flux_p8: solver-mode state {tuple(v.shape)} or non-finite")
    gather_info["solver_launches"] = counts
    del v
    st = time_schedule(gm, state, "bulk", SOLVER_STEPS, warmup=1, repeats=3,
                       solver_mode=True)
    solver_step = {"step_ms": st.median * 1e3,
                   "step_ms_all": [t * 1e3 for t in st.times],
                   "faces_per_sec": nface / st.median, "steps": SOLVER_STEPS}
    if not np.isfinite(st.median):
        fail("flux_p8: solver step timing fell below the noise floor")
    # K2-flux at the bulk shapes, K2-flux-init and K3-gather-flux at the
    # interior + push shapes, against their plain versions
    k2f = (state["var_T"], *gm._operands("bulk", state["tables"]))
    kw = gm._gather_kw("bulk")
    compare_and_time("sweep_blocks_gather_flux",
                     lambda i: bs.sweep_blocks_gather(*k2f, op="flux", **kw),
                     lambda i: bs.sweep_blocks_gather_ref(*k2f, op="flux"))
    work["sweep_blocks_gather_flux"] = sweep_bound("flux", k2f, gather=True)
    times["sweep_blocks_gather_flux"].update(gather_facts(bs, gm, "bulk"))
    del k2f
    iargs = (state["var_T"], *gm._operands("interior", state["tables"]))
    kw = gm._gather_kw("interior")
    gb = gm.step(state, "nocomm")               # any finite init
    sendbufs = gm._pack(gb, gm.pack_scale)
    compare_and_time(
        "sweep_blocks_gather_flux_init",
        lambda i: bs.sweep_blocks_gather(*iargs, init=i, op="flux", **kw),
        lambda i: bs.sweep_blocks_gather_ref(*iargs, init=i, op="flux"),
        init=gb)
    compare_and_time(
        "sweep_blocks_overlap_gather_flux_direct",
        lambda i: bs.sweep_blocks_overlap_gather(*iargs, i, sendbufs, gm.dsts,
                                                 gm.srcs, op="flux", **kw),
        lambda i: bs.sweep_blocks_overlap_gather_ref(
            *iargs, i, sendbufs, gm.dsts, gm.srcs, op="flux"),
        init=gb, push=True)
    work["sweep_blocks_gather_flux_init"] = sweep_bound(
        "flux", iargs, gather=True, init=True)
    work["sweep_blocks_overlap_gather_flux_direct"] = table_bound(
        bs, sweep_bound("flux", iargs, gather=True, init=True,
                        push=sendbufs), iargs, kw)
    times["sweep_blocks_gather_flux_init"].update(
        gather_facts(bs, gm, "interior"))
    times["sweep_blocks_overlap_gather_flux_direct"].update(
        gather_facts(bs, gm, "interior", fused=True))
    del iargs, gb, sendbufs, state, gm
    bad = [s for s, v in flux_ms.items() if not np.isfinite(v)]
    emit("flux_p8", card=smi, parts=P_MULTI, packed=packed_info,
         gather=gather_info, step_ms=flux_ms,
         faces_per_sec={s: nface / (v * 1e-3) for s, v in flux_ms.items()},
         steps=TIMED_STEPS, profile=profiles["flux"],
         idle={s: (None if p["device_ms"] is None
                   else 1.0 - p["device_ms"] / flux_ms[s])
               for s, p in profiles["flux"].items()},
         solver_step_gather_bp512=solver_step,
         kernels=kernel_summary([k for k in (*FLUX_PACKED, *FLUX_GATHER)
                                 if k != "pack_srcs"]))
    if bad:
        fail(f"flux_p8: step timing fell below the noise floor: {bad}")
    del flux_ms, profiles

    # ---- reduced precision, one shard: bench.py's reduced-precision row
    # (bench.py:559-611: packed, AUTO bp, bulk, bf16 source deltas and
    # weights), then with bf16 gradient stores as well; each timed, with
    # the speedups over this run's f32 bulk step (`timing`)
    reset_counts()
    t0 = time.perf_counter()
    rm = GreenGaussTorch(parts, NVAR, src_dtype=BF, meta_dtype=BF,
                         device=dev)
    t_model = time.perf_counter() - t0
    state = rm.distribute_state(gvar, schedules=["bulk"])
    rel_bf = golden_relmax(rm, rm.step(state, "bulk"))
    counts = read_counts()
    expect_counts("reduced_p1", counts, ("pack_srcs_d16",
                                         "sweep_blocks_w16_d16"))
    bf_counts = counts
    lo, hi = BAND_SRC_META
    if not lo < rel_bf <= hi:
        fail(f"reduced_p1: bulk vs golden relmax {rel_bf:.3e} outside "
             f"({lo}, {hi}]")
    st_bf = time_schedule(rm, state, "bulk", TIMED_STEPS, warmup=2,
                          repeats=5)
    reduced_bulk_s = st_bf.median   # the scaling model's reduced 96³ rate
    # K4's delta pack bitwise and K1 on bf16 deltas and weights (f32 out)
    # against their plain versions, at these shapes
    pl = rm.plans["bulk"]
    var_T = state["var_T"]
    pk = dict(src_format="bf16d", bp=rm.bp, **rm.pack_operands("bulk"))
    tbl16 = bs.pack_srcs(var_T, pl["src_cols"], **pk)
    tbl16_ref = bs.pack_srcs_ref(var_T, pl["src_cols"], "bf16d",
                                 pl["block_ids"], pl["slots"], rm.bp)
    torch.cuda.synchronize()
    if not torch.equal(tbl16, tbl16_ref):
        fail("pack_srcs (bf16d) differs from its plain version")
    errs["pack_srcs_d16"], scales["pack_srcs_d16"] = 0.0, float(
        tbl16_ref.float().abs().max())
    work["pack_srcs_d16"] = bound(nbytes(var_T, pl["src_cols"],
                                         pl["block_ids"], pl["slots"],
                                         tbl16_ref), 0)
    times["pack_srcs_d16"] = {**paired_ms(
        lambda: bs.pack_srcs(var_T, pl["src_cols"], **pk),
        lambda: bs.pack_srcs_ref(var_T, pl["src_cols"], "bf16d",
                                 pl["block_ids"], pl["slots"], rm.bp)),
        **pack_facts(pk)}
    del tbl16_ref
    k1bf = (var_T, *rm._operands("bulk", state["tables"]))
    # the plain version's own golden error on the same operands: the
    # reduced-precision error is the arithmetic's, not the kernel's
    rel_bf_plain = golden_relmax(rm, bs.sweep_blocks_ref(*k1bf))
    compare_and_time("sweep_blocks_w16_d16",
                     lambda i: bs.sweep_blocks(*k1bf),
                     lambda i: bs.sweep_blocks_ref(*k1bf))
    work["sweep_blocks_w16_d16"] = sweep_bound("gg", k1bf, gather=False)
    del state, k1bf, tbl16, rm

    # with bf16 stores: the full stack with the fused kernel forced, used
    # again by reduced_p1_all (at one shard no phase moves data, so the
    # bulk step reads neither the halo option nor force_rdma: its work is
    # bench.py's with_bf16_grads row)
    reset_counts()
    fm16 = GreenGaussTorch(parts, NVAR, force_rdma=True, device=dev, **FULL)
    state = fm16.distribute_state(gvar, schedules=["bulk"])
    g = fm16.step(state, "bulk")
    if g.dtype != torch.bfloat16:
        fail(f"reduced_p1: bf16 stores gave a {g.dtype} output")
    rel_bg = golden_relmax(fm16, g)
    counts = read_counts()
    expect_counts("reduced_p1", counts, ("pack_srcs_d16",
                                         "sweep_blocks_w16_d16_o16"))
    lo, hi = BAND_FULL
    if not lo < rel_bg <= hi:
        fail(f"reduced_p1 (bf16 stores): bulk vs golden relmax "
             f"{rel_bg:.3e} outside ({lo}, {hi}]")
    st_bg = time_schedule(fm16, state, "bulk", TIMED_STEPS, warmup=2,
                          repeats=5)
    k1o = (state["var_T"], *fm16._operands("bulk", state["tables"]))
    rel_bg_plain = golden_relmax(fm16, bs.sweep_blocks_ref(
        *k1o, out_dtype=torch.bfloat16))
    compare_and_time("sweep_blocks_w16_d16_o16",
                     lambda i: bs.sweep_blocks(*k1o, out_dtype=torch.bfloat16),
                     lambda i: bs.sweep_blocks_ref(*k1o,
                                                   out_dtype=torch.bfloat16))
    work["sweep_blocks_w16_d16_o16"] = sweep_bound("gg", k1o, gather=False,
                                                   out_bytes=2)
    del state, k1o, g
    bad = [k for k, v in (("reduced", st_bf.median),
                          ("with_bf16_grads", st_bg.median))
           if not np.isfinite(v)]
    emit("reduced_p1", card=smi, parts=1, kernel="packed", bp=fm16.bp,
         src_dtype=BF, meta_dtype=BF, model_seconds=t_model,
         bulk_vs_golden_relmax=rel_bf, plain_vs_golden_relmax=rel_bf_plain,
         band=BAND_SRC_META,
         launches=bf_counts, faces_per_sec=nface / st_bf.median,
         median_ms=st_bf.median * 1e3,
         step_ms_all=[t * 1e3 for t in st_bf.times],
         speedup_vs_f32=f32_bulk_s / st_bf.median,
         f32_bulk_ms=f32_bulk_s * 1e3, steps=TIMED_STEPS,
         with_bf16_grads={
             "grad_dtype": BF, "bulk_vs_golden_relmax": rel_bg,
             "plain_vs_golden_relmax": rel_bg_plain,
             "band": BAND_FULL, "launches": counts,
             "faces_per_sec": nface / st_bg.median,
             "median_ms": st_bg.median * 1e3,
             "step_ms_all": [t * 1e3 for t in st_bg.times],
             "speedup_vs_reduced": st_bf.median / st_bg.median,
             "speedup_vs_f32": f32_bulk_s / st_bg.median},
         kernels=kernel_summary(["pack_srcs_d16", "sweep_blocks_w16_d16",
                                 "sweep_blocks_w16_d16_o16"]))
    if bad:
        fail(f"reduced_p1: step timing fell below the noise floor: {bad}")

    # ---- reduced precision, one shard, all four options, every schedule
    # with the fused overlap kernel forced (bf16 self-send push)
    reset_counts()
    state = fm16.distribute_state(gvar)
    outs = {s: fm16.step(state, s) for s in ("bulk", "early", "overlap")}
    counts = read_counts()
    rel, cross, scale = check_schedules(
        "reduced_p1_all", fm16, outs, band=BAND_FULL,
        cross_tol=SCHED_TOL_BF16)
    expect_counts("reduced_p1_all", counts, REDUCED_PACKED)
    p1_all_ms = {}
    for s in ("bulk", "early", "overlap"):
        st = time_schedule(fm16, state, s, TIMED_STEPS, warmup=2, repeats=5)
        p1_all_ms[s] = st.median * 1e3
    prof = {s: device_profile(fm16, state, s) for s in p1_all_ms}
    emit("reduced_p1_all", card=smi, parts=1, force_rdma=True,
         has_comm=fm16.has_comm, options=FULL, vs_golden_relmax=rel,
         band=BAND_FULL, cross=cross, max_abs_bulk=scale,
         cross_tol=SCHED_TOL_BF16 * scale, launches=counts,
         step_ms=p1_all_ms, steps=TIMED_STEPS, profile=prof,
         idle={s: (None if p["device_ms"] is None
                   else 1.0 - p["device_ms"] / p1_all_ms[s])
               for s, p in prof.items()})
    if not all(np.isfinite(v) for v in p1_all_ms.values()):
        fail(f"reduced_p1_all: step timing below the noise floor: "
             f"{p1_all_ms}")
    graph_models["full_p1"] = fm16
    del outs, state, fm16

    # ---- reduced precision, 8 shards: the full stack under the packed
    # kernel, every schedule, ghosts against owners; K1-init and K3 on bf16
    # operands against their plain versions at the interior shapes
    reset_counts()
    t0 = time.perf_counter()
    pm = GreenGaussTorch(parts8, NVAR, device=dev, **FULL)
    t_model = time.perf_counter() - t0
    state = pm.distribute_state(gvar)
    outs = {s: pm.step(state, s)
            for s in ("bulk", "early", "overlap", "nocomm")}
    counts = read_counts()
    rel, cross, scale = check_schedules("reduced_p8", pm, outs,
                                        band=BAND_FULL,
                                        cross_tol=SCHED_TOL_BF16)
    expect_counts("reduced_p8", counts, REDUCED_PACKED)
    # bf16 stores and wire: every ghost column equals its owner bitwise
    nghost = {s: ghost_check("reduced_p8", pm, outs[s])
              for s in ("bulk", "early", "overlap")}
    packed_info = {"bp": pm.bp, "model_seconds": t_model, "options": FULL,
                   "vs_golden_relmax": rel, "band": BAND_FULL,
                   "cross": cross, "max_abs_bulk": scale,
                   "cross_tol": SCHED_TOL_BF16 * scale,
                   "ghost_columns_checked": nghost, "launches": counts}
    iargs = (state["var_T"], *pm._operands("interior", state["tables"]))
    gb = outs["nocomm"].clone()          # any finite bf16 (P, 24, ndev) init
    sendbufs = pm._pack(gb, pm.pack_scale, torch.bfloat16)
    del outs
    compare_and_time(
        "sweep_blocks_init_w16_d16_o16",
        lambda i: bs.sweep_blocks(*iargs, init=i),
        lambda i: bs.sweep_blocks_ref(*iargs, init=i), init=gb)
    compare_and_time(
        "sweep_blocks_overlap_w16_d16_o16",
        lambda i: bs.sweep_blocks_overlap(*iargs, i, sendbufs, pm.dsts,
                                          pm.srcs),
        lambda i: bs.sweep_blocks_overlap_ref(*iargs, i, sendbufs, pm.dsts,
                                              pm.srcs),
        init=gb, push=True)
    work["sweep_blocks_init_w16_d16_o16"] = sweep_bound(
        "gg", iargs, gather=False, init=True, out_bytes=2)
    work["sweep_blocks_overlap_w16_d16_o16"] = sweep_bound(
        "gg", iargs, gather=False, init=True, push=sendbufs, out_bytes=2)
    del iargs, gb, sendbufs
    p8_ms = {}
    for s in ("bulk", "early", "overlap", "nocomm"):
        st = time_schedule(pm, state, s, TIMED_STEPS, warmup=2, repeats=5)
        p8_ms[s] = st.median * 1e3
    prof = {s: device_profile(pm, state, s) for s in p8_ms}
    packed_info.update(
        step_ms=p8_ms, profile=prof,
        idle={s: (None if p["device_ms"] is None
                  else 1.0 - p["device_ms"] / p8_ms[s])
              for s, p in prof.items()})
    full_stack_p8 = pm          # K3's peer form reuses its operands
    del state, prof

    # the bf16 halo alone: owned columns never ride the wire, so they equal
    # the f32 model's (main_path_p8) bitwise; every ghost column is the
    # bf16 rounding of its owner's (a send point's boundary sum is its
    # whole sum, so the wire carries the owner's final value)
    reset_counts()
    hm = GreenGaussTorch(parts8, NVAR, halo_dtype=BF, device=dev)
    state = hm.distribute_state(gvar)
    halo_info = {"launches": None, "ghost_columns_checked": {}}
    for s in ("bulk", "early", "overlap"):
        g = hm.step(state, s).cpu()
        for i, p in enumerate(hm.parts):
            if not torch.equal(g[i, :, : p.nowned],
                               f32_p8[s][i, :, : p.nowned]):
                fail(f"reduced_p8 (bf16 halo): {s} owned columns of shard "
                     f"{i} differ from the f32 model's")
        if torch.equal(g, f32_p8[s]):
            fail(f"reduced_p8 (bf16 halo): {s} ghosts were not rounded")
        halo_info["ghost_columns_checked"][s] = ghost_check(
            "reduced_p8 (bf16 halo)", hm, g.numpy(), wire=True)
    halo_info["launches"] = read_counts()
    expect_counts("reduced_p8", halo_info["launches"], PACKED)
    del state, hm, f32_p8, g

    # the gather kernel at bp 512 with bf16 weights, stores and halo (bf16
    # sources are packed only): every schedule, refresh_state (the var
    # exchange stays f32) and the solver-mode runner
    reset_counts()
    t0 = time.perf_counter()
    gm = GreenGaussTorch(parts8, NVAR, bp=GATHER_BP, kernel="gather",
                         meta_dtype=BF, grad_dtype=BF, halo_dtype=BF,
                         device=dev)
    t_model = time.perf_counter() - t0
    state = gm.distribute_state(gvar)
    outs = {s: gm.step(state, s) for s in ("bulk", "early", "overlap")}
    counts = read_counts()
    rel, cross, scale = check_schedules("reduced_p8", gm, outs,
                                        band=BAND_FULL,
                                        cross_tol=SCHED_TOL_BF16)
    expect_counts("reduced_p8", counts, REDUCED_GATHER)
    if counts.get("pack_srcs", 0) or counts.get("pack_srcs_d16", 0):
        fail("reduced_p8: the gather model launched the source pack")
    gather_info = {"bp": gm.bp, "model_seconds": t_model,
                   "plans": {c: gather_facts(bs, gm, c) for c in gm.plans},
                   "options": {"meta_dtype": BF, "grad_dtype": BF,
                               "halo_dtype": BF},
                   "vs_golden_relmax": rel, "band": BAND_FULL,
                   "cross": cross, "max_abs_bulk": scale,
                   "cross_tol": SCHED_TOL_BF16 * scale,
                   "step_ghost_columns_checked": ghost_check(
                       "reduced_p8", gm, outs["early"]),
                   "launches": counts}
    del outs
    reset_counts()
    st2 = gm.refresh_state(owned_scaled(gm, state["var_T"], 1.5),
                           schedules=["bulk"])
    rel15 = golden_relmax(gm, gm.step(st2, "bulk"), scale=1.5)
    counts = read_counts()
    expect_counts("reduced_p8", counts, ("sweep_blocks_gather_w16_o16",))
    lo, hi = BAND_FULL
    if not lo < rel15 <= hi:
        fail(f"reduced_p8: bulk after refresh_state vs the golden of "
             f"1.5·gvar: {rel15:.3e} outside ({lo}, {hi}]")
    if st2["var_T"].dtype != torch.float32:
        fail("reduced_p8: the var exchange left f32")
    gather_info["refresh_vs_golden_15_relmax"] = rel15
    gather_info["var_ghost_columns_checked"] = ghost_check(
        "reduced_p8", gm, st2["var_T"])
    del st2
    reset_counts()
    v = gm.iterate_fn("bulk", SOLVER_RUN, solver_mode=True)(
        *gm.iter_args(state))
    counts = read_counts()
    expect_counts("reduced_p8", counts, ("sweep_blocks_gather_w16_o16",))
    if counts.get("sweep_blocks_gather_w16_o16", 0) != SOLVER_RUN:
        fail(f"reduced_p8: {SOLVER_RUN} solver steps launched K2 (bf16) "
             f"{counts.get('sweep_blocks_gather_w16_o16', 0)} times")
    if (v.dtype != torch.float32 or v.shape != state["var_T"].shape
            or not bool(torch.isfinite(v).all())):
        fail(f"reduced_p8: solver-mode state {v.dtype} "
             f"{tuple(v.shape)} or non-finite")
    gather_info["solver_launches"] = counts
    del v
    # K2 at the bulk shapes, K2-init and K3-gather at the interior + push
    # shapes, bf16 weights and out, against their plain versions
    k2 = (state["var_T"], *gm._operands("bulk", state["tables"]))
    kw = gm._gather_kw("bulk")
    compare_and_time(
        "sweep_blocks_gather_w16_o16",
        lambda i: bs.sweep_blocks_gather(*k2, out_dtype=torch.bfloat16,
                                         **kw),
        lambda i: bs.sweep_blocks_gather_ref(*k2, out_dtype=torch.bfloat16))
    work["sweep_blocks_gather_w16_o16"] = sweep_bound("gg", k2, gather=True,
                                                      out_bytes=2)
    times["sweep_blocks_gather_w16_o16"].update(gather_facts(bs, gm, "bulk"))
    del k2
    iargs = (state["var_T"], *gm._operands("interior", state["tables"]))
    kw = gm._gather_kw("interior")
    gb = gm.step(state, "nocomm")               # any finite bf16 init
    sendbufs = gm._pack(gb, gm.pack_scale, torch.bfloat16)
    compare_and_time(
        "sweep_blocks_gather_init_w16_o16",
        lambda i: bs.sweep_blocks_gather(*iargs, init=i, **kw),
        lambda i: bs.sweep_blocks_gather_ref(*iargs, init=i), init=gb)
    compare_and_time(
        "sweep_blocks_overlap_gather_w16_o16",
        lambda i: bs.sweep_blocks_overlap_gather(*iargs, i, sendbufs,
                                                 gm.dsts, gm.srcs, **kw),
        lambda i: bs.sweep_blocks_overlap_gather_ref(*iargs, i, sendbufs,
                                                     gm.dsts, gm.srcs),
        init=gb, push=True)
    work["sweep_blocks_gather_init_w16_o16"] = sweep_bound(
        "gg", iargs, gather=True, init=True, out_bytes=2)
    work["sweep_blocks_overlap_gather_w16_o16"] = sweep_bound(
        "gg", iargs, gather=True, init=True, push=sendbufs, out_bytes=2)
    times["sweep_blocks_gather_init_w16_o16"].update(
        gather_facts(bs, gm, "interior"))
    times["sweep_blocks_overlap_gather_w16_o16"].update(
        gather_facts(bs, gm, "interior", fused=True))
    del iargs, gb, sendbufs, state, gm
    emit("reduced_p8", card=smi, parts=P_MULTI, packed=packed_info,
         halo_only=halo_info, gather=gather_info, steps=TIMED_STEPS,
         kernels=kernel_summary([*REDUCED_PACKED[1:], *REDUCED_GATHER]))
    if not all(np.isfinite(v) for v in p8_ms.values()):
        fail(f"reduced_p8: step timing below the noise floor: {p8_ms}")

    # ---- reduced precision, flux, one shard: bf16 sources, weights and
    # stores, bulk, timed, against the flux golden
    reset_counts()
    fm = PSDFluxModel(parts, NVAR, src_dtype=BF, meta_dtype=BF,
                      grad_dtype=BF, device=dev)
    state = fm.distribute_state(gvar, schedules=["bulk"])
    relf = golden_relmax(fm, fm.step(state, "bulk"), gold=flux_ref)
    counts = read_counts()
    expect_counts("reduced_flux", counts, ("pack_srcs_d16",
                                           "sweep_blocks_flux_w16_d16_o16"))
    if not 0 < relf <= FLUX_BF16_TOL:
        fail(f"reduced_flux: bulk vs the flux golden relmax {relf:.3e} "
             f"outside (0, {FLUX_BF16_TOL}]")
    st = time_schedule(fm, state, "bulk", TIMED_STEPS, warmup=2, repeats=5)
    if not np.isfinite(st.median):
        fail("reduced_flux: bulk step timing fell below the noise floor")
    k1f = (state["var_T"], *fm._operands("bulk", state["tables"]))
    compare_and_time(
        "sweep_blocks_flux_w16_d16_o16",
        lambda i: bs.sweep_blocks(*k1f, op="flux", out_dtype=torch.bfloat16),
        lambda i: bs.sweep_blocks_ref(*k1f, op="flux",
                                      out_dtype=torch.bfloat16))
    work["sweep_blocks_flux_w16_d16_o16"] = sweep_bound(
        "flux", k1f, gather=False, out_bytes=2)
    emit("reduced_flux", card=smi, parts=1, kernel="packed", bp=fm.bp,
         options={"src_dtype": BF, "meta_dtype": BF, "grad_dtype": BF},
         bulk_vs_golden_relmax=relf, tol=FLUX_BF16_TOL, launches=counts,
         bulk_step_ms=st.median * 1e3,
         bulk_step_ms_all=[t * 1e3 for t in st.times],
         faces_per_sec=nface / st.median,
         speedup_vs_f32_flux=flux_p1_s / st.median, steps=TIMED_STEPS,
         kernels=kernel_summary(["sweep_blocks_flux_w16_d16_o16"]))
    del state, fm, k1f

    # ---- graph: the chained step as CUDA graphs (models/compiled.py)
    # against the same step eager, per configuration: the dispatch the rule
    # gives; GRAPH_STEPS chained steps at a coupling that moves the state
    # by up to GRAPH_MOVE a step (so it carries every step's gradients)
    # bit for bit; the
    # kernels a replay launches against the launches an eager step counts
    # and the counts the runner adds; one replayed step's gradients bit for
    # bit the eager step's and within the model's golden bound; the
    # capture's seconds and both runs' peak memory; then the step timed in turns (eager, graph, graph, eager),
    # each turn with its device ms (`kernel_device_ms`) and idle share; the
    # P=1 and P=8 overlap steps also profiled both ways (`device_profile`).
    # The configurations: the kernel models' chained and solver-mode steps,
    # the overlap step through the peer transport (its launch epochs are
    # device words, so it replays; its 20 steps also equal its loopback
    # twin's graph bit for bit), the ELL model (no kernel of the port: its
    # census is of its torch ops, recorded) and one solver_attrib knockout
    # per kernel it knocks out (K4, K1, K2)
    from types import SimpleNamespace

    from cfd_proxy_tpu_torch.models.gradients import SCHEDULE_CLASSES
    from cfd_proxy_tpu_torch.ops.plan import NV
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph_models.update({"p1": packed_models[1], "p8": packed_models[P_MULTI],
                         "gather_p1": gather_models[1],
                         "gather_p8": gather_models[P_MULTI],
                         "gather_p2": k3_models.pop("p2_auto"),
                         "gather_p2_large": k3_models.pop("p2_large"),
                         "gather_p2_large_flux": k3_models.pop(
                             "p2_large_flux"),
                         "full_p8": full_stack_p8})
    peer_twin = {"peer_p1": "p1", "peer_p8": "p8",
                 "peer_gather_p8": "gather_p8", "peer_full_p8": "full_p8"}
    # (built once: the peer phases below drive them again)
    t_phase = time.perf_counter()
    peer_models, peer_build_s = {}, {}
    for mk, (pp, opts) in {
            "peer_p1": (parts, {"force_rdma": True}),
            "peer_p8": (parts8, {}),
            "peer_gather_p8": (parts8, {"bp": GATHER_BP, "kernel": "gather"}),
            "peer_full_p8": (parts8, FULL)}.items():
        t0 = time.perf_counter()
        peer_models[mk] = GreenGaussTorch(pp, NVAR, device=dev,
                                          transport="peer", **opts)
        peer_build_s[mk] = time.perf_counter() - t0
    graph_models.update(peer_models)
    for dname in ("float32", "float64"):
        graph_models["ell_" + dname] = GreenGaussModel(
            parts, NVAR, dtype=DTYPES[dname], device=dev)
    # each model's golden and bound (its own phase's): f32 within
    # GOLDEN_TOL, the full bf16 stack within BAND_FULL's, ELL f64 within
    # ELL_F64_TOL
    graph_gold = {"flux_p1": (flux_ref, GOLDEN_TOL),
                  "gather_p2_large_flux": (flux_ref, GOLDEN_TOL),
                  "full_p1": (None, BAND_FULL[1]),
                  "full_p8": (None, BAND_FULL[1]),
                  "peer_full_p8": (None, BAND_FULL[1]),
                  "ell_float64": (None, ELL_F64_TOL)}
    graph_cfgs = (          # name: (model, schedule, solver mode sweeps)
        [("p1_bulk", "p1", "bulk", 0)]         # also P=1 all's bulk
        + [(f"p1_all_{s}", "p1", s, 0) for s in SCHEDULES_ALL[1:]]
        + [(f"p8_{s}", "p8", s, 0) for s in SCHEDULES_ALL]
        + [("gather512_p1_solver_n1", "gather_p1", "bulk", 1),
           ("gather512_p8_solver_n2", "gather_p8", "bulk", 2),
           ("gather_p2_auto_overlap", "gather_p2", "overlap", 0),
           ("gather_p2_large_overlap", "gather_p2_large", "overlap", 0),
           ("gather_p2_large_flux_overlap", "gather_p2_large_flux",
            "overlap", 0),
           ("full_p1_overlap", "full_p1", "overlap", 0),
           ("full_p8_early", "full_p8", "early", 0)]
        + [(f"flux_p1_all_{s}", "flux_p1", s, 0) for s in SCHEDULES_ALL]
        + [("peer_p1_all_overlap", "peer_p1", "overlap", 0),
           ("peer_p8_overlap", "peer_p8", "overlap", 0),
           ("peer_gather512_p8_overlap", "peer_gather_p8", "overlap", 0),
           ("peer_full_p8_overlap", "peer_full_p8", "overlap", 0)]
        + [(f"ell_p1_{d}_{s}", "ell_" + d, s, 0)
           for d in ("float32", "float64") for s in ("bulk", "overlap")]
        # the knockout mode in the schedule's place
        + [("attrib_packed_tablesonly", "p1", "tablesonly", 0),
           ("attrib_packed_sweeponly", "p1", "sweeponly", 0),
           ("attrib_gather512_sweeponly", "gather_p1", "sweeponly", 0)])
    profiled = ("p1_all_overlap", "p8_overlap")

    def replayed(m, body_of, buf, args, key, **rule):
        """(one replayed step's `buf`, one eager step's): the chained body
        `body_of(buf)`, which also copies what its step computes into buf,
        run through `compiled.runner` one step at a time; the graph's first
        call runs step 1 eagerly and captures, its second replays graph 0
        once."""
        def run(graph):
            return compiled.runner(m, body_of(buf), 1, (key, id(buf)),
                                   graph=graph, **rule)

        run(False)(*args)
        eager = buf.clone()
        graph = run(None)
        graph(*args)
        buf.zero_()
        graph(*args)
        torch.cuda.synchronize()
        return buf.clone(), eager

    def kernel_case(m, mk, s, sweeps):
        """The kernel model's chained (or solver-mode) step."""
        solver = sweeps > 0
        sw = max(1, sweeps)
        st_ = states[mk]
        args_ = m.iter_args(st_)
        needed = SCHEDULE_CLASSES[s]
        gold_, tol_ = graph_gold.get(mk, (None, GOLDEN_TOL))

        def probe(c):
            def body_of(g):
                def body(v, tables, out=None):
                    gv = m(v, m._build_tables(v, needed) if solver
                           else tables, s)
                    g.copy_(gv)
                    return torch.add(v, c * gv[:, :NV], out=out)
                return body
            g = torch.empty(m.nlocal, m.rows, m.ndev, dtype=m.grad_t,
                            device=dev)
            return replayed(m, body_of, g, args_, ("probe", s, solver, c),
                            schedule=s, solver_mode=solver)

        return SimpleNamespace(
            dispatch=compiled.dispatch(m, s, solver), start=args_[0],
            movement=lambda: m.step(st_, s)[:, :NV].float(),
            run=lambda n, graph, c: m.iterate_fn(
                s, n, solver, sw, graph=graph, coupling=c)(*args_),
            probe=probe, tol=tol_,
            golden=lambda g: golden_relmax(m, g, gold=gold_),
            time=lambda graph: time_schedule(
                m, st_, s, GRAPH_ITERS, warmup=1, repeats=3,
                solver_mode=solver, sweeps_per_step=sw,
                graph=graph).median * 1e3,
            eager_device_n=10, port_kernels=True, solver_sweeps=sweeps or None)

    def ell_case(m, mk, s):
        """The ELL model's chained step (plain torch: no kernel of the
        port)."""
        var = states[mk]
        nvar = m.nvar

        def probe(c):
            def body_of(g):
                def body(v, out=None):
                    gv = m(v, s)
                    g.copy_(gv)
                    return torch.add(v, c * gv[..., :nvar], out=out)
                return body
            return replayed(m, body_of, torch.empty_like(m.step(var, s)),
                            (var,), ("probe", s, c), schedule=s)

        return SimpleNamespace(
            dispatch=compiled.dispatch(m, s), start=var,
            movement=lambda: m.step(var, s)[..., :nvar].float(),
            run=lambda n, graph, c: m.iterate_fn(
                s, n, graph=graph, coupling=c)(var),
            probe=probe, tol=graph_gold.get(mk, (None, GOLDEN_TOL))[1],
            golden=lambda g: golden_relmax(m, g),
            time=lambda graph: time_schedule(
                m, var, s, ELL_GRAPH_ITERS, warmup=1, repeats=3,
                graph=graph).median * 1e3,
            eager_device_n=4, port_kernels=False, solver_sweeps=None)

    def attrib_case(m, mk, mode):
        """A solver_attrib knockout body (`knockout_fn`) at one shard: its
        step's gradients (sweeponly) or rebuilt table (tablesonly) feed the
        state at the coupling.  tablesonly adds its table's sum to every
        column, and the sum of a table of standard normals nearly cancels
        (a coupling that moves the state by it would grow each step's sum
        a thousandfold): it starts from the state plus 1, whose table sum
        is about the table's size, so a step grows it by about GRAPH_MOVE."""
        if "attrib_" + mk not in states:
            states["attrib_" + mk] = m.distribute_state(gvar,
                                                        schedules=["bulk"])
        st_ = states["attrib_" + mk]
        sweeps = mode == "sweeponly"
        v0 = st_["var_T"] if sweeps else st_["var_T"] + 1.0

        def movement():
            if sweeps:
                return m.step(st_, "bulk")[:, :NV].float()
            return (m._build_tables(v0, ("bulk",))["bulk"].float().sum()
                    * 1e-30).reshape(1)

        def probe(c):
            like = (m.step(st_, "bulk") if sweeps
                    else st_["tables"]["bulk"])
            sink = torch.empty_like(like)
            ko = solver_attrib.knockout_fn(m, st_, mode, c, sink)
            ko(1, v0, False)
            eager = sink.clone()
            ko(1, v0, None)             # step 1 eagerly, then the capture
            sink.zero_()
            ko(1, v0, None)             # one replay of graph 0
            torch.cuda.synchronize()
            return sink.clone(), eager

        return SimpleNamespace(
            dispatch=compiled.dispatch(m), start=v0, movement=movement,
            run=lambda n, graph, c: solver_attrib.knockout_fn(
                m, st_, mode, c)(n, v0, graph),
            probe=probe, tol=GOLDEN_TOL,
            golden=(lambda g: golden_relmax(m, g)) if sweeps else None,
            time=lambda graph: float(np.median(solver_attrib.attribute(
                m, st_, [mode], GRAPH_ITERS, 3, graph=graph)[mode] or
                [float("nan")])),
            eager_device_n=10, port_kernels=True, solver_sweeps=None)

    def kernels_seen(run):
        """{kernel: launches} CUPTI saw in one call of run() (copies and
        fills left out: the graph runner copies the state in and out)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return collections.Counter({
            e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))})

    graph_res, graph_slower, states = {}, [], {}
    for name, mk, s, sweeps in graph_cfgs:
        t_cfg = time.perf_counter()
        m = graph_models[mk]
        if mk.startswith("ell_"):
            if mk not in states:
                states[mk] = m.distribute_state(gvar)
            case = ell_case(m, mk, s)
        elif name.startswith("attrib_"):
            case = attrib_case(m, mk, s)
        else:
            if mk not in states:
                states[mk] = m.distribute_state(gvar)
            case = kernel_case(m, mk, s, sweeps)
        kind_, why = case.dispatch
        if kind_ != "graph":
            fail(f"graph {name}: dispatch {kind_} ({why})")
        m.graphs.clear()                # capture afresh: seconds, memory
        # the coupling: one step moves the state by at most GRAPH_MOVE
        coupling = GRAPH_MOVE / float(case.movement().abs().max())
        res_ = {}
        for mode in (False, None):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out_ = case.run(GRAPH_STEPS, mode, coupling)
            torch.cuda.synchronize()
            res_["graph" if mode is None else "eager"] = (
                out_, (torch.cuda.max_memory_allocated() - base) / 1e9)
        (g_out, g_peak), (e_out, e_peak) = res_["graph"], res_["eager"]
        moved = float((e_out - case.start).abs().max())
        if not torch.isfinite(e_out).all() or not moved > 1e-3:
            fail(f"graph {name}: the eager state after {GRAPH_STEPS} steps "
                 f"is not finite or did not move ({moved})")
        if not torch.equal(g_out, e_out):
            fail(f"graph {name}: {GRAPH_STEPS} chained steps under graph "
                 f"differ from eager (max abs "
                 f"{float((g_out - e_out).abs().max()):.3e})")
        capture_s = next(reversed(m.graphs.values())).seconds
        twin = None
        if mk in peer_twin:
            # the peer form equals its loopback form bit for bit (the
            # peer phases hold it per launch), so its graph equals the
            # loopback model's graph bit for bit
            tw = graph_models[peer_twin[mk]]
            t_out = tw.iterate_fn(s, GRAPH_STEPS, coupling=coupling)(
                *tw.iter_args(states[peer_twin[mk]]))
            torch.cuda.synchronize()
            if not torch.equal(g_out, t_out):
                fail(f"graph {name}: {GRAPH_STEPS} steps under graph differ "
                     f"from the loopback twin's graph ({peer_twin[mk]})")
            twin = {"model": peer_twin[mk], "equal_bitwise": True}
            tw.graphs.clear()
            del t_out
        del res_, g_out, e_out
        # the launches: the kernel nodes of the captured graphs (what a
        # replay launches, `compiled.kernel_nodes`): the port's among them
        # against the launches one eager step counts and the counts the
        # runner adds for GRAPH_CHECK_N replays; CUPTI's view (one eager
        # step, the replays) recorded beside them
        entry = next(reversed(m.graphs.values()))
        nodes = [collections.Counter(compiled.kernel_nodes(g))
                 for g in entry.graphs]
        ours = sum(n_ for k_, n_ in nodes[0].items()
                   if PORT_KERNEL.search(k_))
        del entry
        reset_counts()
        seen_e = kernels_seen(lambda: case.run(1, False, coupling))
        eager_counts = read_counts()
        reset_counts()
        seen_g = kernels_seen(lambda: case.run(GRAPH_CHECK_N, None, coupling))
        added = read_counts()
        if nodes[0] != nodes[1]:
            fail(f"graph {name}: the two captured graphs launch different "
                 f"kernels: {nodes}")
        # the P=1 bulk step, from the code: K1 (zero-filled, its own zeros)
        # and the update, one kernel each; no fill, multiply or add
        if name == "p1_bulk" and sorted(
                ("sweep_packed_kernel" in k_, "chain_update_kernel" in k_, n_)
                for k_, n_ in nodes[0].items()) != [(False, True, 1),
                                                   (True, False, 1)]:
            fail(f"graph {name}: a replay launches {dict(nodes[0])}, not "
                 f"K1 and the update once each")
        if (case.port_kernels and ours == 0) or ours != sum(
                eager_counts.values()) or added != {
                k_: n_ * GRAPH_CHECK_N for k_, n_ in eager_counts.items()}:
            fail(f"graph {name}: a replay launches {ours} of the port's "
                 f"kernels; an eager step counted {eager_counts}, the "
                 f"runner {added} for {GRAPH_CHECK_N} replays")
        cupti_ = {"eager_step_as_graph": seen_e == nodes[0],
                  "replays_as_graph": seen_g == {
                      k_: n_ * GRAPH_CHECK_N for k_, n_ in nodes[0].items()},
                  "replay_kernels": sum(seen_g.values()),
                  "eager_step_kernels": sum(seen_e.values())}
        # one replayed step's output: the eager step's, and the golden's
        g_rep, g_eag = case.probe(coupling)
        if not torch.equal(g_rep, g_eag):
            fail(f"graph {name}: a replayed step's output differs from "
                 f"the eager step's")
        rel_ = None if case.golden is None else case.golden(g_rep)
        if rel_ is not None and not rel_ <= case.tol:
            fail(f"graph {name}: a replayed step vs the golden relmax "
                 f"{rel_:.3e} > {case.tol}")
        del g_rep, g_eag
        m.graphs.clear()
        # device ms per step, the stream held while the host enqueues: the
        # two captured graphs replayed in turn (5 pairs), or a few eager
        # steps (few enough launches for the stream's queue)
        case.run(2, None, compiled.COUPLING)   # capture at the default
        entry = next(reversed(m.graphs.values()))
        device = {
            None: lambda: kernel_device_ms(
                lambda: [g.replay() for g in entry.graphs], 5) / 2,
            False: lambda: kernel_device_ms(
                lambda: case.run(1, False, compiled.COUPLING),
                case.eager_device_n)}
        turns = {"eager": [], "graph": []}
        for mode in (False, None, None, False):
            key_ = "graph" if mode is None else "eager"
            step = case.time(mode)
            dev_ms = device[mode]()
            turns[key_].append({"step_ms": step, "device_ms": dev_ms,
                                "idle": 1.0 - dev_ms / step})
        best = {k: min(t["step_ms"] for t in v) for k, v in turns.items()}
        # the gated steps: a step takes at least its held device time, so a
        # turn the host's clock read below it counts at its device time
        floored = {k: min(max(t["step_ms"], t["device_ms"]) for t in v)
                   for k, v in turns.items()}
        row = {"dispatch": kind_, "schedule": s,
               "parts": len(m.parts), "kernel": getattr(m, "kernel", "ell"),
               "op": getattr(m, "op", "gg"),
               "transport": m.transport_name,
               "solver_sweeps": case.solver_sweeps,
               "equal_bitwise": True, "coupling": coupling,
               "moved": moved, "replayed_out_equal": True,
               "replayed_grad_vs_golden": rel_, "golden_tol": (
                   None if rel_ is None else case.tol),
               "replay_kernels": {"all": sum(nodes[0].values()),
                                  "port": ours},
               "launches_added": added, "cupti": cupti_,
               "capture_s": capture_s, "peak_gb": {"graph": g_peak,
                                                   "eager": e_peak},
               "turns": turns, "step_ms": best,
               "graph_over_eager": floored["graph"] / floored["eager"],
               # the better turn's step against the least device time
               "idle": {k: 1.0 - min(t["device_ms"] for t in v) / best[k]
                        for k, v in turns.items()}}
        if twin is not None:
            row["loopback_twin_graph"] = twin
        if not all(np.isfinite(v) for v in best.values()):
            fail(f"graph {name}: step timing below the noise floor {best}")
        if floored["graph"] > GRAPH_SLOWER * floored["eager"]:
            graph_slower.append(name)
        if name in profiled:
            # windows in turns (eager, graph, graph, eager, twice), each
            # window's step device ms at one set of launches a step: per
            # name the most any window of either side shows (CUPTI drops
            # records, a few a window or half of one, and a name it lost
            # in every window of a side leaves that side no window); per
            # side the median window, graph over eager within
            # PROFILE_BAND.  The launches per side are recorded
            st_ = states[mk]
            modes = {"eager": False, "graph": None}
            wins = {k: [] for k in modes}
            for k in ("eager", "graph", "graph", "eager") * PROFILE_TURNS:
                wins[k].append(device_profile(m, st_, s, graph=modes[k],
                                              detail=True))
            most = {k: collections.Counter() for k in wins}
            for k, v in wins.items():
                for w in v:
                    most[k] |= collections.Counter(w["launches"])
            a_step = most["eager"] | most["graph"]
            seen = {k: [(step_device_ms(w["kernels"], a_step),
                         w["records"], w["dropped"]) for w in v]
                    for k, v in wins.items()}
            ms_ = {k: sorted(w[0] for w in v if w[0] is not None)
                   for k, v in seen.items()}
            if not all(ms_.values()):
                fail(f"graph {name}: no profiled window of a side holds "
                     f"every kernel a step launches ({dict(a_step)}; "
                     f"windows: ms, records, dropped {seen})")
            med = {k: v[len(v) // 2] for k, v in ms_.items()}
            row["profile"] = {k: {"device_ms": med[k], "windows": seen[k],
                                  "launches_equal": most[k] == a_step,
                                  "top_ms": wins[k][0]["top_ms"]}
                              for k in wins}
            ratio_ = med["graph"] / med["eager"]
            row["profile_graph_over_eager"] = ratio_
            if not PROFILE_BAND[0] <= ratio_ <= PROFILE_BAND[1]:
                fail(f"graph {name}: profiled device ms under graph "
                     f"{ratio_:.4f}x eager, outside {PROFILE_BAND} "
                     f"(windows: ms, records, dropped {seen})")
        row["seconds"] = time.perf_counter() - t_cfg
        graph_res[name] = row
        del entry, device, case
    for m in graph_models.values():
        m.graphs.clear()
    del graph_models, states
    torch.cuda.empty_cache()
    idles = {c: graph_res[c]["idle"] for c in IDLE_CFGS}
    # under graph the host keeps no share of the step: the graph's idle
    # at the floor, and below eager's where eager's is above it
    idle_bad = [c for c, v in idles.items()
                if not (v["graph"] <= IDLE_FLOOR and (
                    v["graph"] < v["eager"] or v["eager"] <= IDLE_FLOOR))]
    emit("graph", card=smi, steps=GRAPH_STEPS, iters=GRAPH_ITERS,
         ell_iters=ELL_GRAPH_ITERS, peer_model_seconds=peer_build_s,
         configs=graph_res,
         slower_than_eager=graph_slower,
         slower_limit=GRAPH_SLOWER, profile_band=PROFILE_BAND,
         idle_floor=IDLE_FLOOR, idle=idles, idle_not_removed=idle_bad,
         phase_s=time.perf_counter() - t_phase)
    if graph_slower:
        fail(f"graph: the graph step is slower than eager by more than "
             f"{GRAPH_SLOWER}x in {graph_slower}")
    if idle_bad:
        fail(f"graph: the host keeps a share of the step under graph in "
             f"{ {c: idles[c] for c in idle_bad} } (floor {IDLE_FLOOR})")

    # ---- kbench: its three drives through kbench.main, each counted and
    # --check'ed against the golden (its own mesh: NX³, seed 0 — gmesh)
    kb_runs = {}
    for drive, (names, k1_names) in KB_RUNS.items():
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = kbench.main(["--nx", str(NX), "--bp", str(KB_BP), "--iters",
                              str(KB_ITERS), "--variants", ",".join(names),
                              "--check"])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        out_lines = buf.getvalue().splitlines()
        if rc != 0:
            fail(f"kbench ({drive}) exited {rc}: {out_lines}")
        checked = [n for n in names if n in kbench.TOLS]
        bad = [n for n in checked
               if not any(ln.startswith(f"check {n}:") and ln.endswith("OK")
                          for ln in out_lines)]
        if bad:
            fail(f"kbench ({drive}): no passing golden check for {bad}")
        twin_counts = {k: counts.pop(k) for k in list(counts)
                       if k in twins.launch_counters()}
        expect_counts(f"kbench ({drive})", counts, k1_names)
        for row, (_, d, inst) in TWIN_ROWS.items():
            if d == drive:
                launches[row] = twin_counts.get(inst, 0)
                bench_launches[row] = launches[row]     # all kbench's loop
                if not launches[row]:
                    fail(f"kbench ({drive}) launched no {inst} ({row})")
        kb_runs[drive] = {"seconds": seconds, "output": out_lines,
                          "launches": counts, "twin_launches": twin_counts}

    # the same tables (kbench's plan on gmesh), each twin, each rung and
    # the K1 instances only kbench launches against their plain versions
    t0 = time.perf_counter()
    benches = kbench.make_benches(gmesh, bp=KB_BP, device=dev)
    names = [n for ns, _ in KB_RUNS.values() for n in ns]
    table = kbench.variant_table(benches, names)
    t_bench = time.perf_counter() - t0

    def operands(t):
        return t["srcs"], t["slot_w"], t["scale"], t["block_ids"], t["slots"]

    def plain_of(ref, extra="", **kw):
        """A row's plain version as a function of (var_T, tables)."""
        return lambda v, t: ref(v, *operands(t),
                                *((t[extra],) if extra else ()), **kw)

    o16 = {"out_dtype": torch.bfloat16}
    kb_plain = {
        "stream": plain_of(twins.stream_twin_ref),
        "cstream_c": plain_of(twins.stream_twin_ref),
        "cstream_bso": plain_of(twins.stream_twin_ref, **o16),
        "wsum": plain_of(twins.wsum_twin_ref),
        "nv7": plain_of(twins.nv7_sweep_ref),
        "sweep_blocks_d16": plain_of(bs.sweep_blocks_ref),
        "sweep_blocks_w16": plain_of(bs.sweep_blocks_ref),
        "sweep_blocks_v16_w16_d16_o16": plain_of(bs.sweep_blocks_ref, **o16),
        "compact_i8": plain_of(twins.i8_sweep_ref, "i8_scale"),
        "bso_fold": plain_of(twins.bso_twin_ref),
        "bso_wsum": plain_of(twins.bso_twin_ref, "wsum", hoist_own=True),
        "bso_acc3": plain_of(twins.bso_acc3_twin_ref),
        "cflux_fact": plain_of(twins.flux_fact_twin_ref),
        "cstream_flux": plain_of(twins.stream_flux_twin_ref)}
    kb_variant = {**{r: v for r, (v, _, _) in TWIN_ROWS.items()},
                  "sweep_blocks_d16": "bf16src", "sweep_blocks_w16": "w16",
                  "sweep_blocks_v16_w16_d16_o16": "var16"}
    kb_extra = {"bso_wsum": "wsum", "compact_i8": "i8_scale"}
    for row, name in kb_variant.items():
        fn, v, t = table[name]
        compare_and_time(row, lambda i: fn(v, t),
                         lambda i: kb_plain[row](v, t))
        op = kbench.VARIANTS[name][4]
        out_b = 2 if kbench.VARIANTS[name][3] == torch.bfloat16 else 4
        work[row] = sweep_bound(op, (v, *operands(t)), gather=False,
                                out_bytes=out_b, extra=kb_extra.get(row, ""))
    # K5g and K5f's fold form add K1-w16-d16-o16's products in its order
    kb_out = {n: table[n][0](*table[n][1:])
              for n in (*KB_BITWISE, "compact_bso")}
    for n in KB_BITWISE:
        differ = int((kb_out[n] != kb_out["compact_bso"]).sum())
        if differ:
            fail(f"kbench: {n} differs from compact_bso at {differ} "
                 f"elements (expected bit for bit)")
    # the bench's --check fingerprints (f32 sums): the int8 rung's output
    # differs from K1-w16-d16-o16's, and so must its fingerprint
    fingerprints = {ln.split()[1].rstrip(":"): float(ln.split()[4])
                    for r in kb_runs.values() for ln in r["output"]
                    if ln.startswith("check ")}
    if fingerprints["compact_i8"] == fingerprints["compact_bso"]:
        fail("kbench --check prints one fingerprint for compact_i8 and "
             "compact_bso")
    # the bench loop's chained update v + 1e-30·g[:, :NV] on the f32 state
    # and on var16's bf16 state: the part of a paired ratio of the bench
    # that is not the kernel's
    g16 = kb_out["compact_bso"]
    update_ms = {
        k: cuda_ms(lambda v=table[n][1]: v + 1e-30 * g16[:, :v.shape[1]], 50)
        for k, n in (("f32_state", "compact_bso"), ("bf16_state", "var16"))}
    del kb_out, g16
    # the verdict pairs in turns (A, B, B, A), CUDA-event means of 50 calls
    verdicts = {}
    for a, b in KB_VERDICTS:
        fa, fb = (lambda n=n: table[n][0](*table[n][1:]) for n in (a, b))
        a1, b1 = cuda_ms(fa, 50), cuda_ms(fb, 50)
        b2, a2 = cuda_ms(fb, 50), cuda_ms(fa, 50)
        ta, tb = min(a1, a2), min(b1, b2)
        verdicts[f"{a}/{b}"] = {"ratio": ta / tb, f"{a}_ms": ta,
                                f"{b}_ms": tb}
    b0 = benches[""]
    emit("kbench", card=smi, bp=KB_BP, nblocks=b0.plan.nblocks,
         kslots=b0.plan.kslots, wks=list(b0.wks["prefix"]),
         bench_seconds=t_bench, runs=kb_runs, verdicts=verdicts,
         bitwise_compact_bso=list(KB_BITWISE),
         check_fingerprints=fingerprints, chained_update_ms=update_ms,
         kernels=kernel_summary(list(kb_variant)))
    del benches, table


    # ---- the peer transport in one process: K3's peer form (address
    # table, readiness barrier, arrival flags, last-ticket wait) inside one
    # launch, at P=1 (force_rdma self-sends) and P=8, held bitwise against
    # the loopback overlap step of the same plans
    def peer_phase(path, loop_model, key, names, band=(None, GOLDEN_TOL)):
        """The graph phase's peer model `key` (built there, its build
        seconds recorded) against `loop_model`."""
        pmod, t_model = peer_models[key], peer_build_s[key]
        reset_counts()
        state = pmod.distribute_state(gvar, schedules=["overlap"])
        g = pmod.step(state, "overlap")
        counts = read_counts()
        expect_counts(path, counts, names)
        rel = golden_relmax(pmod, g)
        lo, hi = band
        if not (rel <= hi and (lo is None or rel > lo)):
            fail(f"{path}: overlap vs golden relmax {rel:.3e} outside "
                 f"({lo}, {hi}]")
        lstate = loop_model.distribute_state(gvar, schedules=["overlap"])
        g_loop = loop_model.step(lstate, "overlap")
        torch.cuda.synchronize()
        if not torch.equal(g, g_loop):
            fail(f"{path}: overlap through the peer transport differs from "
                 f"the loopback overlap step")
        info = {"model_seconds": t_model, "transport": pmod.transport_name,
                "kernel_phases": pmod.kernel_phases,
                "vs_golden_relmax": rel, "band": [lo, hi],
                "equals_loopback_bitwise": True, "launches": counts}
        if len(pmod.parts) > 1:
            info["ghost_columns_checked"] = ghost_check(path, pmod, g)
        return pmod, state, lstate, info

    def overlap_turns(pmod, pstate, lmod, lstate):
        """The overlap step through both transports in turns (loopback,
        peer, peer, loopback), the better median of each, each under its
        dispatch (graph on the card for both since the peer transport's
        launch epochs are device words), so the turns compare transports;
        with the dispatch each took."""
        ms = {"loopback": [], "peer": []}
        for name in ("loopback", "peer", "peer", "loopback"):
            m, st_ = (pmod, pstate) if name == "peer" else (lmod, lstate)
            ms[name].append(time_schedule(m, st_, "overlap", TIMED_STEPS,
                                          warmup=2, repeats=5).median * 1e3)
        how = {k: compiled.dispatch(m, "overlap")[0]
               for k, m in (("loopback", lmod), ("peer", pmod))}
        if how != {"loopback": "graph", "peer": "graph"}:
            fail(f"overlap turns: dispatch {how}, expected graph for both")
        return {**{k: min(v) for k, v in ms.items()}, "dispatch": how}

    pm1, pstate, lstate, info = peer_phase(
        "peer_p1", packed_models[1], "peer_p1",
        ("sweep_blocks_overlap_peer",))
    info["overlap_step_ms"] = overlap_turns(pm1, pstate, packed_models[1],
                                            lstate)
    emit("peer_p1", card=smi, parts=1, force_rdma=True, steps=TIMED_STEPS,
         **info)
    pm1.close()
    del pm1, pstate, lstate

    pm8, pstate, lstate, info = peer_phase(
        "peer_p8", packed_models[P_MULTI], "peer_p8",
        ("sweep_blocks_overlap_peer",))
    # the f32 results a two-process run must reproduce bit for bit
    lm8 = packed_models[P_MULTI]
    st_all = lm8.distribute_state(gvar)
    want_digest = {s: workers.digest(lm8.gather_global(lm8.step(st_all, s)))
                   for s in ("bulk", "early", "overlap")}
    del st_all
    # and the overlap chain it must reproduce under graph: GRAPH_STEPS
    # steps at a coupling that moves the state, the final state's digest
    w2_coupling = GRAPH_MOVE / float(
        lm8.step(lstate, "overlap")[:, :NV].float().abs().max())
    want_chain = workers.digest(lm8.iterate_fn(
        "overlap", GRAPH_STEPS, coupling=w2_coupling)(
        *lm8.iter_args(lstate)).cpu().numpy())
    lm8.graphs.clear()
    info["overlap_step_ms"] = overlap_turns(pm8, pstate, lm8, lstate)
    prof = {"peer": device_profile(pm8, pstate, "overlap"),
            "loopback": device_profile(lm8, lstate, "overlap")}
    info["profile"] = prof
    info["idle"] = {k: (None if p_["device_ms"] is None else
                        1.0 - p_["device_ms"] / info["overlap_step_ms"][k])
                    for k, p_ in prof.items()}
    # K3's peer form against its plain version and beside the loopback
    # form, at the P=8 interior + push shapes: packed f32, gather, and the
    # packed full bf16 stack
    peer_rows = {}
    for row, lmod, fused, plain, wire, flags in (
            ("sweep_blocks_overlap_peer", lm8, bs.sweep_blocks_overlap,
             bs.sweep_blocks_overlap_ref, torch.float32, (0, 0, 0, 0)),
            ("sweep_blocks_overlap_gather_peer", gather_models[P_MULTI],
             bs.sweep_blocks_overlap_gather,
             bs.sweep_blocks_overlap_gather_ref, torch.float32, (1, 0, 0, 0)),
            ("sweep_blocks_overlap_peer_w16_d16_o16", full_stack_p8,
             bs.sweep_blocks_overlap, bs.sweep_blocks_overlap_ref,
             torch.bfloat16, (0, 1, 1, 1))):
        state = lmod.distribute_state(gvar, schedules=["overlap", "bulk"])
        iargs = (state["var_T"], *lmod._operands("interior",
                                                 state["tables"]))
        kw = lmod._gather_kw("interior")
        gb = lmod.step(state, "nocomm")             # any finite init
        sendbufs = lmod._pack(gb, lmod.pack_scale, wire)
        peer = Peer(lmod.dsts.numpy(), lmod.srcs.numpy(), rows=lmod.rows,
                    s_max=lmod.s_max, dtype=wire, device=dev)
        compare_and_time(
            row,
            lambda i: fused(*iargs, i, sendbufs, None, None, peer=peer,
                            **kw),
            lambda i: plain(*iargs, i, sendbufs, lmod.dsts, lmod.srcs),
            init=gb, push=True)
        work[row] = sweep_bound(
            "gg", iargs, gather=lmod.kernel == "gather", init=True,
            push=sendbufs, out_bytes=gb.element_size())
        buf = gb.clone()
        kp = lambda: fused(*iargs, buf, sendbufs, None, None, peer=peer,
                           **kw)
        kl = lambda: fused(*iargs, buf, sendbufs, lmod.dsts, lmod.srcs,
                           **kw)
        # the peer form equals its loopback form bit for bit
        g_p, r_p = fused(*iargs, gb.clone(), sendbufs, None, None,
                         peer=peer, **kw)
        g_p, r_p = g_p.clone(), r_p.clone()
        g_l, r_l = fused(*iargs, gb.clone(), sendbufs, lmod.dsts, lmod.srcs,
                         **kw)
        torch.cuda.synchronize()
        if not (torch.equal(g_p, g_l) and torch.equal(r_p, r_l)):
            fail(f"{row} differs from its loopback form")
        del g_p, r_p, g_l, r_l
        l1, p1 = cuda_ms(kl, 50), cuda_ms(kp, 50)
        p2, l2 = cuda_ms(kp, 50), cuda_ms(kl, 50)
        modes = {m: cuda_ms(lambda m=m: fused(*iargs, buf, sendbufs, None,
                                              None, peer=peer, debug=m,
                                              **kw), 50)
                 for m in ("nobar", "nodma")}
        peer_rows[row] = {"peer_ms": min(p1, p2), "loopback_ms": min(l1, l2),
                          "peer_over_loopback": min(p1, p2) / min(l1, l2),
                          **{f"{m}_ms": v for m, v in modes.items()},
                          # back to back on the card, no host gaps (the
                          # loopback wrapper's time includes its fill of
                          # recv, a kernel of its own)
                          "peer_kernel_device_ms": kernel_device_ms(
                              kp, 20),
                          "loopback_kernel_device_ms": kernel_device_ms(
                              kl, 20)}
        if peer_rows[row]["peer_over_loopback"] > PEER_OVER_LOOPBACK:
            fail(f"{row}: {peer_rows[row]['peer_over_loopback']:.4f}x its "
                 f"loopback form, above {PEER_OVER_LOOPBACK}")
        # the instance's registers, local bytes, shared memory and resident
        # blocks per SM (the gather row: the body the rule picks)
        least = PEER_MIN_BLOCKS
        if lmod.kernel == "gather":
            plan = gather_facts(bs, lmod, "interior", fused=True, peer=True)
            facts = plan.pop("kernel")
            peer_rows[row]["plan"] = plan
            if plan["body"] == "staged":
                least = STAGED_MIN_BLOCKS
        else:
            facts = _cuda.kernel_info("cfd_overlap_peer_info", *flags)
        if facts["blocks_per_sm"] < least:
            fail(f"{row}: {facts['blocks_per_sm']} resident blocks per SM, "
                 f"below {least}")
        peer_rows[row]["kernel"] = facts
        times[row]["kernel"] = facts
        peer.close()
        del state, iargs, gb, sendbufs, buf, peer, kp, kl
    # the gather and bf16 peer forms through the model too, counted
    for row, lmod, key in (
            ("sweep_blocks_overlap_gather_peer", gather_models[P_MULTI],
             "peer_gather_p8"),
            ("sweep_blocks_overlap_peer_w16_d16_o16", full_stack_p8,
             "peer_full_p8")):
        m_, _, _, sub = peer_phase(
            "peer_p8", lmod, key, (row,),
            band=(BAND_FULL if key == "peer_full_p8" else (None, GOLDEN_TOL)))
        m_.close()
        info[row] = sub
        del m_
    emit("peer_p8", card=smi, parts=P_MULTI, steps=TIMED_STEPS,
         kernels=kernel_summary(list(peer_rows)), beside_loopback=peer_rows,
         **info)
    pm8.close()
    del pm8, pstate, lstate, full_stack_p8, peer_models

    # ---- two processes on the one GPU (time-sliced: a check, no timing):
    # 96^3, P=8, W=2, every schedule through peer (mapped memory, K3's peer
    # form across processes) and through dist over gloo, staged through the
    # host; then slice_size 4, where overlap mixes in-kernel and collective
    # phases.  Digests of every rank's gathered outputs against this
    # process's loopback results.
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    mode = mode.splitlines()[0].strip() if mode else "unknown"
    if mode == "Exclusive_Process":
        emit("peer_w2", not_runnable=f"compute mode {mode}")
    else:
        def w2case(**model):
            return workers.ModelCase(
                nx=NX, ny=NX, nz=NX, parts=P_MULTI, device="cuda", nvar=NVAR,
                mesh_seed=SEED, state_seed=SEED + 1, diag_frac=0.2,
                backend="gloo", share_device=True, timed_steps=PEER_STEPS,
                digest=True, model=model)

        # the routed plan's own one-process result (another phase coloring,
        # so another ghost layout and summation order than slice_size None)
        rm8 = GreenGaussTorch(parts8, NVAR, device=dev, slice_size=4)
        st_all = rm8.distribute_state(gvar)
        routed = {s: rm8.step(st_all, s) for s in ("bulk", "early", "overlap")}
        rel, cross, scale = check_schedules("peer_w2 (slice_size 4, one "
                                            "process)", rm8, routed)
        routed_digest = {s: workers.digest(rm8.gather_global(g))
                         for s, g in routed.items()}
        routed_info = {"kernel_phases": rm8.kernel_phases,
                       "collective_phases": rm8.coll_phases,
                       "vs_golden_relmax": rel}
        if not (rm8.kernel_phases and rm8.coll_phases):
            fail("peer_w2: slice_size 4 left no phase to route")
        del rm8, st_all, routed
        torch.cuda.empty_cache()
        jobs = {"peer": w2case(transport="peer"),
                "dist": w2case(transport="dist"),
                "slice4": w2case(transport="peer", slice_size=4)}
        t0 = time.perf_counter()
        # the peer job's overlap chain under graph in both processes (the
        # device launch epochs advance in lock step across them), held
        # against eager per rank and against the one-process chain
        res = launch.spawn(2, workers.batch,
                           ([("model_outputs", (c,)) for c in jobs.values()]
                            + [("overlap_chain", (jobs["peer"], GRAPH_STEPS,
                                                  w2_coupling))],),
                           timeout_s=PEER_W2_LIMIT_S)
        w2 = {"seconds": time.perf_counter() - t0, "compute_mode": mode,
              "note": "two processes on one GPU, time-sliced: step_ms is "
                      "no measure of speed"}
        for i, (name, want) in enumerate((("peer", want_digest),
                                          ("dist", want_digest),
                                          ("slice4", routed_digest))):
            for r in res:
                if r[i]["outputs"] != want:
                    fail(f"peer_w2 ({name}): rank {r[i]['rank']} differs "
                         f"from the one-process result")
            w2[name] = {k: res[0][i][k] for k in (
                "transport", "kernel_phases", "collective_phases", "step_ms",
                "launches")}
            w2[name]["launches_rank1"] = res[1][i]["launches"]
            w2[name]["equals_one_process_bitwise"] = True
        for name, tname in (("peer", "peer+dist/gloo-staged"),
                            ("dist", "dist/gloo-staged"),
                            ("slice4", "peer+dist/gloo-staged")):
            if w2[name]["transport"] != tname:
                fail(f"peer_w2 ({name}): transport {w2[name]['transport']}")
        for name in ("peer", "slice4"):
            if not w2[name]["launches"].get("sweep_blocks_overlap_peer"):
                fail(f"peer_w2 ({name}): no launch of K3's peer form")
        if w2["dist"]["launches"].get("sweep_blocks_overlap_peer"):
            fail("peer_w2 (dist): launched the peer form")
        chain = [r[len(jobs)] for r in res]
        for c in chain:
            if not (c["dispatch"] == "graph" and c["graph_equals_eager"]
                    and c["digest"] == want_chain and c["moved"] > 1e-3
                    and c["replay_kernels"] > 0
                    and c["launches"].get("sweep_blocks_overlap_peer")):
                fail(f"peer_w2 (peer chain): rank {c['rank']}: {c}")
        w2["peer_chain"] = {"steps": GRAPH_STEPS, "coupling": w2_coupling,
                            "dispatch": "graph",
                            "graph_equals_eager_per_rank": True,
                            "equals_one_process_bitwise": True,
                            "moved": [c["moved"] for c in chain],
                            "replay_kernels": chain[0]["replay_kernels"],
                            "launches": [c["launches"] for c in chain]}
        if (w2["slice4"]["kernel_phases"] != routed_info["kernel_phases"]
                or not w2["slice4"]["collective_phases"]):
            fail(f"peer_w2 (slice4): phases {w2['slice4']}")
        emit("peer_w2", card=smi, parts=P_MULTI, ranks=2,
             slice4_one_process=routed_info, **w2)

    # ---- NCCL at one rank: the group comes up and one phase buffer goes
    # through Dist as a self-send on the backend (batch_isend_irecv)
    import tempfile

    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            tr = Dist([[(0, 0)]], 1, dist.group.WORLD, dev, self_sends=True)
            buf = torch.randn((1, 1, 24, lm8.s_max), device=dev,
                              generator=torch.Generator(dev).manual_seed(7))
            t0 = time.perf_counter()
            got = tr.exchange(buf)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ok = bool(torch.equal(got, buf))
            total = torch.ones(4, device=dev)
            dist.all_reduce(total)
            torch.cuda.synchronize()
            emit("nccl_w1", card=smi, transport=tr.name,
                 nccl=".".join(map(str, torch.cuda.nccl.version())),
                 self_send_bitwise=ok, bytes=nbytes(buf),
                 first_exchange_seconds=first_s,
                 all_reduce_ok=bool((total == 1).all()))
            if tr.name != "dist/nccl" or not ok:
                fail("nccl_w1: the self-send through dist/nccl differs")
        finally:
            dist.destroy_process_group()
    del lm8

    # ---- the push bench: the tool at one rank (self-sends), the
    # reference's grid, every mode, counted; then K6 against its plain
    # version (bitwise) and beside Tensor.copy_ of the same bytes, in turns
    ici = {}
    reset_counts()
    for m in push.MODES:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = icibench.main(["--phases", *map(str, ICI_PHASES), "--mb",
                                *map(str, ICI_MB), "--mode", m])
        lines = buf.getvalue().splitlines()
        rows_ = [ln.split() for ln in lines
                 if ln.strip() and ln.split()[0].isdigit()]
        if rc != 0 or len(rows_) != len(ICI_PHASES) * len(ICI_MB):
            fail(f"icibench --mode {m}: rc {rc}, output {lines}")
        if not all(r[-1] == "dispatch=graph" for r in rows_):
            fail(f"icibench --mode {m}: a row's chain did not replay as a "
                 f"graph: {lines}")
        if any("suggested" in ln for ln in lines):
            fail("icibench printed a link suggestion without --link-gbps")
        ici[m] = {"seconds": time.perf_counter() - t0, "output": lines}
    counts = read_counts()
    expect_counts("icibench", counts,
                  [f"push_phases_{m}" for m in push.MODES])

    def k6_setup(nph, mb):
        lanes = icibench.payload_lanes(mb, 24)
        peer = icibench.make_transport(1, nph, 24, lanes, dev, None)
        send = torch.randn((1, nph, 24, lanes), device=dev,
                           generator=torch.Generator(dev).manual_seed(nph))
        return peer, send, Loopback(np.zeros((1, nph), np.int64), dev)

    # the grid, mode full: K6, copy_, copy_, K6 (CUDA-event means of 50)
    grid = []
    for nph in ICI_PHASES:
        for mb in ICI_MB:
            peer, send, plain_t = k6_setup(nph, mb)
            got = push.push_phases(send, peer, "full")
            if not torch.equal(got, push.push_phases_ref(send, plain_t)):
                fail(f"push_phases (full, {nph} x {mb} MB) differs from its "
                     f"plain version")
            dst = torch.empty_like(send)
            k1 = cuda_ms(lambda: push.push_phases(send, peer, "full"), 50)
            c1 = cuda_ms(lambda: dst.copy_(send), 50)
            c2 = cuda_ms(lambda: dst.copy_(send), 50)
            k2 = cuda_ms(lambda: push.push_phases(send, peer, "full"), 50)
            b = bound(2 * nbytes(send), 0)
            kd = kernel_device_ms(
                lambda: push.push_phases(send, peer, "full"), 20)
            cd = kernel_device_ms(lambda: dst.copy_(send), 20)
            grid.append({"phases": nph, "mb_per_phase": nbytes(send) / nph
                         / 1e6, "ms": min(k1, k2), "copy_ms": min(c1, c2),
                         "device_ms": kd, "copy_device_ms": cd,
                         "bound_ms": b["bound_ms"],
                         "share": b["bound_ms"] / kd,
                         "copy_share": b["bound_ms"] / cd})
            peer.close()
            del peer, send, dst, got
    def chain_ms(send, peer, m, graph):
        """ms per iteration of the push bench's chain
        (`icibench.chained_runner`), under graph (None) or eager (False):
        two-point samples of ICI_CHAIN_ITERS, the median of five."""
        host = icibench.chain_host(peer, dev)
        run = icibench.chained_runner(send, peer, m, host, graph=graph)
        n0 = ICI_CHAIN_ITERS // 10
        run(n0)
        run(n0 + ICI_CHAIN_ITERS)
        sample = two_point_sampler(lambda: run(n0),
                                   lambda: run(n0 + ICI_CHAIN_ITERS),
                                   ICI_CHAIN_ITERS)
        vals = [v for v in (sample() for _ in range(5)) if v is not None]
        host.graphs.clear()
        return float(np.median(vals)) * 1e3 if vals else None

    def chain_graph_equals_eager(send, peer, m):
        """GRAPH_STEPS chained pushes at a coupling that moves the state,
        under graph and eager: bit for bit equal."""
        out = {}
        for graph in (None, False):
            host = icibench.chain_host(peer, dev)
            out[graph] = icibench.chained_runner(
                send, peer, m, host, graph=graph, coupling=0.25)(GRAPH_STEPS)
            host.graphs.clear()
        return (torch.equal(out[None], out[False])
                and not torch.equal(out[None], send))

    # the fixed cost per mode: every mode at the smallest payload, back to
    # back on the card (kernel_device_ms: launches this short, enqueued onto
    # an idle stream, would measure the host's launch rate), and the push
    # bench's chain per iteration under graph and eager (the fixed cost
    # per launch under replay)
    fixed, fixed_chain = {}, {}
    for nph in (1, 4):
        peer, send, _ = k6_setup(nph, ICI_MB[0])
        order = (*push.MODES, *reversed(push.MODES))
        ms = {}
        for m in order:
            ms.setdefault(m, []).append(kernel_device_ms(
                lambda m=m: push.push_phases(send, peer, m), 100))
        fixed[f"{nph}x{ICI_MB[0]}MB"] = {m: min(v) for m, v in ms.items()}
        fixed_chain[f"{nph}x{ICI_MB[0]}MB"] = {
            m: {"graph_ms": chain_ms(send, peer, m, None),
                "eager_ms": chain_ms(send, peer, m, False)}
            for m in push.MODES}
        peer.close()
        del peer, send
    k6_facts = _cuda.kernel_info("cfd_push_phases_info")
    # the kernel-table rows: each mode at ICI_ROW
    nph, mb = ICI_ROW
    k6_device, k6_chain = {}, {}
    peer, send, plain_t = k6_setup(nph, mb)
    dst = torch.empty_like(send)
    for m in push.MODES:
        row = f"push_phases_{m}"
        got = push.push_phases(send, peer, m)
        want = push.push_phases_ref(send, plain_t, m)
        torch.cuda.synchronize()
        moved = send if m in ("full", "nobar") else send[:, :1]
        same = got if m in ("full", "nobar") else got[:, :1]
        if not torch.equal(same, want[:, :moved.shape[1]]):
            fail(f"{row} differs from its plain version")
        errs[row], scales[row] = 0.0, float(want.abs().max())
        times[row] = paired_ms(
            lambda m=m: push.push_phases(send, peer, m),
            lambda m=m: push.push_phases_ref(send, plain_t, m))
        work[row] = bound(2 * nbytes(moved), 0)
        library[row] = cuda_ms(
            lambda: dst[:, :moved.shape[1]].copy_(moved), 50)
        k6_device[row] = kernel_device_ms(
            lambda m=m: push.push_phases(send, peer, m), 20)
        times[row]["kernel"] = k6_facts
        if not chain_graph_equals_eager(send, peer, m):
            fail(f"{row}: the push bench's chain under graph differs from "
                 f"eager (or did not move)")
        k6_chain[row] = {"graph_ms": chain_ms(send, peer, m, None),
                         "eager_ms": chain_ms(send, peer, m, False),
                         "graph_equals_eager": True}
    peer.close()
    del peer, send, dst
    emit("icibench", card=smi, ranks=1, runs=ici, launches=counts,
         rows_dispatch="graph", grid_full=grid, fixed_cost_ms=fixed,
         fixed_cost_chain_ms=fixed_chain, chain_iters=ICI_CHAIN_ITERS,
         kernel=k6_facts,
         kernels={f"push_phases_{m}": {
             **times[f"push_phases_{m}"], **work[f"push_phases_{m}"],
             "copy_ms": library[f"push_phases_{m}"],
             "device_ms": k6_device[f"push_phases_{m}"],
             "chain_ms": k6_chain[f"push_phases_{m}"]}
             for m in push.MODES})

    # ---- the ELL model (--backend xla, models/gradients_ell.py: plain
    # torch, no kernel of the port) at 96^3, P=1 and P=8, f32 and f64:
    # every schedule against the golden and bulk; f64 exact raw sums bit
    # for bit the golden loop on each shard's plan faces; every schedule's
    # step median and device profile beside the kernel path's
    for npart, path in ((1, "ell_p1"), (P_MULTI, "ell_p8")):
        t_path = time.perf_counter()
        res = {}
        for dname in ("float32", "float64"):
            f64 = dname == "float64"
            t0 = time.perf_counter()
            em = GreenGaussModel(parts if npart == 1 else parts8, NVAR,
                                 dtype=DTYPES[dname], device=dev)
            t_model = time.perf_counter() - t0
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            var = em.distribute_state(gvar)
            outs = {s: em.step(var, s) for s in ("bulk", "early", "overlap")}
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            if counts:
                fail(f"{path}: the ELL model launched kernels {counts}")
            rel = {s: golden_relmax(em, g) for s, g in outs.items()}
            scale = float(outs["bulk"].abs().max())
            cross = {s: float((outs[s] - outs["bulk"]).abs().max())
                     for s in ("early", "overlap")}
            gate, xtol = (ELL_F64_TOL, ELL_F64_TOL) if f64 else \
                (GOLDEN_TOL, SCHED_TOL)
            for s, r in rel.items():
                if not r <= gate:
                    fail(f"{path} {dname}: {s} vs golden {r:.3e} > {gate}")
            for s, v in cross.items():
                if not v <= xtol * scale:
                    fail(f"{path} {dname}: {s} vs bulk {v:.3e} > {xtol} x "
                         f"{scale:.3e}")
            entry = {"model_seconds": t_model, "nphases": len(em.perms),
                     "npoint_pad": em.npoint_pad,
                     "reduce_bytes": reduce_bytes(em.dsweep, 3 * NVAR,
                                                  em.dtype),
                     "peak_alloc_bytes": peak, "vs_golden_relmax": rel,
                     "cross": cross, "max_abs_bulk": scale,
                     "tol": [gate, xtol]}
            del outs
            if f64:
                t0 = time.perf_counter()
                raw = sweep_bulk(var, em.dsweep, exact=True).cpu().numpy()
                vh = var.cpu().numpy()
                for i, plan in enumerate(em.plans):
                    want = compute_gradients_gg(vh[i], plan.faces,
                                                plan.normals)
                    if not np.array_equal(raw[i],
                                          want.reshape(len(vh[i]), -1)):
                        fail(f"{path}: exact raw sums of shard {i} differ "
                             f"from the golden loop on its plan faces")
                del raw
                ex = {s: em.step(var, s, exact=True)
                      for s in ("bulk", "early", "overlap")}
                if not all(torch.equal(g, ex["bulk"]) for g in ex.values()):
                    fail(f"{path}: exact schedules differ from bulk")
                entry["exact_vs_golden_relmax"] = golden_relmax(
                    em, ex["bulk"])
                del ex
                entry.update(exact_raw_sums_bitwise_golden=True,
                             exact_schedules_bitwise=True,
                             exact_check_seconds=time.perf_counter() - t0)
            ms = {s: time_schedule(em, var, s, ELL_STEPS, warmup=1,
                                   repeats=3).median * 1e3
                  for s in ("bulk", "early", "overlap", "nocomm")}
            if not all(np.isfinite(v) for v in ms.values()):
                fail(f"{path} {dname}: step timing below the noise floor")
            prof = {s: device_profile(em, var, s, n=ELL_PROFILE_STEPS)
                    for s in ms}
            entry.update(step_ms=ms, faces_per_sec={
                s: nface / (v * 1e-3) for s, v in ms.items()},
                device_ms={s: p_["device_ms"] for s, p_ in prof.items()},
                idle={s: (None if p_["device_ms"] is None
                          else 1.0 - p_["device_ms"] / ms[s])
                      for s, p_ in prof.items()},
                top_ms={s: p_["top_ms"] for s, p_ in prof.items()})
            res[dname] = entry
            del em, var
            torch.cuda.empty_cache()
        emit(path, card=smi, parts=npart, steps=ELL_STEPS,
             kernel_path_step_ms=step_ms[npart],
             seconds=time.perf_counter() - t_path, **res)

    # ---- the golden tool: dump, then check with the golden (bitwise), a
    # perturbed seed (exit 1), the kernel model at P=4 overlap (1e-5) and
    # the ELL model in f64 (1e-12), on the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nc = os.path.join(tmp, "golden.nc")
        mesh_opt = ["--nx", str(GT_NX)]
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            rcs = {"dump": golden_tool.main(["dump", *mesh_opt, "--out", nc]),
                   "golden": golden_tool.main(["check", *mesh_opt, "--ref",
                                               nc]),
                   "seed1": golden_tool.main(["check", *mesh_opt, "--ref", nc,
                                              "--seed", "1"])}
            for b in ("pallas", "xla"):
                rcs[b] = golden_tool.main(["check", *mesh_opt, "--ref", nc,
                                           "--backend", b, "--parts", "4",
                                           "--schedule", "overlap"])
        counts = read_counts()
    lines = out.getvalue().splitlines()
    want = {"dump": 0, "golden": 0, "seed1": 1, "pallas": 0, "xla": 0}
    if rcs != want:
        fail(f"golden_tool: exit codes {rcs}, expected {want}: {lines}")
    # the overlap step: the boundary zero-filled (K1), the interior fused
    expect_counts("golden_tool", counts, ("pack_srcs", "sweep_blocks",
                                          "sweep_blocks_overlap"))
    emit("golden_tool", nx=GT_NX, parts=4, exit_codes=rcs, output=lines,
         launches=counts, seconds=time.perf_counter() - t0)

    # ---- the fake exchange phases at P=8 (6 real phases, 2 padded ones
    # carrying 4096 owned columns each to the shard itself): packed overlap
    # (K3) and gather/512 overlap (K3-gather); owned columns against the
    # golden and across schedules; the overlap step in turns with the same
    # model without fake phases
    fake = {}
    for name, base, opts, k3 in (
            ("packed", packed_models[P_MULTI], {}, "sweep_blocks_overlap"),
            ("gather_bp512", gather_models[P_MULTI],
             {"bp": GATHER_BP, "kernel": "gather"},
             "sweep_blocks_overlap_gather")):
        t0 = time.perf_counter()
        fm = GreenGaussTorch(parts8, NVAR, device=dev, **opts, **FAKE)
        t_model = time.perf_counter() - t0
        reset_counts()
        st = fm.distribute_state(gvar)
        outs = {s: fm.step(st, s) for s in ("bulk", "early", "overlap")}
        counts = read_counts()
        expect_counts(f"fake_phases ({name})", counts, (k3,))
        rel = {s: golden_relmax(fm, g) for s, g in outs.items()}
        own = fm.ghost_start
        scale = float(outs["bulk"][..., :own].abs().max())
        cross = {s: float((outs[s][..., :own] - outs["bulk"][..., :own])
                          .abs().max()) for s in ("early", "overlap")}
        if not all(r <= GOLDEN_TOL for r in rel.values()):
            fail(f"fake_phases ({name}): owned columns vs golden {rel}")
        if not all(v <= SCHED_TOL * scale for v in cross.values()):
            fail(f"fake_phases ({name}): owned columns across schedules "
                 f"{cross}")
        del outs
        bst = base.distribute_state(gvar, schedules=["overlap"])
        turns = {"plain": [], "fake": []}
        for k in ("plain", "fake", "fake", "plain"):
            m_, st_ = (fm, st) if k == "fake" else (base, bst)
            turns[k].append(time_schedule(m_, st_, "overlap", TIMED_STEPS,
                                          warmup=2, repeats=5).median * 1e3)
        prof = {"plain": device_profile(base, bst, "overlap"),
                "fake": device_profile(fm, st, "overlap")}
        fake[name] = {"model_seconds": t_model, "bp": fm.bp,
                      "nphases": [base.nphases, fm.nphases],
                      "s_max": [base.s_max, fm.s_max],
                      "ndev": [base.ndev, fm.ndev],
                      "vs_golden_relmax": rel, "owned_cross": cross,
                      "max_abs_bulk_owned": scale, "launches": counts,
                      "overlap_step_ms": {k: min(v) for k, v in
                                          turns.items()},
                      "overlap_step_ms_turns": turns,
                      "device_ms": {k: p_["device_ms"] for k, p_ in
                                    prof.items()},
                      "top_ms": {k: p_["top_ms"] for k, p_ in prof.items()}}
        del fm, st, bst
    emit("fake_phases", card=smi, parts=P_MULTI, **FAKE, steps=TIMED_STEPS,
         **fake)

    # ---- --profile: the CLI's torch.profiler trace names K1's kernel
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            rc = solver_main(["--nx", str(PROF_NX), "--ny", str(PROF_NX),
                              "--nz", str(PROF_NX), "--schedule", "bulk",
                              "--iters", "20", "--warmup", "1", "--no-verify",
                              "--profile", tmp, "--json"])
        counts = read_counts()
        rep_ = json.loads(out.getvalue().strip().splitlines()[-1])
        with open(rep_["profile"]) as f:
            trace = json.load(f)
        trace_bytes = os.path.getsize(rep_["profile"])
    kern = [e["name"] for e in trace["traceEvents"]
            if e.get("cat") == "kernel"]
    k1 = sum("sweep_packed_kernel" in n for n in kern)
    if rc != 0 or not k1:
        fail(f"profile: rc {rc}, {k1} K1 events among {len(kern)} kernels")
    expect_counts("profile", counts, ("pack_srcs", "sweep_blocks"))
    emit("profile", nx=PROF_NX, trace_bytes=trace_bytes,
         kernel_events=len(kern), k1_events=k1,
         kernels_named=sorted({n[:96] for n in kern}),
         launches=counts, seconds=time.perf_counter() - t0)
    del trace, kern

    # ---- solver_attrib: the five knockout bodies at one shard, packed/AUTO
    # and gather/512 (bench loops: counted apart from the model paths)
    t0 = time.perf_counter()
    attrib = {}
    for name, m_, names in (("packed_auto", packed_models[1],
                             ("pack_srcs", "sweep_blocks")),
                            ("gather_bp512", gather_models[1],
                             ("sweep_blocks_gather",))):
        st = m_.distribute_state(gvar, schedules=["bulk"])
        reset_counts()
        got = solver_attrib.attribute(m_, st, solver_attrib.MODES,
                                      ATTRIB_STEPS, 3)
        counts = read_counts()
        expect_counts(f"solver_attrib ({name})", counts, names)
        if not all(got.values()):
            fail(f"solver_attrib ({name}): a mode fell below the noise "
                 f"floor: {got}")
        attrib[name] = {"bp": m_.bp, "ms": {k: float(np.median(v))
                                            for k, v in got.items()},
                        "ms_all": got, "launches": counts}
        del st
    emit("solver_attrib", card=smi, parts=1, steps=ATTRIB_STEPS,
         seconds=time.perf_counter() - t0, **attrib)

    # ---- the dry run: every leg at 8 shards on the card
    t0 = time.perf_counter()
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = dryrun.main(["--n", str(DRYRUN_N)])
    counts = read_counts()
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not rec["ok"] or not all(
            v.startswith("ran") for v in rec["legs"].values()):
        fail(f"dryrun: rc {rc}, {rec}")
    expect_counts("dryrun", counts, ("pack_srcs", "sweep_blocks",
                                     "sweep_blocks_overlap"))
    emit("dryrun", record=rec, launches=counts,
         seconds=time.perf_counter() - t0)

    # ---- the scaling model (host NumPy) on the card's measured inputs:
    # (a) its rate tables beside the P=1 bulk step re-measured through the
    # solver at SM_NX and the 96³ rates of `timing` and `reduced_p1`; (b)
    # its chain defaults beside the P=1 fake-phase chain; (c) its
    # predictions at 96³
    t0 = time.perf_counter()
    measured = [("f32", NX, nface, f32_bulk_s * 1e3, "timing"),
                ("reduced", NX, nface, reduced_bulk_s * 1e3, "reduced_p1")]
    for nx in SM_NX:
        reset_counts()
        r_ = scaling_inputs.rate_point(nx, verify=True)
        counts = read_counts()
        expect_counts(f"scaling_model (nx {nx})", counts,
                      ("pack_srcs", "sweep_blocks"))
        rel = r_["verification"]["bulk_vs_golden_relmax"]
        if not rel <= GOLDEN_TOL:
            fail(f"scaling_model: nx {nx} bulk vs golden relmax {rel:.3e}")
        measured.append(("f32", nx, r_["nface"], r_["step_ms"],
                         scaling_inputs.command(r_["argv"])))
    rates = []
    for rate, nx, nf, ms, how in measured:
        table = scaling_model.RATE_TABLES[rate]
        want = scaling_model.rate_ns_per_face(nf, table)
        floor_ms = min(f * r for f, r in table) * 1e-6
        got = ms * 1e6 / nf
        rates.append({"rate": rate, "nx": nx, "nface": nf, "step_ms": ms,
                      "ns_per_face": got, "table_ns_per_face": want,
                      "ratio": got / want, "from": how,
                      "table_floor_ms": floor_ms,
                      "on_launch_floor":
                          want * nf * 1e-6 < SM_FLOOR_X * floor_ms})
    nx, sends, iters = SM_CHAIN
    reset_counts()
    ch = scaling_inputs.chain_point(nx, scaling_inputs.CHAIN_PHASES, sends,
                                    iters, verify=True)
    counts = read_counts()
    expect_counts("scaling_model (chain)", counts, PACKED)
    ver = ch["verification"]
    pack_us = scaling_model.PACK_NS_PER_COL * ch["cols"] * 1e-3
    chain = {"command": scaling_inputs.command(ch["argv"]), "nx": nx,
             "nphases": ch["nphases"], "s_max": ch["s_max"],
             "cols": ch["cols"], "nocomm_us": ch["nocomm_median_s"] * 1e6,
             "bulk_minus_nocomm_us": ch["bulk_us"],
             "model_bulk_us": scaling_model.BULK_FIXED_US + pack_us,
             "overlap_minus_nocomm_us": ch["overlap_us"],
             "model_overlap_us": scaling_model.OVERLAP_FIXED_US + pack_us,
             "verification": ver, "launches": counts}
    cross = {k: v for k, v in ver.items() if k.endswith("_vs_bulk_maxabs")}
    if not (ver["bulk_vs_golden_relmax"] <= GOLDEN_TOL
            and all(v <= SM_CROSS_ABS for v in cross.values())):
        fail(f"scaling_model: the fake-phase chain's outputs {ver}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = scaling_model.main(["--nx", str(NX), "--parts",
                                 *map(str, SM_PARTS)])
    lines = out.getvalue().strip().splitlines()
    cols = ("shard_ns_per_face", "bulk_gfps", "overlap_gfps", "speedup",
            "eff_hide", "eff_slvr")
    pred = {int(ln.split()[0]): dict(zip(cols, ln.split()[1:]))
            for ln in lines[2:]}
    if (rc != 0 or not lines[0].startswith("# MODEL (not measurement)")
            or sorted(pred) != list(SM_PARTS)
            or not all(float(r["bulk_gfps"]) > 0
                       and float(r["overlap_gfps"]) > 0
                       for r in pred.values())):
        fail(f"scaling_model: the model at {NX}³ printed {lines}")
    emit("scaling_model", card=smi, rates=rates, ratio_limit=SM_RATIO,
         chain=chain, model={"header": lines[0], "rows": pred},
         seconds=time.perf_counter() - t0)
    off = [r for r in rates if not r["on_launch_floor"]
           and not 1 / SM_RATIO <= r["ratio"] <= SM_RATIO]
    if off:
        fail(f"scaling_model: measured rates off the table by more than "
             f"{SM_RATIO}x: {off}")

    # ---- the benchmark entry point, `python -m cfd_proxy_tpu_torch.bench`,
    # in a process of its own at its defaults (96³, every schedule, every
    # row, the model block); its kernels' launches come from its FULL_JSON
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    res = subprocess.run([sys.executable, "-m", "cfd_proxy_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    bench_wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"bench: exit {res.returncode}: {res.stderr[-3000:]}")
    try:
        comp = json.loads(res.stdout.strip().splitlines()[-1])
        full = json.loads(next(
            ln for ln in res.stderr.splitlines()
            if ln.startswith("FULL_JSON "))[len("FULL_JSON "):])
    except (IndexError, StopIteration, ValueError) as e:
        fail(f"bench: no compact line or FULL_JSON ({e}): "
             f"{res.stdout[-2000:]}")
    missing = [k for k in BENCH_KEYS if k not in comp]
    if (not (comp.get("value") or 0) > 0 or comp.get("platform") != "cuda"
            or missing or "dropped" in comp
            or sorted(comp["solver_ms_per_sweep"]) != ["2", "4"]):
        fail(f"bench: compact line {comp} (missing {missing})")
    counts = full["kernel_launches"]
    expect_counts("bench", counts, BENCH_LAUNCHED)
    bench_bulk_ms = full["schedules"]["bulk"]["median_ms"]
    # every row's dispatch (FULL_JSON): on the card at one rank, the graph
    rp, sm_ = full["reduced_precision"], full["solver_mode"]
    row_dispatch = {
        "main": full["dispatch"], "reduced": rp["dispatch"],
        "with_bf16_grads": rp["with_bf16_grads"]["dispatch"],
        "small_mesh": full["small_mesh"]["dispatch"],
        "flux": full["flux"]["dispatch"], "solver_mode": sm_["dispatch"],
        **{f"solver_mode_N{n}": e["dispatch"]
           for n, e in sm_["sweeps_per_step"].items()}}
    if set(row_dispatch.values()) != {"graph"}:
        fail(f"bench: rows not under graph dispatch: {row_dispatch}")
    emit("bench", card=smi, bench_card=full.get("card"), wall_s=bench_wall,
         stage_s=full["stage_s"], bulk_ms=bench_bulk_ms,
         timing_bulk_ms=f32_bulk_s * 1e3,
         bulk_vs_timing=bench_bulk_ms / (f32_bulk_s * 1e3),
         launches=counts, row_dispatch=row_dispatch, compact=comp)

    rows = [{"name": name, "route": route, "source": src, "replaces": line,
             "launches": launches[name],
             "model_path_launches": launches[name] - bench_launches[name],
             "bench_loop_launches": bench_launches[name],
             "max_abs_err": errs[name],
             **times[name], **work[name],
             "share": work[name]["bound_ms"] / times[name]["ms"],
             "library_ms": library.get(name)}
            for name, (route, src, line) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
