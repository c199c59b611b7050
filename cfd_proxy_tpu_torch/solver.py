"""Benchmark CLI of the port — counterpart of `cfd_proxy_tpu/solver.py`.

Builds the model on a generated (or read) mesh cut into P shards, all held
on one device or (`--ranks W`) spread over W processes, each with its own
device, distributes the state, times each schedule's chained loop
with the reference's two-point sampler (and the compute-only `nocomm` floor
when several schedules run, for the overlap efficiency), verifies every
schedule against bulk and bulk against the f64 golden, and prints the same
table and verify lines as the reference CLI:

    python -m cfd_proxy_tpu_torch.solver --nx 96 --ny 96 --nz 96 \
        --parts 8 --schedule all --iters 300
    python -m cfd_proxy_tpu_torch.solver --nx 96 --ny 96 --nz 96 \
        --schedule bulk --solver-mode --sweeps-per-step 4
    python -m cfd_proxy_tpu_torch.solver --nx 96 --ny 96 --nz 96 \
        --parts 8 --ranks 2 --transport peer --share-device \
        --dist-backend gloo

Ranks.  `--ranks W` (W divides `--parts`) starts W processes on this
machine (parallel/launch.py), rank r holding shards [r·P/W, (r+1)·P/W) on
`cuda:r`; under `torchrun` (RANK and WORLD_SIZE set) the processes are
there already and `--ranks` must name their number.  More ranks than cards
need `--share-device` (rank r on `cuda:(r mod cards)`; a check of the
mechanism, not a timing: the processes time-slice the card).
`--transport` picks how halos travel (parallel/transport.py): `loopback`
(W = 1, the default there), `dist` (`batch_isend_irecv`; the default for
W > 1) or `peer` (mapped device memory, the fused kernel pushes from
inside its launch); `--dist-backend` the group's backend, `nccl` (the
default on CUDA) or `gloo` (the default on the CPU; with CUDA tensors it
stages through the host, and the result names it `dist/gloo-staged`).
`--slice-size S` routes the phases that cross nodes of S devices through
the collective transport under `overlap`.  Each rank times its own loop
after a barrier and every sample is the slowest rank's (one all-reduce MAX
per sample, outside the timed loops), as an MPI run of CFD-Proxy reports
it; rank 0 prints.

The port runs Green-Gauss gradients (`--model gg`) or the PSD upwind flux
(`--model flux`, ops/flux.py) with the packed (compact layout) or the
gather kernel (`--kernel`) under the bulk / early / overlap schedules
(`--force-rdma`: the fused overlap kernel even at one shard), in f32 or
with the reference's reduced-precision options (`--meta-dtype`,
`--src-dtype` (packed kernel only), `--halo-dtype`, `--grad-dtype`
bfloat16: bf16 slot weights, source deltas, gradient wire and gradient
stores; bench.py's reduced-precision row is `--schedule bulk --src-dtype
bfloat16 --meta-dtype bfloat16`, then with `--grad-dtype bfloat16`).
`--solver-mode` times the per-time-step dataflow of a real solver (table
rebuild, `--sweeps-per-step` sweeps with their updates, var halo exchange)
instead of the static-state iteration; without `--kernel` it takes the
kernel and block size `solver_mode_defaults` decides.  The mesh options
(`--ghost-layers`, `--diag-frac`, `--stretch`, `--hub-frac`,
`--hub-extra`) are the reference's.  `--backend pallas` (the default)
names the kernel path, here the CUDA kernels; `--backend xla` runs the ELL
model (models/gradients_ell.py, plain torch, Green-Gauss only) in
`--dtype float32` or `float64`, the f64 verification anchor: its
`bulk_vs_golden_relmax` sits at ULP level.  The fake exchange phases
(`--min-phases`, `--fake-sends`, `--fake-tail-frac`, the kernel model's)
pad the schedule with self-send phases carrying real payloads, so a single
shard moves P > 1-shaped exchanges; their ghost regions differ between
schedules, so the schedules are compared on owned columns only.
`--profile DIR` writes a `torch.profiler` trace (Chrome trace JSON) of the
timed loops to DIR.  The reference's `--pack-force` and `--platform` are
parsed and refused by name (`CheckError`, `check_config`): they work
around XLA and the TPU (ROADMAP queue 2, not-ported list).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.mesh.reader import partition_path, read_partition
from cfd_proxy_tpu_torch.models.gradients import (DTYPE_OPTIONS, KERNELS,
                                                  PRECISIONS, GreenGaussTorch)
from cfd_proxy_tpu_torch.models.gradients_ell import DTYPES, GreenGaussModel
from cfd_proxy_tpu_torch.ops.blocksweep import OPS
from cfd_proxy_tpu_torch.ops.flux import compute_psd_flux, flux_residual_scale
from cfd_proxy_tpu_torch.ops.golden import (compute_gradients_gg,
                                            scale_gradients)
from cfd_proxy_tpu_torch.ops.sweep_ell import reduce_bytes
from cfd_proxy_tpu_torch.parallel import launch
from cfd_proxy_tpu_torch.parallel.transport import DIST_BACKENDS, TRANSPORTS
from cfd_proxy_tpu_torch.utils.errors import check
from cfd_proxy_tpu_torch.utils.timing import (IterationStats,
                                              format_stats_table,
                                              two_point_sampler)

SCHEDULES = ("bulk", "early", "overlap")     # what --schedule all times
BACKENDS = ("pallas", "xla")
# a comm cost (bulk - nocomm) under this share of the bulk median is
# two-point timing noise: no overlap efficiency is reported (the reference's
# gate, cfd_proxy_tpu/solver.py:371-375)
NOISE_GATE = 0.05
RANKS_TIMEOUT_S = 1800.0    # a multi-rank run is killed past this


def solver_mode_defaults(sweeps_per_step: int = 1) -> tuple[str, int | None]:
    """The decided solver-mode kernel configuration per sweeps_per_step —
    the one place the measured crossover lives.  Returns (kernel, bp); bp
    None = the model's AUTO rule.

    Re-decided on an H100 (PERF.md, solver mode): the reference's TPU
    rule (gather/512 up to 2 sweeps per step, packed/AUTO from 4) does not
    carry over.  On the card gather/512 has the cheaper table rebuild (ext
    columns, no source re-pack) AND the cheaper sweep (K2 reads fewer bytes
    from device memory than K1), so it wins at every measured N (1, 2, 4;
    P = 1 and 8) and the gap grows with N: there is no crossover."""
    del sweeps_per_step             # no crossover on the card
    return ("gather", 512)


@dataclass
class SolverConfig:
    nx: int = 24
    ny: int = 24
    nz: int = 24
    mesh_prefix: str | None = None
    parts: int = 1
    ghost_layers: int = 1
    nvar: int = 7
    iters: int = 20
    warmup: int = 3
    schedule: str = "all"
    backend: str = "pallas"     # pallas: the kernels; xla: the ELL model
    force_rdma: bool = False
    slice_size: int | None = None
    model: str = "gg"
    kernel: str = "packed"
    kcompact: bool | None = None
    bp: int | None = None
    meta_dtype: str = "float32"
    src_dtype: str = "float32"
    halo_dtype: str = "float32"
    grad_dtype: str = "float32"
    solver_mode: bool = False
    sweeps_per_step: int = 1
    dtype: str = "float32"
    diag_frac: float = 0.2
    jitter: float = 0.05
    stretch: float = 1.0
    hub_frac: float = 0.0
    hub_extra: int = 12
    seed: int = 0
    device: str = "cuda"
    verify: bool = True
    json_out: bool = False
    ranks: int = 1
    transport: str | None = None    # None: loopback at one rank, else dist
    dist_backend: str | None = None     # None: nccl on cuda, gloo on cpu
    share_device: bool = False
    min_phases: int = 1
    fake_sends: int = 0
    fake_tail_frac: float = 0.0
    profile_dir: str | None = None
    # the reference's options the port refuses by name (check_config)
    pack_force: str | None = None
    platform: str | None = None


def check_config(cfg: SolverConfig) -> None:
    """Refuse, by name, every option outside the ported slice."""
    check(cfg.parts >= 1, "--parts %d: need at least one shard", cfg.parts)
    check(cfg.schedule in ("all", *SCHEDULES), "unknown --schedule %s",
          cfg.schedule)
    check(cfg.ghost_layers >= 1, "--ghost-layers %d: need at least one",
          cfg.ghost_layers)
    check(cfg.slice_size is None or cfg.slice_size >= 1,
          "--slice-size %s: need at least one device per node",
          cfg.slice_size)
    check(cfg.ranks >= 1 and cfg.parts % cfg.ranks == 0,
          "--ranks %d does not divide --parts %d (rank r holds shards "
          "[r*P/W, (r+1)*P/W))", cfg.ranks, cfg.parts)
    check(cfg.transport in (None, *TRANSPORTS), "unknown --transport %s",
          cfg.transport)
    check(cfg.transport != "loopback" or cfg.ranks == 1, "--transport "
          "loopback holds every shard in one process; --ranks %d needs dist "
          "or peer", cfg.ranks)
    check(cfg.transport != "peer" or cfg.device == "cuda", "--transport "
          "peer maps device memory between ranks and has no CPU form (use "
          "--transport dist with --device cpu)")
    check(cfg.dist_backend in (None, *DIST_BACKENDS),
          "unknown --dist-backend %s", cfg.dist_backend)
    check(dist_backend(cfg) != "nccl" or cfg.device == "cuda",
          "--dist-backend nccl moves CUDA tensors only (use gloo with "
          "--device cpu)")
    check(not (cfg.ranks > 1 and cfg.share_device
               and dist_backend(cfg) == "nccl"), "--dist-backend nccl with "
          "two ranks on one device (--share-device) is not supported by "
          "NCCL: use --dist-backend gloo")
    env = launch.world_from_env()
    check(env is None or env[1] == cfg.ranks, "--ranks %d, but the launcher "
          "started %s processes (WORLD_SIZE)", cfg.ranks, env and env[1])
    check(cfg.backend in BACKENDS, "unknown --backend %s", cfg.backend)
    check(cfg.dtype in DTYPES, "--dtype %s: float32 or float64", cfg.dtype)
    # the reference's messages (cfd_proxy_tpu/solver.py:172, 188, 287)
    check(cfg.dtype == "float32" or cfg.backend == "xla",
          "pallas backend is float32; use --backend xla for f64")
    check(cfg.backend == "pallas" or cfg.model == "gg",
          "--model flux requires --backend pallas")
    check(cfg.backend == "pallas" or not cfg.solver_mode,
          "--solver-mode requires the pallas backend")
    if cfg.backend == "xla":
        # the kernel model's options: the ELL model stores one dtype and
        # has no fused kernel
        for name in DTYPE_OPTIONS:
            check(getattr(cfg, name) == "float32", "--%s %s: the xla "
                  "backend stores --dtype throughout (a pallas option)",
                  name.replace("_", "-"), getattr(cfg, name))
        for opt, value, off in (("force-rdma", cfg.force_rdma, False),
                                ("min-phases", cfg.min_phases, 1),
                                ("fake-sends", cfg.fake_sends, 0),
                                ("fake-tail-frac", cfg.fake_tail_frac, 0.0)):
            check(value == off, "--%s %s: a pallas option (the xla backend "
                  "has no fused kernel and no device layout)", opt, value)
        check(cfg.transport != "peer", "--transport peer: the xla backend "
              "has no fused kernel to push from (use loopback or dist)")
    check(cfg.pack_force is None, "--pack-force %s: the pack lowerings it "
          "picks work around XLA and are not ported (ROADMAP queue 2, "
          "not-ported list)", cfg.pack_force)
    check(cfg.platform is None, "--platform %s: a JAX platform switch, not "
          "ported (ROADMAP queue 2, not-ported list); use --device cpu|cuda",
          cfg.platform)
    check(cfg.kernel in KERNELS, "unknown --kernel %s", cfg.kernel)
    check(cfg.model in OPS, "unknown --model %s", cfg.model)
    for name in DTYPE_OPTIONS:
        check(getattr(cfg, name) in PRECISIONS, "--%s %s: float32 or "
              "bfloat16", name.replace("_", "-"), getattr(cfg, name))
    check(cfg.sweeps_per_step >= 1, "--sweeps-per-step %d: need at least "
          "one sweep per step", cfg.sweeps_per_step)
    check(cfg.sweeps_per_step == 1 or cfg.solver_mode, "--sweeps-per-step "
          "requires --solver-mode (the static iteration never rebuilds "
          "tables)")
    check(cfg.device in ("cuda", "cpu"), "--device %s: cuda or cpu",
          cfg.device)
    if cfg.device == "cuda" and cfg.ranks > 1 and not cfg.share_device:
        cards = torch.cuda.device_count()
        check(cfg.ranks <= cards, "--ranks %d exceeds the %d CUDA devices "
              "torch sees (one rank per card; --share-device puts several "
              "ranks on one, for checks only)", cfg.ranks, cards)
    check(cfg.device != "cuda" or torch.cuda.is_available(),
          "--device cuda but torch sees no CUDA device (use --device cpu "
          "for the plain PyTorch versions)")


def dist_backend(cfg: SolverConfig) -> str:
    """The process group's backend: the option, else nccl on CUDA and gloo
    on the CPU."""
    return cfg.dist_backend or ("nccl" if cfg.device == "cuda" else "gloo")


def read_parts(cfg: SolverConfig) -> list:
    """The `--mesh` partition files, with the reference's message when one
    is missing (`cfd_proxy_tpu/solver.py:147-159`)."""
    try:
        return [read_partition(partition_path(cfg.mesh_prefix, i, cfg.parts))
                for i in range(cfg.parts)]
    except FileNotFoundError as e:
        raise SystemExit(
            f"mesh partition file not found: {e.filename} — expected "
            f"<prefix>.<parts>p.<i>.nc; write them with "
            f"`python -m cfd_proxy_tpu_torch.tools.partition --parts "
            f"{cfg.parts} --out {cfg.mesh_prefix}` (plus your --nx/--ny/--nz/"
            f"--ghost-layers/--seed — the tool's defaults are a 24^3 mesh)")


def build_model(cfg: SolverConfig, parts: list | None = None, group=None,
                device: str | None = None):
    """(model, global mesh or None): the model of cfg's model fields on
    `parts` when given (shared between configurations), else on the
    `--mesh` files or on the generated and partitioned mesh; with `group`,
    this rank's share of it on `device`."""
    gmesh = None
    if parts is None and cfg.mesh_prefix:
        parts = read_parts(cfg)
    elif parts is None:
        gmesh = generate_mesh(cfg.nx, cfg.ny, cfg.nz, jitter=cfg.jitter,
                              diag_frac=cfg.diag_frac, seed=cfg.seed,
                              stretch=cfg.stretch, hub_frac=cfg.hub_frac,
                              hub_extra=cfg.hub_extra)
        parts = partition_mesh(gmesh, cfg.parts,
                               ghost_layers=cfg.ghost_layers)
    if cfg.backend == "xla":
        return GreenGaussModel(parts, cfg.nvar, dtype=DTYPES[cfg.dtype],
                               device=device or cfg.device, group=group,
                               transport=cfg.transport,
                               slice_size=cfg.slice_size,
                               share_device=cfg.share_device), gmesh
    model = GreenGaussTorch(parts, cfg.nvar, bp=cfg.bp, kcompact=cfg.kcompact,
                            force_rdma=cfg.force_rdma, kernel=cfg.kernel,
                            op=cfg.model, device=device or cfg.device,
                            group=group, transport=cfg.transport,
                            slice_size=cfg.slice_size,
                            share_device=cfg.share_device,
                            meta_dtype=cfg.meta_dtype,
                            src_dtype=cfg.src_dtype,
                            halo_dtype=cfg.halo_dtype,
                            grad_dtype=cfg.grad_dtype,
                            min_phases=cfg.min_phases,
                            fake_sends=cfg.fake_sends,
                            fake_tail_frac=cfg.fake_tail_frac)
    return model, gmesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_schedule(model: GreenGaussTorch, state: dict, schedule: str,
                  iters: int, warmup: int, repeats: int = 3,
                  solver_mode: bool = False,
                  sweeps_per_step: int = 1) -> IterationStats:
    """Two-point timing: chained loops of n0 and n0+iters steps, each ended
    by a device synchronise; their difference over iters is the per-step
    time with the fixed per-run cost cancelled.  solver_mode times the
    solver's per-step dataflow (GreenGaussTorch.iterate_fn)."""
    n0 = max(1, iters // 10)
    small = model.iterate_fn(schedule, n0, solver_mode, sweeps_per_step)
    big = model.iterate_fn(schedule, n0 + iters, solver_mode,
                           sweeps_per_step)
    args = model.iter_args(state)
    dev = model.device

    def run(fn):
        fn(*args)
        _sync(dev)

    for _ in range(1 + max(0, warmup)):
        run(small)
        run(big)
    stats = IterationStats(schedule)
    if model.world == 1:
        sample = two_point_sampler(lambda: run(small), lambda: run(big),
                                   iters)
    else:
        sample = launch.slowest_rank_sampler(
            model.group, dev, lambda: run(small), lambda: run(big), iters)
    for _ in range(repeats):
        v = sample()
        if v is not None:
            stats.add(v)
    if stats.n == 0:
        stats.add(float("nan"))     # every repeat under the noise floor
    return stats


def overlap_efficiency(entries: dict, nocomm: float, parts: int) -> None:
    """Add `overlap_efficiency` to every non-bulk schedule entry:
    1 - (t_s - t_nocomm) / (t_bulk - t_nocomm), clipped to [0, 1] — the share
    of the bulk exchange's cost the schedule hides.  Null, with the reason,
    when the comm cost is under the noise gate (the reference's rule)."""
    bulk = entries.get("bulk", {}).get("median_s")
    comm = (bulk - nocomm) if bulk is not None else None
    for s, e in entries.items():
        if s == "bulk":
            continue
        if (comm is not None and math.isfinite(comm) and comm > 0
                and comm >= NOISE_GATE * bulk):
            exposed = e["median_s"] - nocomm
            e["overlap_efficiency"] = float(
                np.clip(1.0 - exposed / comm, 0.0, 1.0))
            continue
        why = ("at P=1 the exchange moves nothing (self-send phases only) "
               "— overlap efficiency needs P > 1" if parts <= 1 else
               f"at P={parts} the measured comm cost is below the "
               f"{NOISE_GATE:.0%} noise gate — overlap has nothing "
               f"measurable to hide here")
        e["overlap_efficiency"] = None
        e["overlap_efficiency_note"] = (
            "comm cost unmeasurable (bulk - nocomm below the two-point "
            "noise floor; " + why + ")")


def golden(op: str, gmesh, gvar: np.ndarray) -> np.ndarray:
    """The f64 golden of a model's op on the global mesh, in the layout
    `gather_global` returns: gg (N, nvar*3), flux (N, nvar)."""
    var = gvar.astype(np.float64)
    if op == "flux":
        return flux_residual_scale(
            compute_psd_flux(var, gmesh.faces, gmesh.normals),
            gmesh.volume, gmesh.npoint)
    return scale_gradients(
        compute_gradients_gg(var, gmesh.faces, gmesh.normals),
        gmesh.volume, gmesh.npoint).reshape(gmesh.npoint, -1)


def verify_model(model, state, schedules, gmesh, gvar: np.ndarray) -> dict:
    """Every schedule against bulk (max abs over all columns, or over the
    owned columns when fake phases fill ghost regions that differ between
    schedules by design) and bulk against the f64 golden of the model's op
    (when the global mesh is in process), as the reference's verify_model
    reports them (bf16 outputs compared in f32)."""
    ref = model.step(state, "bulk")
    ncmp = ref.shape[-1]
    if getattr(model, "fake_sends", 0) > 0:
        ncmp = model.ghost_start
    out = {}
    for s in schedules:
        if s != "bulk":
            diff = model.step(state, s)[..., :ncmp].float() \
                - ref[..., :ncmp].float()
            out[f"{s}_vs_bulk_maxabs"] = _max_over_ranks(model,
                                                         diff.abs().max())
    if gmesh is not None:
        gg = golden(getattr(model, "op", "gg"), gmesh, gvar)
        got = model.gather_global(ref)
        denom = max(1.0, float(np.abs(gg).max()))
        out["bulk_vs_golden_relmax"] = float(np.abs(got - gg).max() / denom)
    return out


def _max_over_ranks(model, x: torch.Tensor) -> float:
    if model.world > 1:
        dist = torch.distributed
        if dist.get_backend(model.group) != "nccl":
            x = x.cpu()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=model.group)
    return float(x)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(cfg: SolverConfig) -> tuple[dict, list[IterationStats]]:
    """Rank 0's (results, stats).  One rank runs here; several are started
    (or, under torchrun, joined) and run `run_rank` each."""
    check_config(cfg)
    if cfg.ranks == 1:
        return run_rank(cfg)
    if launch.world_from_env() is not None:         # under torchrun
        return _joined_rank(cfg)
    return launch.spawn(cfg.ranks, _joined_rank, (cfg,),
                        timeout_s=RANKS_TIMEOUT_S)[0]


def _joined_rank(cfg: SolverConfig):
    """One rank of a multi-process run: select the device, join the group,
    run, release the mapped memory."""
    group, _, _, device = launch.join_rank(cfg.device, dist_backend(cfg),
                                           cfg.share_device)
    return run_rank(cfg, group, device)


def run_rank(cfg: SolverConfig, group=None, device: str | None = None
             ) -> tuple[dict, list[IterationStats]]:
    model, gmesh = build_model(cfg, group=group, device=device)
    try:
        return _run_model(cfg, model, gmesh)
    finally:
        model.close()


def _run_model(cfg: SolverConfig, model, gmesh):
    nface = sum(p.nface for p in model.parts)
    npoint = sum(p.nowned for p in model.parts)
    gvar = make_state(npoint, cfg.nvar, seed=cfg.seed + 1)
    schedules = list(SCHEDULES) if cfg.schedule == "all" else [cfg.schedule]
    # build only the table classes the timed schedules (and the bulk
    # verification, the nocomm floor) read
    need = schedules + ["bulk"] * (cfg.verify or len(schedules) > 1)
    state = model.distribute_state(gvar, schedules=need)
    stats = []
    entries = {}
    mode = {"solver_mode": cfg.solver_mode,
            "sweeps_per_step": cfg.sweeps_per_step}
    # with N sweeps per solver step, faces/s counts swept faces, so the
    # amortised rebuild shows as throughput (the reference's rule)
    sweeps = cfg.sweeps_per_step if cfg.solver_mode else 1
    with profiled(cfg.profile_dir, model):
        for s in schedules:
            st = time_schedule(model, state, s, cfg.iters, cfg.warmup,
                               **mode)
            stats.append(st)
            entries[s] = {**st.summary(),
                          "faces_per_sec": nface * sweeps / st.median}
        if len(schedules) > 1:
            # compute-only floor: the bulk sweep without the exchange
            st = time_schedule(model, state, "nocomm", cfg.iters,
                               cfg.warmup, **mode)
            stats.append(st)
            overlap_efficiency(entries, st.median, len(model.parts))
    results = {
        "device": device_name(model.device),
        "npart": len(model.parts),
        "npoint": npoint,
        "nface": nface,
        "nvar": cfg.nvar,
        "model": cfg.model,
        "dtype": cfg.dtype,
        **{k: getattr(cfg, k) for k in DTYPE_OPTIONS},
        "backend": cfg.backend,
        "ranks": model.world,
        "transport": model.transport_name,
        **model_fields(cfg, model),
        "solver_mode": cfg.solver_mode,
        "sweeps_per_step": cfg.sweeps_per_step if cfg.solver_mode else None,
        "iters": cfg.iters,
        "schedules": entries,
    }
    if len(schedules) > 1:
        results["nocomm_median_s"] = stats[-1].median
    if cfg.profile_dir:
        results["profile"] = trace_path(cfg.profile_dir, model.rank)
    if cfg.verify:
        results["verification"] = verify_model(model, state, schedules,
                                               gmesh, gvar)
    return results, stats


def model_fields(cfg: SolverConfig, model) -> dict:
    """The report's backend-specific keys: the kernel model's layout and
    routing, or the ELL model's phases and table bytes."""
    if cfg.backend == "xla":
        return {"nphases": len(model.perms), "npoint_pad": model.npoint_pad,
                "reduce_bytes": reduce_bytes(model.dsweep, 3 * cfg.nvar,
                                             model.dtype)}
    return {"kernel_phases": model.kernel_phases,
            "collective_phases": model.coll_phases,
            "kernel": cfg.kernel, "bp": model.bp,
            "wks": {c: list(w) for c, w in model.wks.items()},
            "force_rdma": cfg.force_rdma,
            "nphases": model.nphases, "s_max": model.s_max,
            "min_phases": cfg.min_phases, "fake_sends": cfg.fake_sends,
            "fake_tail_frac": cfg.fake_tail_frac}


def trace_path(profile_dir: str, rank: int) -> str:
    return os.path.join(profile_dir, f"trace.rank{rank}.json")


@contextlib.contextmanager
def profiled(profile_dir: str | None, model):
    """A `torch.profiler` trace of the block (CPU ops, and CUDA kernels on a
    card) written to profile_dir as Chrome trace JSON, one file per rank
    (`trace_path`); nothing without a directory.  A failure to trace
    raises."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if model.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(trace_path(profile_dir, model.rank))


def _finite_or_none(obj):
    """NaN/inf → None recursively (strict JSON)."""
    if isinstance(obj, dict):
        return {k: _finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_or_none(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cfd_proxy_tpu_torch.solver",
        description="CFD-Proxy benchmark on the PyTorch/CUDA port")
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--ny", type=int, default=24)
    ap.add_argument("--nz", type=int, default=24)
    ap.add_argument("--mesh", dest="mesh_prefix", default=None,
                    help="read pre-partitioned netCDF files <prefix>.<P>p.<i>.nc")
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--ghost-layers", type=int, default=1)
    ap.add_argument("--nvar", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--schedule", default="all",
                    choices=["all", *SCHEDULES])
    ap.add_argument("--force-rdma", action="store_true",
                    help="fused overlap kernel even with nothing to move "
                         "(one shard: self-send phases)")
    ap.add_argument("--slice-size", type=int, default=None,
                    help="devices per node (multi-node phase routing)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes the shards are spread over (divides "
                         "--parts)")
    ap.add_argument("--transport", default=None, choices=list(TRANSPORTS),
                    help="default: loopback at one rank, else dist")
    ap.add_argument("--dist-backend", default=None,
                    choices=list(DIST_BACKENDS),
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--share-device", action="store_true",
                    help="allow more ranks than cards (rank r on cuda:(r "
                         "mod cards)); for checks, not for timing")
    ap.add_argument("--model", default="gg", choices=list(OPS),
                    help="gg: Green-Gauss gradients; flux: the PSD upwind "
                         "flux (ops/flux.py)")
    ap.add_argument("--kernel", default=None, choices=list(KERNELS),
                    help="default: packed, or under --solver-mode the "
                         "decided solver_mode_defaults")
    ap.add_argument("--kcompact", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--bp", type=int, default=None,
                    help="points per block (multiple of 128; default auto)")
    for name in ("meta", "src", "halo", "grad"):
        ap.add_argument(f"--{name}-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    ap.add_argument("--solver-mode", action="store_true",
                    help="time the solver's per-step dataflow: table "
                         "rebuild, sweeps + updates, var halo exchange")
    ap.add_argument("--sweeps-per-step", type=int, default=1,
                    help="solver mode: gradient evaluations per table "
                         "rebuild")
    ap.add_argument("--diag-frac", type=float, default=0.2)
    ap.add_argument("--stretch", type=float, default=1.0,
                    help="geometric z-spacing growth ratio (boundary-layer "
                         "anisotropy)")
    ap.add_argument("--hub-frac", type=float, default=0.0,
                    help="high-valence tail stress: fraction of points "
                         "gaining --hub-extra second-shell edges")
    ap.add_argument("--hub-extra", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--json", action="store_true", help="emit one JSON line")
    ap.add_argument("--backend", default="pallas", choices=list(BACKENDS),
                    help="pallas: the kernel path (here the CUDA kernels); "
                         "xla: the ELL model in plain torch (gg only)")
    ap.add_argument("--dtype", default="float32", choices=list(DTYPES),
                    help="float64 needs --backend xla")
    ap.add_argument("--profile", dest="profile_dir", default=None,
                    help="write a torch.profiler trace of the timed loops "
                         "to this directory (trace.rank<r>.json)")
    ap.add_argument("--min-phases", type=int, default=1,
                    help="pad the exchange schedule to this many self-send "
                         "phases")
    ap.add_argument("--fake-sends", type=int, default=0,
                    help="benchmark-only: padded phases carry real "
                         "shuffled-owned payloads of this many lanes "
                         "(owned results unchanged)")
    ap.add_argument("--fake-tail-frac", type=float, default=0.0,
                    help="with --fake-sends: trailing fraction of the fake "
                         "lanes packed from strided columns (at most 0.5)")
    # the reference's options outside the port: parsed, then refused by
    # name in check_config
    ap.add_argument("--pack-force", default=None,
                    choices=["gather", "nocombine", "combine"])
    ap.add_argument("--platform", default=None)
    a = ap.parse_args(argv)
    if a.kernel is None:
        if a.solver_mode:
            a.kernel, bp_def = solver_mode_defaults(a.sweeps_per_step)
            if a.bp is None:
                a.bp = bp_def
            print(f"cfd_proxy_tpu_torch: --solver-mode defaults to --kernel "
                  f"{a.kernel}" + (f" --bp {bp_def}" if bp_def else "")
                  + f" at sweeps_per_step={a.sweeps_per_step} (PERF.md, "
                  f"solver mode); pass --kernel/--bp to override",
                  file=sys.stderr)
        else:
            a.kernel = "packed"
    cfg = SolverConfig(
        nx=a.nx, ny=a.ny, nz=a.nz, mesh_prefix=a.mesh_prefix, parts=a.parts,
        ghost_layers=a.ghost_layers, nvar=a.nvar, iters=a.iters,
        warmup=a.warmup, schedule=a.schedule, backend=a.backend,
        force_rdma=a.force_rdma, slice_size=a.slice_size, model=a.model,
        kernel=a.kernel,
        kcompact={"auto": None, "on": True, "off": False}[a.kcompact],
        bp=a.bp, meta_dtype=a.meta_dtype, src_dtype=a.src_dtype,
        halo_dtype=a.halo_dtype, grad_dtype=a.grad_dtype,
        solver_mode=a.solver_mode, sweeps_per_step=a.sweeps_per_step,
        dtype=a.dtype, diag_frac=a.diag_frac, stretch=a.stretch,
        hub_frac=a.hub_frac, hub_extra=a.hub_extra, seed=a.seed,
        device=a.device, verify=not a.no_verify, json_out=a.json,
        ranks=a.ranks, transport=a.transport, dist_backend=a.dist_backend,
        share_device=a.share_device,
        min_phases=a.min_phases, fake_sends=a.fake_sends,
        fake_tail_frac=a.fake_tail_frac, pack_force=a.pack_force,
        platform=a.platform, profile_dir=a.profile_dir)
    t0 = time.perf_counter()
    results, stats = run(cfg)
    results["wall_s"] = time.perf_counter() - t0
    env = launch.world_from_env()
    if env is not None and env[0] != 0:
        return 0                    # under torchrun rank 0 prints
    if cfg.json_out:
        print(json.dumps(_finite_or_none(results)))
    else:
        print(f"device={results['device']} parts={results['npart']} "
              f"points={results['npoint']} faces={results['nface']} "
              f"model={results['model']} "
              + (f"ranks={results['ranks']} " if results["ranks"] > 1 else "")
              + f"transport={results['transport']} "
              f"nvar={results['nvar']} dtype={results['dtype']} "
              + "".join(f"{k}={results[k]} " for k in DTYPE_OPTIONS
                        if results[k] != "float32")
              + (f"kernel={results['kernel']} bp={results['bp']}"
                 if cfg.backend == "pallas" else "backend=xla")
              + (f" solver_mode sweeps_per_step={cfg.sweeps_per_step}"
                 if cfg.solver_mode else ""))
        print(format_stats_table(stats, ref="bulk"))
        for s, e in results["schedules"].items():
            if e.get("overlap_efficiency") is not None:
                extra = f"  overlap_eff={e['overlap_efficiency']:.1%}"
            elif "overlap_efficiency_note" in e:
                extra = f"  overlap_eff=n/a ({e['overlap_efficiency_note']})"
            else:
                extra = ""
            print(f"{s:<10} {e['faces_per_sec'] / 1e6:9.2f} Mfaces/s{extra}")
        for k, v in results.get("verification", {}).items():
            print(f"verify {k} = {v:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
