#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`cfd_proxy_tpu_torch/`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; run from the root of a checkout.  It builds
the port's CUDA kernels from `cfd_proxy_tpu_torch/csrc/` and drives the
port's paths at the benchmark size (a 96³-point generated mesh, ~2.8 M
faces, nvar 7, random state from a seed):

- `main_path`: one shard, the `bulk` schedule;
- `main_path_p1_all`: one shard with the fused overlap kernel forced
  (`force_rdma`), schedules bulk, early and overlap;
- `main_path_p8`: the mesh cut into 8 shards, all on the card, schedules
  bulk, early, overlap and nocomm, with the halo exchange between shards;
- `solver_p1`: one shard, the gather kernel at bp 512 (the solver-mode
  configuration): every schedule, `refresh_state` after an update of the
  owned columns, and the solver-mode runner (`iterate_fn(...,
  solver_mode=True)`: table rebuild, sweep + update, var exchange);
- `solver_p8`: the same at 8 shards, with the var exchange's ghost columns
  checked against their owners;
- `gather_auto_bp`: the gather kernel at the AUTO block size (4096);
- `solver_mode_timing`: the solver-mode step at P=1 and P=8, bulk, for
  gather/bp 512 and packed/AUTO at 1, 2 and 4 sweeps per step — the
  numbers `solver.solver_mode_defaults` is decided from;
- `flux_p1`: the PSD upwind flux model (`PSDFluxModel`, bench.py's
  secondary row: packed, AUTO bp, bulk) at one shard, timed, then every
  schedule with the fused overlap kernel forced;
- `flux_p8`: the flux model at 8 shards, every schedule under the packed
  kernel, then the gather kernel at bp 512 with `refresh_state` and the
  solver-mode runner, ghost columns checked against their owners.

Each path is driven with every kernel's launch count set to 0 just before
and read just after, and checked against the f64 golden of its op
(Green-Gauss or flux), across schedules and (P=8) ghost column against
owner column.  Then each kernel is compared with its plain PyTorch version
on the card at the paths' shapes, and the kernels and every schedule's
step are timed; at P=8 a `torch.profiler` trace of 20 chained steps per
schedule gives each step's device time and so its idle share.  Each
kernel's row carries its bound: the larger of the bytes it must move (each
input read once, each output written once, counting only the columns and
table lanes of the block entries the call computes) over 3.35 TB/s and its
f32 operations over 67 TFLOP/s (the H100 SXM's published peaks).

Phases print one JSON line each on stdout; any failure raises and exits
non-zero.  The last lines are the kernel table (JSON), the card's name and
power limit as nvidia-smi reports them, and

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA card, or outside a checkout, it exits non-zero before
printing anything on stdout.
"""

from __future__ import annotations

import json
import os
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
GATHER_BP = 512      # the gather kernel's solver-mode block size
SWEEPS = (1, 2, 4)   # sweeps per solver-mode step
K1_TOL = 1e-6    # sweep kernels vs plain: FMA contraction, relative to max|ref|
GOLDEN_TOL = 1e-5   # every schedule vs f64 golden (the reference's gate)
SCHED_TOL = 1e-6    # early vs bulk, overlap vs early, relative to max|bulk|
HBM_BYTES_PER_MS = 3.35e9      # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9          # H100 SXM: 67 TFLOP/s f32 outside tensor cores
OPS_PER_SLOT_LANE = {"gg": 64, "flux": 85}   # f32 operations (FMA = 2)
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
    "sweep_blocks_overlap_gather_flux": (
        "cuda", "cfd_proxy_tpu_torch/csrc/sweep_overlap.cu",
        "cfd_proxy_tpu/ops/blocksweep.py:747"),
}
PACKED = ("pack_srcs", "sweep_blocks", "sweep_blocks_init",
          "sweep_blocks_overlap")
GATHER = ("sweep_blocks_gather", "sweep_blocks_gather_init",
          "sweep_blocks_overlap_gather")
FLUX_PACKED = ("pack_srcs", "sweep_blocks_flux", "sweep_blocks_flux_init",
               "sweep_blocks_overlap_flux")
FLUX_GATHER = ("sweep_blocks_gather_flux", "sweep_blocks_gather_flux_init",
               "sweep_blocks_overlap_gather_flux")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
                push=None) -> dict:
    """Bound of one sweep call on args = (var_T, table, plan operands...),
    counting only what the call touches.  The listed entries (not a pad
    entry, which repeats its predecessor and is skipped) read their own
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
    moved = cols * (nv + 1) * 4 + nbytes(block_ids, slots)   # own, scale
    if gather:        # slot_idx (i32) and slot_w (3 x f32) per live lane
        idx = plan[0][first].long()                        # (entries, K, bp)
        live = torch.arange(bp, device=idx.device) < widths[:, None]
        ext = (idx >= bp) & live
        ep = tbl.shape[-1]
        entry = torch.arange(entries, device=idx.device)[:, None, None]
        n_ext = int(torch.unique((entry * ep + idx - bp)[ext]).numel())
        moved += lanes * (4 + 12) + n_ext * nv * 4
    else:             # sources (NV x f32) and slot_w (3 x f32) per lane
        moved += lanes * (nv + 3) * 4
    rows = 3 * nv if op == "gg" else nv
    moved += (2 * cols if init else P * ndev) * rows * 4
    if push is not None:
        moved += 2 * nbytes(push)
    # listed entries whose scale is zero (ghost region, trash block): the
    # plan hands them to the kernel, which reads their operands all the same
    zero = int((scale[first] == 0).flatten(1).all(1).sum())
    return {**bound(moved, lanes * OPS_PER_SLOT_LANE[op] + cols * rows),
            "entries": entries, "zero_scale_entries": zero}


def device_profile(model, state, schedule: str, n: int = 20) -> dict:
    """Device time per step of n chained steps under torch.profiler: the
    CUDA kernels' and copies' device time summed (one stream, so nothing
    overlaps) over n, beside the profiled wall time per step, with the
    largest parts.  `device_ms` is None when the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = model.iterate_fn(schedule, n)
    args = model.iter_args(state)
    run(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    parts = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            parts[e.key[:96]] = parts.get(e.key[:96], 0.0) + us / 1e3 / n
    top = dict(sorted(parts.items(), key=lambda kv: -kv[1])[:8])
    device = sum(parts.values())
    return {"device_ms": device if device > 0 else None,
            "wall_ms": wall * 1e3 / n, "steps": n, "top_ms": top}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this run needs "
              "a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np

        from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
        from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
        from cfd_proxy_tpu_torch.models.gradients import (GreenGaussTorch,
                                                          PSDFluxModel)
        from cfd_proxy_tpu_torch.ops import _cuda
        from cfd_proxy_tpu_torch.ops import blocksweep as bs
        from cfd_proxy_tpu_torch.solver import (golden, solver_mode_defaults,
                                                time_schedule)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              f"root of a checkout", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)

    counters = {   # kernel row: (wrapper, its count attribute)
        "pack_srcs": (bs.pack_srcs, "launches"),
        "sweep_blocks": (bs.sweep_blocks, "launches"),
        "sweep_blocks_init": (bs.sweep_blocks, "init_launches"),
        "sweep_blocks_overlap": (bs.sweep_blocks_overlap, "launches"),
        "sweep_blocks_gather": (bs.sweep_blocks_gather, "launches"),
        "sweep_blocks_gather_init": (bs.sweep_blocks_gather,
                                     "init_launches"),
        "sweep_blocks_overlap_gather": (bs.sweep_blocks_overlap_gather,
                                        "launches"),
        "sweep_blocks_flux": (bs.sweep_blocks, "flux_launches"),
        "sweep_blocks_flux_init": (bs.sweep_blocks, "flux_init_launches"),
        "sweep_blocks_overlap_flux": (bs.sweep_blocks_overlap,
                                      "flux_launches"),
        "sweep_blocks_gather_flux": (bs.sweep_blocks_gather,
                                     "flux_launches"),
        "sweep_blocks_gather_flux_init": (bs.sweep_blocks_gather,
                                          "flux_init_launches"),
        "sweep_blocks_overlap_gather_flux": (bs.sweep_blocks_overlap_gather,
                                             "flux_launches"),
    }

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        torch.cuda.synchronize()
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    launches = dict.fromkeys(KERNELS, 0)    # summed over the counted paths

    def expect_counts(path, counts, names):
        for k, n in counts.items():
            launches[k] += n
        missing = [k for k in names if counts[k] <= 0]
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

    def ghost_check(path, model, arr):
        """Every ghost column of the (P, rows, ndev) host array equals its
        owner's column bitwise; returns the columns checked."""
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
                if not np.array_equal(arr[i][:, recv_cols],
                                      arr[e.partner][:, send_cols]):
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

    def check_schedules(path, model, outs, gold=None):
        """Every schedule vs the golden; early vs bulk, overlap vs early."""
        rel = {s: golden_relmax(model, g, gold=gold) for s, g in outs.items()}
        scale = float(outs["bulk"].abs().max())
        cross = {
            "early_vs_bulk": float((outs["early"] - outs["bulk"]).abs().max()),
            "overlap_vs_early": float(
                (outs["overlap"] - outs["early"]).abs().max())}
        for s, r in rel.items():
            if not r <= GOLDEN_TOL:
                fail(f"{path}: {s} vs golden relmax {r:.3e} > {GOLDEN_TOL}")
        for k, v in cross.items():
            if not v <= SCHED_TOL * scale:
                fail(f"{path}: {k} {v:.3e} > {SCHED_TOL} x {scale:.3e}")
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
    tbl = bs.pack_srcs(var_T, pl["src_cols"])
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

    # ---- timing: kernels vs plain (same call, in turns), then the bulk step
    times = {
        "pack_srcs": paired_ms(lambda: bs.pack_srcs(var_T, pl["src_cols"]),
                               lambda: bs.pack_srcs_ref(var_T,
                                                        pl["src_cols"])),
        "sweep_blocks": paired_ms(
            lambda: bs.sweep_blocks(var_T, tbl, *args),
            lambda: bs.sweep_blocks_ref(var_T, tbl, *args))}
    del tbl, tbl_ref, out, out_ref
    st = time_schedule(model, state, "bulk", TIMED_STEPS, warmup=2,
                       repeats=5)
    nface = gmesh.nface
    emit("timing", card=smi, kernels=dict(times),
         bulk_step_ms=st.median * 1e3,
         bulk_step_ms_all=[t * 1e3 for t in st.times],
         faces_per_sec=nface / st.median, steps=TIMED_STEPS)
    if not np.isfinite(st.median):
        fail("bulk step timing fell below the two-point noise floor")

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
        if counts["pack_srcs"]:
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
        if counts["sweep_blocks_gather"] != SOLVER_RUN:
            fail(f"{path}: {SOLVER_RUN} solver steps launched K2 "
                 f"{counts['sweep_blocks_gather']} times")
        if v.shape != state["var_T"].shape or not bool(
                torch.isfinite(v).all()):
            fail(f"{path}: solver-mode state {tuple(v.shape)} or "
                 f"non-finite")
        emit(path, parts=npart, kernel="gather", bp=gm.bp, ndev=gm.ndev,
             model_seconds=t_model,
             ep={c: int(gm.plans[c]["ext_idx"].shape[2]) for c in gm.plans},
             kslots={c: len(w) for c, w in gm.wks.items()},
             wks={c: list(w) for c, w in gm.wks.items()},
             vs_golden_relmax=rel, tol=GOLDEN_TOL, cross=cross,
             max_abs_bulk=scale, cross_tol=SCHED_TOL * scale,
             refresh_vs_golden_15_relmax=rel15, solver_steps=SOLVER_RUN,
             solver_launches=counts, **info)
        gather_models[npart] = gm
        del state, v

    # ---- the gather kernel at the AUTO block size (4096 at one shard): K2
    # stages nothing in shared memory, so no bp is too large for it
    reset_counts()
    gm = GreenGaussTorch(parts, NVAR, kernel="gather", device=dev)
    rel_auto = golden_relmax(gm, gm.step(gm.distribute_state(
        gvar, schedules=["bulk"]), "bulk"))
    counts = read_counts()
    emit("gather_auto_bp", parts=1, bp=gm.bp,
         ep=int(gm.plans["bulk"]["ext_idx"].shape[2]),
         bulk_vs_golden_relmax=rel_auto, tol=GOLDEN_TOL, launches=counts)
    expect_counts("gather_auto_bp", counts, ("sweep_blocks_gather",))
    if not rel_auto <= GOLDEN_TOL:
        fail(f"gather at bp {gm.bp}: bulk vs golden {rel_auto:.3e}")
    del gm

    # ---- K2, K2-init and K3-gather vs their plain versions: K2 at the P=1
    # bulk shapes, K2-init and K3-gather at the P=8 interior + push
    gm = gather_models[1]
    state = gm.distribute_state(gvar, schedules=["bulk"])
    k2 = (state["var_T"], *gm._operands("bulk", state["tables"]))
    out = bs.sweep_blocks_gather(*k2)
    out_ref = bs.sweep_blocks_gather_ref(*k2)
    torch.cuda.synchronize()
    errs["sweep_blocks_gather"] = float((out - out_ref).abs().max())
    scales = {"sweep_blocks_gather": float(out_ref.abs().max())}
    work["sweep_blocks_gather"] = sweep_bound("gg", k2, gather=True)
    times["sweep_blocks_gather"] = paired_ms(
        lambda: bs.sweep_blocks_gather(*k2),
        lambda: bs.sweep_blocks_gather_ref(*k2))
    del out, out_ref, state, k2
    gm = gather_models[P_MULTI]
    state = gm.distribute_state(gvar)
    iargs = (state["var_T"], *gm._operands("interior", state["tables"]))
    gb = gm.step(state, "nocomm")               # any finite init
    sendbufs = gm._pack(gb, gm.pack_scale)
    got = bs.sweep_blocks_gather(*iargs, init=gb.clone())
    want = bs.sweep_blocks_gather_ref(*iargs, init=gb.clone())
    g3, r3 = bs.sweep_blocks_overlap_gather(*iargs, gb.clone(), sendbufs,
                                            gm.dsts, gm.srcs)
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
    times["sweep_blocks_gather_init"] = paired_ms(
        lambda: bs.sweep_blocks_gather(*iargs, init=buf),
        lambda: bs.sweep_blocks_gather_ref(*iargs, init=buf))
    times["sweep_blocks_overlap_gather"] = paired_ms(
        lambda: bs.sweep_blocks_overlap_gather(*iargs, buf, sendbufs,
                                               gm.dsts, gm.srcs),
        lambda: bs.sweep_blocks_overlap_gather_ref(*iargs, buf, sendbufs,
                                                   gm.dsts, gm.srcs))
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
                want = {sweep: float(n)}
                if m.kernel == "packed":
                    want["pack_srcs"] = 1.0   # one rebuilt class (bulk)
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
    del packed_models, gather_models, configs, m

    def compare_and_time(name, kern, plain, init=None, push=False):
        """Kernel `name` against its plain version on the same operands:
        within K1_TOL of max|plain| (the pushed buffers bitwise), then both
        timed in turns.  kern/plain take the init tensor (None without) and
        return the output, or (grad, recv) for a fused push.  The timed
        calls accumulate onto one buffer again and again; its values stop
        meaning anything, the bytes moved do not change."""
        got = kern(None if init is None else init.clone())
        want = plain(None if init is None else init.clone())
        torch.cuda.synchronize()
        if push:
            (got, recv), (want, recv_ref) = got, want
            if not torch.equal(recv, recv_ref):
                fail(f"{name} recv differs from its plain version")
        errs[name] = float((got - want).abs().max())
        scales[name] = float(want.abs().max())
        if not errs[name] <= K1_TOL * scales[name]:
            fail(f"{name} differs from its plain version: {errs[name]:.3e} "
                 f"> {K1_TOL} x {scales[name]:.3e}")
        del got, want
        buf = None if init is None else init.clone()
        times[name] = paired_ms(lambda: kern(buf), lambda: plain(buf))

    def kernel_summary(names):
        return {k: {"max_abs_err": errs[k], "max_abs_ref": scales[k],
                    **times[k], **work[k]} for k in names}

    # ---- flux, one shard: the PSD upwind flux model (bench.py's secondary
    # row: packed, AUTO bp, bulk) on the same mesh and state, against the
    # f64 compute_psd_flux golden (not linear in the state: each state
    # checked here gets its own golden); then every schedule with the fused
    # overlap kernel forced
    t0 = time.perf_counter()
    flux_ref = golden("flux", gmesh, gvar)
    t_gold = time.perf_counter() - t0
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
    if counts["pack_srcs"]:
        fail("flux_p8: the gather model launched the source pack")
    gather_info = {"bp": gm.bp, "model_seconds": t_model,
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
    if counts["sweep_blocks_gather_flux"] != SOLVER_RUN:
        fail(f"flux_p8: {SOLVER_RUN} solver steps launched K2-flux "
             f"{counts['sweep_blocks_gather_flux']} times")
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
    compare_and_time("sweep_blocks_gather_flux",
                     lambda i: bs.sweep_blocks_gather(*k2f, op="flux"),
                     lambda i: bs.sweep_blocks_gather_ref(*k2f, op="flux"))
    work["sweep_blocks_gather_flux"] = sweep_bound("flux", k2f, gather=True)
    del k2f
    iargs = (state["var_T"], *gm._operands("interior", state["tables"]))
    gb = gm.step(state, "nocomm")               # any finite init
    sendbufs = gm._pack(gb, gm.pack_scale)
    compare_and_time(
        "sweep_blocks_gather_flux_init",
        lambda i: bs.sweep_blocks_gather(*iargs, init=i, op="flux"),
        lambda i: bs.sweep_blocks_gather_ref(*iargs, init=i, op="flux"),
        init=gb)
    compare_and_time(
        "sweep_blocks_overlap_gather_flux",
        lambda i: bs.sweep_blocks_overlap_gather(*iargs, i, sendbufs, gm.dsts,
                                                 gm.srcs, op="flux"),
        lambda i: bs.sweep_blocks_overlap_gather_ref(
            *iargs, i, sendbufs, gm.dsts, gm.srcs, op="flux"),
        init=gb, push=True)
    work["sweep_blocks_gather_flux_init"] = sweep_bound(
        "flux", iargs, gather=True, init=True)
    work["sweep_blocks_overlap_gather_flux"] = sweep_bound(
        "flux", iargs, gather=True, init=True, push=sendbufs)
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

    rows = [{"name": name, "route": route, "source": src, "replaces": line,
             "launches": launches[name], "max_abs_err": errs[name],
             **times[name], **work[name],
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
