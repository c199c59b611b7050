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
  bulk, early, overlap and nocomm, with the halo exchange between shards.

Each path is driven with every kernel's launch count set to 0 just before
and read just after, and checked against the f64 golden, across schedules
and (P=8) ghost column against owner column.  Then each kernel is compared
with its plain PyTorch version on the card at the paths' shapes, and the
kernels and every schedule's step are timed.

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
K1_TOL = 1e-6    # sweep kernels vs plain: FMA contraction, relative to max|ref|
GOLDEN_TOL = 1e-5   # every schedule vs f64 golden (the reference's gate)
SCHED_TOL = 1e-6    # early vs bulk, overlap vs early, relative to max|bulk|
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
}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this run needs "
              "a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np

        from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
        from cfd_proxy_tpu.mesh.partition import partition_mesh
        from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
        from cfd_proxy_tpu_torch.ops import _cuda
        from cfd_proxy_tpu_torch.ops import blocksweep as bs
        from cfd_proxy_tpu_torch.ops.golden import (compute_gradients_gg,
                                                    scale_gradients)
        from cfd_proxy_tpu_torch.solver import time_schedule
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              f"root of a checkout", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)

    def reset_counts():
        bs.pack_srcs.launches = 0
        bs.sweep_blocks.launches = 0
        bs.sweep_blocks.init_launches = 0
        bs.sweep_blocks_overlap.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {"pack_srcs": bs.pack_srcs.launches,
                "sweep_blocks": bs.sweep_blocks.launches,
                "sweep_blocks_init": bs.sweep_blocks.init_launches,
                "sweep_blocks_overlap": bs.sweep_blocks_overlap.launches}

    launches = dict.fromkeys(KERNELS, 0)    # summed over the counted paths

    def expect_counts(path, counts, names):
        for k, n in counts.items():
            launches[k] += n
        missing = [k for k in names if counts[k] <= 0]
        if missing:
            fail(f"{path} launched no {missing} kernel")

    def golden_relmax(model, g):
        got = model.gather_global(g)
        if got.shape != ref.shape or not np.isfinite(got).all():
            fail(f"output shape {got.shape} (expected {ref.shape}) or "
                 f"non-finite values")
        return float(np.abs(got - ref).max() / denom)

    def check_schedules(path, model, outs):
        """Every schedule vs the golden; early vs bulk, overlap vs early."""
        rel = {s: golden_relmax(model, g) for s, g in outs.items()}
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
    ref = scale_gradients(
        compute_gradients_gg(gvar.astype(np.float64), gmesh.faces,
                             gmesh.normals),
        gmesh.volume, gmesh.npoint).reshape(gmesh.npoint, -1)
    denom = max(1.0, float(np.abs(ref).max()))
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
    expect_counts("main_path_p1_all", counts, KERNELS)
    del outs
    step_ms = {1: {}, P_MULTI: {}}
    for s in ("bulk", "early", "overlap", "nocomm"):
        st = time_schedule(model, state, s, TIMED_STEPS, warmup=2, repeats=5)
        step_ms[1][s] = st.median * 1e3
    del model, state

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
    g = outs["early"].cpu().numpy()
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
            if not np.array_equal(g[i][:, recv_cols],
                                  g[e.partner][:, send_cols]):
                fail(f"main_path_p8: ghost columns of shard {i} from "
                     f"{e.partner} round {e.round} differ from the owner's")
            nghost += len(recv_cols)
    emit("main_path_p8", parts=P_MULTI, partition_seconds=t_part,
         model_seconds=t_model, bp=model.bp, ndev=model.ndev,
         nphases=model.nphases, s_max=model.s_max,
         wks={c: list(w) for c, w in model.wks.items()},
         vs_golden_relmax=rel, tol=GOLDEN_TOL, cross=cross,
         max_abs_bulk=scale, cross_tol=SCHED_TOL * scale,
         ghost_columns_checked=nghost, launches=counts)
    if nghost == 0:
        fail("main_path_p8: no ghost column to check")
    expect_counts("main_path_p8", counts, KERNELS)

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
    emit("timing_schedules", card=smi, step_ms=step_ms,
         faces_per_sec={p: {s: nface / (v * 1e-3) for s, v in d.items()}
                        for p, d in step_ms.items()},
         kernels=times, steps=TIMED_STEPS)
    if bad:
        fail(f"step timing fell below the two-point noise floor: {bad}")

    rows = [{"name": name, "route": route, "source": src, "replaces": line,
             "launches": launches[name], "max_abs_err": errs[name],
             **times[name]}
            for name, (route, src, line) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
