#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`cfd_proxy_tpu_torch/`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; run from the root of a checkout.  It builds
the port's CUDA kernels from `cfd_proxy_tpu_torch/csrc/`, drives the port's
main path once at the benchmark size (a 96³-point generated mesh, ~2.8 M
faces, one shard, the `bulk` schedule, nvar 7, random state from a seed),
checks the result against the f64 golden, compares each kernel with its
plain PyTorch version on the card at the main path's shapes, times the bulk
step and both kernels, and checks that the main path launched every kernel.

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
TIMED_STEPS = 200
K1_TOL = 1e-6    # sweep kernel vs plain: FMA contraction, relative to max|ref|
GOLDEN_TOL = 1e-5   # main path vs f64 golden (the reference's gate)


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
    emit("mesh", npoint=gmesh.npoint, nface=gmesh.nface,
         seconds=time.perf_counter() - t0)

    # ---- main path, counted: model → state (pack) → bulk step → gather
    bs.pack_srcs.launches = 0
    bs.sweep_blocks.launches = 0
    t0 = time.perf_counter()
    model = GreenGaussTorch(parts, NVAR, device=dev)
    t_model = time.perf_counter() - t0
    state = model.distribute_state(gvar)
    grad = model.step(state, "bulk")
    got = model.gather_global(grad)
    torch.cuda.synchronize()
    launches = {"pack_srcs": bs.pack_srcs.launches,
                "sweep_blocks": bs.sweep_blocks.launches}
    ref = scale_gradients(
        compute_gradients_gg(gvar.astype(np.float64), gmesh.faces,
                             gmesh.normals),
        gmesh.volume, gmesh.npoint).reshape(gmesh.npoint, -1)
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"main path output shape {got.shape} (expected {ref.shape}) "
             f"or non-finite values")
    relmax = float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))
    emit("main_path", bp=model.bp, ndev=model.ndev, wks=list(model.wks),
         nblocks=int(model.block_ids.shape[0]),
         L=int(model.src_cols.shape[1]), model_seconds=t_model,
         bulk_vs_golden_relmax=relmax, tol=GOLDEN_TOL, launches=launches)
    if not relmax <= GOLDEN_TOL:
        fail(f"bulk vs golden relmax {relmax:.3e} > {GOLDEN_TOL}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"main path launched no {missing} kernel")

    # ---- kernels vs their plain versions, at the main path's shapes
    var_T = state["var_T"]
    args = (model.slot_w, model.scale, model.block_ids, model.slots)
    tbl = bs.pack_srcs(var_T, model.src_cols)
    tbl_ref = bs.pack_srcs_ref(var_T, model.src_cols)
    torch.cuda.synchronize()
    k4_err = float((tbl - tbl_ref).abs().max())
    out = bs.sweep_blocks(var_T, tbl_ref, *args)
    out_ref = bs.sweep_blocks_ref(var_T, tbl_ref, *args)
    torch.cuda.synchronize()
    k1_err = float((out - out_ref).abs().max())
    k1_scale = float(out_ref.abs().max())
    emit("kernels", pack_srcs_max_abs_err=k4_err,
         sweep_blocks_max_abs_err=k1_err, sweep_blocks_max_abs_ref=k1_scale,
         sweep_blocks_tol=K1_TOL * k1_scale)
    if k4_err != 0.0:
        fail(f"pack_srcs differs from its plain version (max {k4_err})")
    if not k1_err <= K1_TOL * k1_scale:
        fail(f"sweep_blocks differs from its plain version: {k1_err:.3e} > "
             f"{K1_TOL} x {k1_scale:.3e}")

    # ---- timing: kernels vs plain (same call, in turns), then the bulk step
    n = 50
    times = {}
    for name, kern, plain in (
            ("pack_srcs",
             lambda: bs.pack_srcs(var_T, model.src_cols),
             lambda: bs.pack_srcs_ref(var_T, model.src_cols)),
            ("sweep_blocks",
             lambda: bs.sweep_blocks(var_T, tbl, *args),
             lambda: bs.sweep_blocks_ref(var_T, tbl, *args))):
        p1, k1 = cuda_ms(plain, n), cuda_ms(kern, n)
        k2, p2 = cuda_ms(kern, n), cuda_ms(plain, n)
        times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2)}
    st = time_schedule(model, state, "bulk", TIMED_STEPS, warmup=2,
                       repeats=5)
    nface = gmesh.nface
    emit("timing", card=smi, kernels=times, bulk_step_ms=st.median * 1e3,
         bulk_step_ms_all=[t * 1e3 for t in st.times],
         faces_per_sec=nface / st.median, steps=TIMED_STEPS)
    if not np.isfinite(st.median):
        fail("bulk step timing fell below the two-point noise floor")

    rows = []
    for name, src, line, err in (
            ("pack_srcs", "cfd_proxy_tpu_torch/csrc/pack_srcs.cu",
             "cfd_proxy_tpu/ops/blocksweep.py:940", k4_err),
            ("sweep_blocks", "cfd_proxy_tpu_torch/csrc/sweep_packed.cu",
             "cfd_proxy_tpu/ops/blocksweep.py:549", k1_err)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": line, "launches": launches[name],
                     "max_abs_err": err, **times[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
