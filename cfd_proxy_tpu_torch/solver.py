"""Benchmark CLI of the port — counterpart of `cfd_proxy_tpu/solver.py`.

Builds the model on a generated (or read) mesh cut into P shards, all held
on one device, distributes the state, times each schedule's chained loop
with the reference's two-point sampler (and the compute-only `nocomm` floor
when several schedules run, for the overlap efficiency), verifies every
schedule against bulk and bulk against the f64 golden, and prints the same
table and verify lines as the reference CLI:

    python -m cfd_proxy_tpu_torch.solver --nx 96 --ny 96 --nz 96 \
        --parts 8 --schedule all --iters 300
    python -m cfd_proxy_tpu_torch.solver --nx 96 --ny 96 --nz 96 \
        --schedule bulk --solver-mode --sweeps-per-step 4

The port runs f32 Green-Gauss gradients (`--model gg`) or the PSD upwind
flux (`--model flux`, ops/flux.py) with the packed (compact layout) or the
gather kernel (`--kernel`) under the bulk / early / overlap schedules
(`--force-rdma`: the fused overlap kernel even at one shard).
`--solver-mode` times the per-time-step dataflow of a real solver (table
rebuild, `--sweeps-per-step` sweeps with their updates, var halo exchange)
instead of the static-state iteration; without `--kernel` it takes the
kernel and block size `solver_mode_defaults` decides.  Every other option
is accepted by the parser so that it can be refused by name (`CheckError`,
naming the ROADMAP item that brings it), never ignored.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.mesh.reader import partition_path, read_partition
from cfd_proxy_tpu_torch.models.gradients import KERNELS, GreenGaussTorch
from cfd_proxy_tpu_torch.ops.blocksweep import OPS
from cfd_proxy_tpu_torch.ops.flux import compute_psd_flux, flux_residual_scale
from cfd_proxy_tpu_torch.ops.golden import (compute_gradients_gg,
                                            scale_gradients)
from cfd_proxy_tpu_torch.utils.errors import check
from cfd_proxy_tpu_torch.utils.timing import (IterationStats,
                                              format_stats_table,
                                              two_point_sampler)

SCHEDULES = ("bulk", "early", "overlap")     # what --schedule all times
# a comm cost (bulk - nocomm) under this share of the bulk median is
# two-point timing noise: no overlap efficiency is reported (the reference's
# gate, cfd_proxy_tpu/solver.py:371-375)
NOISE_GATE = 0.05


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
    nvar: int = 7
    iters: int = 20
    warmup: int = 3
    schedule: str = "all"
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
    diag_frac: float = 0.2
    jitter: float = 0.05
    seed: int = 0
    device: str = "cuda"
    verify: bool = True
    json_out: bool = False


def check_config(cfg: SolverConfig) -> None:
    """Refuse, by name, every option outside the ported slice."""
    check(cfg.parts >= 1, "--parts %d: need at least one shard", cfg.parts)
    check(cfg.schedule in ("all", *SCHEDULES), "unknown --schedule %s",
          cfg.schedule)
    check(cfg.slice_size is None, "--slice-size %s: multi-node phase "
          "routing comes with ROADMAP queue 1 item 12", cfg.slice_size)
    check(cfg.kernel in KERNELS, "unknown --kernel %s", cfg.kernel)
    check(cfg.model in OPS, "unknown --model %s", cfg.model)
    for name in ("meta_dtype", "src_dtype", "halo_dtype", "grad_dtype"):
        check(getattr(cfg, name) == "float32", "--%s %s: reduced-precision "
              "options come with ROADMAP queue 1 item 9",
              name.replace("_", "-"), getattr(cfg, name))
    check(cfg.sweeps_per_step >= 1, "--sweeps-per-step %d: need at least "
          "one sweep per step", cfg.sweeps_per_step)
    check(cfg.sweeps_per_step == 1 or cfg.solver_mode, "--sweeps-per-step "
          "requires --solver-mode (the static iteration never rebuilds "
          "tables)")
    check(cfg.device in ("cuda", "cpu"), "--device %s: cuda or cpu",
          cfg.device)
    check(cfg.device != "cuda" or torch.cuda.is_available(),
          "--device cuda but torch sees no CUDA device (use --device cpu "
          "for the plain PyTorch versions)")


def build_model(cfg: SolverConfig):
    if cfg.mesh_prefix:
        parts = [read_partition(partition_path(cfg.mesh_prefix, i, cfg.parts))
                 for i in range(cfg.parts)]
        gmesh = None
    else:
        gmesh = generate_mesh(cfg.nx, cfg.ny, cfg.nz, jitter=cfg.jitter,
                              diag_frac=cfg.diag_frac, seed=cfg.seed)
        parts = partition_mesh(gmesh, cfg.parts)
    model = GreenGaussTorch(parts, cfg.nvar, bp=cfg.bp, kcompact=cfg.kcompact,
                            force_rdma=cfg.force_rdma, kernel=cfg.kernel,
                            op=cfg.model, device=cfg.device)
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
    sample = two_point_sampler(lambda: run(small), lambda: run(big), iters)
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


def verify_model(model: GreenGaussTorch, state: dict, schedules, gmesh,
                 gvar: np.ndarray) -> dict:
    """Every schedule against bulk (max abs over all columns) and bulk
    against the f64 golden of the model's op (when the global mesh is in
    process), as the reference's verify_model reports them."""
    ref = model.step(state, "bulk")
    out = {}
    for s in schedules:
        if s != "bulk":
            out[f"{s}_vs_bulk_maxabs"] = float(
                (model.step(state, s) - ref).abs().max())
    if gmesh is not None:
        gg = golden(model.op, gmesh, gvar)
        got = model.gather_global(ref)
        denom = max(1.0, float(np.abs(gg).max()))
        out["bulk_vs_golden_relmax"] = float(np.abs(got - gg).max() / denom)
    return out


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(cfg: SolverConfig) -> tuple[dict, list[IterationStats]]:
    check_config(cfg)
    model, gmesh = build_model(cfg)
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
    for s in schedules:
        st = time_schedule(model, state, s, cfg.iters, cfg.warmup, **mode)
        stats.append(st)
        entries[s] = {**st.summary(),
                      "faces_per_sec": nface * sweeps / st.median}
    if len(schedules) > 1:
        # compute-only floor: the bulk sweep without the exchange
        st = time_schedule(model, state, "nocomm", cfg.iters, cfg.warmup,
                           **mode)
        stats.append(st)
        overlap_efficiency(entries, st.median, len(model.parts))
    results = {
        "device": device_name(model.device),
        "npart": len(model.parts),
        "npoint": npoint,
        "nface": nface,
        "nvar": cfg.nvar,
        "model": cfg.model,
        "dtype": "float32",
        "backend": "torch",
        "kernel": cfg.kernel,
        "bp": model.bp,
        "wks": {c: list(w) for c, w in model.wks.items()},
        "force_rdma": cfg.force_rdma,
        "solver_mode": cfg.solver_mode,
        "sweeps_per_step": cfg.sweeps_per_step if cfg.solver_mode else None,
        "iters": cfg.iters,
        "schedules": entries,
    }
    if len(schedules) > 1:
        results["nocomm_median_s"] = stats[-1].median
    if cfg.verify:
        results["verification"] = verify_model(model, state, schedules,
                                               gmesh, gvar)
    return results, stats


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--json", action="store_true", help="emit one JSON line")
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
        nvar=a.nvar, iters=a.iters, warmup=a.warmup, schedule=a.schedule,
        force_rdma=a.force_rdma, slice_size=a.slice_size, model=a.model,
        kernel=a.kernel,
        kcompact={"auto": None, "on": True, "off": False}[a.kcompact],
        bp=a.bp, meta_dtype=a.meta_dtype, src_dtype=a.src_dtype,
        halo_dtype=a.halo_dtype, grad_dtype=a.grad_dtype,
        solver_mode=a.solver_mode, sweeps_per_step=a.sweeps_per_step,
        seed=a.seed, device=a.device,
        verify=not a.no_verify, json_out=a.json)
    t0 = time.perf_counter()
    results, stats = run(cfg)
    results["wall_s"] = time.perf_counter() - t0
    if cfg.json_out:
        print(json.dumps(_finite_or_none(results)))
    else:
        print(f"device={results['device']} parts={results['npart']} "
              f"points={results['npoint']} faces={results['nface']} "
              f"model={results['model']} "
              f"nvar={results['nvar']} dtype={results['dtype']} "
              f"kernel={results['kernel']} bp={results['bp']}"
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
