"""Benchmark CLI of the port — counterpart of `cfd_proxy_tpu/solver.py`.

Builds the model on a generated (or read) one-shard mesh, distributes the
state, times the chained bulk loop with the reference's two-point sampler,
verifies against the f64 golden, and prints the same table and verify lines
as the reference CLI:

    python -m cfd_proxy_tpu_torch.solver --nx 96 --ny 96 --nz 96 \
        --schedule bulk --iters 300

The port runs one slice of the reference: one shard, the `bulk` schedule,
the packed kernel in the compact layout, f32, Green-Gauss.  Every other
option is accepted by the parser so that it can be refused by name
(`CheckError`, naming the ROADMAP item that brings it), never ignored.
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

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.mesh.reader import partition_path, read_partition
from cfd_proxy_tpu.utils.errors import check
from cfd_proxy_tpu.utils.timing import (IterationStats, format_stats_table,
                                        two_point_sampler)
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops.golden import (compute_gradients_gg,
                                            scale_gradients)


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
    schedule: str = "bulk"
    model: str = "gg"
    kernel: str = "packed"
    kcompact: bool | None = None
    bp: int | None = None
    meta_dtype: str = "float32"
    src_dtype: str = "float32"
    halo_dtype: str = "float32"
    grad_dtype: str = "float32"
    solver_mode: bool = False
    diag_frac: float = 0.2
    jitter: float = 0.05
    seed: int = 0
    device: str = "cuda"
    verify: bool = True
    json_out: bool = False


def check_config(cfg: SolverConfig) -> None:
    """Refuse, by name, every option outside the ported slice."""
    check(cfg.parts == 1, "--parts %d: the port runs one shard; P>1 comes "
          "with ROADMAP queue 1 item 4 (halo exchange at P>1)", cfg.parts)
    check(cfg.schedule == "bulk", "--schedule %s: the port runs 'bulk'; "
          "'early' is ROADMAP queue 1 item 5, 'overlap' item 6 ('all' needs "
          "both)", cfg.schedule)
    check(cfg.kernel == "packed", "--kernel %s: the gather formulation (K2) "
          "comes with ROADMAP queue 1 item 7 (solver mode)", cfg.kernel)
    check(cfg.model == "gg", "--model %s: the flux model comes with ROADMAP "
          "queue 1 item 8", cfg.model)
    for name in ("meta_dtype", "src_dtype", "halo_dtype", "grad_dtype"):
        check(getattr(cfg, name) == "float32", "--%s %s: reduced-precision "
              "options come with ROADMAP queue 1 item 9",
              name.replace("_", "-"), getattr(cfg, name))
    check(not cfg.solver_mode, "--solver-mode comes with ROADMAP queue 1 "
          "item 7")
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
                            device=cfg.device)
    return model, gmesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_schedule(model: GreenGaussTorch, state: dict, schedule: str,
                  iters: int, warmup: int, repeats: int = 3) -> IterationStats:
    """Two-point timing: chained loops of n0 and n0+iters steps, each ended
    by a device synchronise; their difference over iters is the per-step
    time with the fixed per-run cost cancelled."""
    n0 = max(1, iters // 10)
    small = model.iterate_fn(schedule, n0)
    big = model.iterate_fn(schedule, n0 + iters)
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


def verify_model(model: GreenGaussTorch, state: dict, gmesh,
                 gvar: np.ndarray) -> dict:
    """Bulk result against the f64 golden (when the global mesh is in
    process), as the reference's verify_model reports it."""
    if gmesh is None:
        return {}
    ref = scale_gradients(
        compute_gradients_gg(gvar.astype(np.float64), gmesh.faces,
                             gmesh.normals),
        gmesh.volume, gmesh.npoint).reshape(gmesh.npoint, -1)
    got = model.gather_global(model.step(state, "bulk"))
    denom = max(1.0, float(np.abs(ref).max()))
    return {"bulk_vs_golden_relmax": float(np.abs(got - ref).max() / denom)}


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
    state = model.distribute_state(gvar)
    st = time_schedule(model, state, cfg.schedule, cfg.iters, cfg.warmup)
    entry = st.summary()
    entry["faces_per_sec"] = nface / st.median
    results = {
        "device": device_name(model.device),
        "npart": len(model.parts),
        "npoint": npoint,
        "nface": nface,
        "nvar": cfg.nvar,
        "dtype": "float32",
        "backend": "torch",
        "kernel": cfg.kernel,
        "bp": model.bp,
        "wks": list(model.wks),
        "iters": cfg.iters,
        "schedules": {cfg.schedule: entry},
    }
    if cfg.verify:
        results["verification"] = verify_model(model, state, gmesh, gvar)
    return results, [st]


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
    ap.add_argument("--schedule", default="bulk",
                    choices=["all", "bulk", "early", "overlap"])
    ap.add_argument("--model", default="gg", choices=["gg", "flux"])
    ap.add_argument("--kernel", default="packed", choices=["packed", "gather"])
    ap.add_argument("--kcompact", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--bp", type=int, default=None,
                    help="points per block (multiple of 128; default auto)")
    for name in ("meta", "src", "halo", "grad"):
        ap.add_argument(f"--{name}-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    ap.add_argument("--solver-mode", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--json", action="store_true", help="emit one JSON line")
    a = ap.parse_args(argv)
    cfg = SolverConfig(
        nx=a.nx, ny=a.ny, nz=a.nz, mesh_prefix=a.mesh_prefix, parts=a.parts,
        nvar=a.nvar, iters=a.iters, warmup=a.warmup, schedule=a.schedule,
        model=a.model, kernel=a.kernel,
        kcompact={"auto": None, "on": True, "off": False}[a.kcompact],
        bp=a.bp, meta_dtype=a.meta_dtype, src_dtype=a.src_dtype,
        halo_dtype=a.halo_dtype, grad_dtype=a.grad_dtype,
        solver_mode=a.solver_mode, seed=a.seed, device=a.device,
        verify=not a.no_verify, json_out=a.json)
    t0 = time.perf_counter()
    results, stats = run(cfg)
    results["wall_s"] = time.perf_counter() - t0
    if cfg.json_out:
        print(json.dumps(_finite_or_none(results)))
    else:
        print(f"device={results['device']} parts={results['npart']} "
              f"points={results['npoint']} faces={results['nface']} "
              f"nvar={results['nvar']} dtype={results['dtype']} "
              f"bp={results['bp']}")
        print(format_stats_table(stats, ref="bulk"))
        for s, e in results["schedules"].items():
            print(f"{s:<10} {e['faces_per_sec'] / 1e6:9.2f} Mfaces/s")
        for k, v in results.get("verification", {}).items():
            print(f"verify {k} = {v:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
