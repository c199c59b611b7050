"""One run of a cell on one rank: set-up, the window of report intervals, the
traced stretch and the comparison with the reference.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(`cfdbench/configs/<config>.json`: the mesh recipe, nvar, precision, solver
mode, the kernel choice and the comparison's limits) under a traffic mix
(`cfdbench/traffic/<traffic>.json`: shards, ranks, transport, schedule and
the steps per report interval).  `run_rank(spec)` runs in the process that
prints the result (one rank) or in each spawned rank; it returns plain data.

The window drives the program's entry, `GreenGaussTorch.iterate_fn(schedule,
k, solver_mode)` over `iter_args(state)`, on the dispatch the program's rule
picks: a report interval is k chained steps, each interval's state fed into
the next, then a synchronise.  Its host time runs from the launch to the
synchronise's return.  Intervals follow each other with nothing between.

What decides `correct` (PERF.md gives the readings each limit was set from),
both numbers taken on the window's final state, each interval's output fed
into the next, so a state the window spoiled fails them too.  The window's
coupling, 1e-30, leaves an f32 state as it was, so the state alone shows
nothing of the gradients:

- `step_err`: the same entry on that state at a coupling that shows the
  gradients, 2^-ceil(log2(2n)): n = 1 step for the fixed-table loop, whose
  tables hold the set-up's state, and n = k steps in solver mode, where each
  step rebuilds its tables from the state it carries and runs the var
  exchange.  The state's change at every point column (owned and ghost)
  against the reference's, in f64, over the largest reference change.
- `grad_err`: the program's step (`model(...)`: the sweeps with their
  exchange, whose first component the update reads) on that state (in solver
  mode after `refresh_state`: the var exchange and the table rebuild), all
  3·nvar components at every point column, ghosts included, against the
  reference's gradients, over their largest magnitude.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
import traceback
from contextlib import nullcontext

import numpy as np
import torch

from cfdbench import meshgen, trace
from cfdbench.reference import gg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "cfdbench")
WARM_INTERVALS = 2          # the first captures the step's graphs
CALIBRATE_INTERVALS = 8     # timed to size the window
TRACE_STEPS = 256           # the traced stretch's steps, at least
FOREIGN = ("jax", "jaxlib", "flax", "cfd_proxy_tpu")
CHECKS = ("step_err", "grad_err")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ----------------------------------------------------------------- cells

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration and traffic
    read from their files: {"name", "chips", "config", "traffic",
    "per_layer": [metric names]}."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    tr = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    if tr["ranks"] != w["chips"]:
        raise ValueError(f"{name}: traffic {w['traffic']} runs "
                         f"{tr['ranks']} ranks, the cell asks {w['chips']} "
                         "chips")
    per_layer = [m["name"] for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m["name"] for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return {"name": name, "chips": w["chips"], "config": config,
            "traffic": tr, "per_layer": per_layer, "end_to_end": end_to_end,
            "units": units}


def metric_reader(name: str):
    """The reader of the per-layer metric `name`:
    `cfdbench/metrics/<name>.py`'s `read`."""
    import importlib.util

    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "cfdbench.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------- helpers

def foreign_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, compared
    by whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FOREIGN})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allreduce_max(values: list, group) -> list:
    """Element-wise max of a list of floats over the group (gloo: on the
    host; nccl: on the rank's device)."""
    if group is None:
        return list(values)
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64)
    if dist.get_backend(group) == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.cpu().tolist()


def _launch_counts() -> dict:
    from cfd_proxy_tpu_torch.models import compiled

    return {k: getattr(fn, a)
            for k, (fn, a) in compiled.launch_counters().items()}


def _counted(before: dict, after: dict) -> dict:
    """The program's own launch counters over a stretch: its sweep kernels
    and the direct body's table, whose kernel's name holds `sweep_`."""
    return {"sweep": sum(after[k] - before[k] for k in after
                         if k.startswith("sweep_") or k == "gather_table")}


def _stages(t0: float, marks: dict) -> dict:
    """Seconds of each set-up stage, from the process's start: to this
    rank's start (imports, the launcher), then each stage of `build`, the
    warm-up (graph capture; the first run in a checkout also builds the
    kernels) and the window's sizing."""
    out, at = {}, t0
    for name, t in marks.items():
        out[name] = round(t - at, 3)
        at = t
    return out


def _rows(x: np.ndarray, rows: slice, cols: np.ndarray) -> np.ndarray:
    return x[rows][:, cols].astype(np.float64)


# -------------------------------------------------------------- the run

def build(spec: dict, group, device: torch.device, marks: dict):
    """The inputs from the seed and the program's own set-up: the mesh, the
    state, partition_mesh, the model with the configuration's options, its
    state on the device.  Returns (mesh, gvar, model, var_T, tables); the
    wall-clock time each stage ended goes into `marks`."""
    from cfd_proxy_tpu_torch.mesh.generator import GlobalMesh
    from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
    from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch

    cfg, tr = spec["config"], spec["traffic"]
    g = cfg["mesh"]
    mesh = meshgen.generate(g["nx"], g["ny"], g["nz"], jitter=g["jitter"],
                            diag_frac=g["diag_frac"], seed=g["seed"])
    gvar = meshgen.state(mesh.npoint, cfg["nvar"], spec["seed"])
    marks["inputs"] = time.time()
    parts = partition_mesh(GlobalMesh(coords=mesh.coords, faces=mesh.faces,
                                      normals=mesh.normals,
                                      volume=mesh.volume),
                           tr["shards"], ghost_layers=1)
    marks["partition"] = time.time()
    opts = dict(cfg.get("model", {}))
    if cfg["kernel_choice"] == "solver_mode_defaults":
        from cfd_proxy_tpu_torch.solver import solver_mode_defaults

        kernel, bp = solver_mode_defaults(1)
        opts.update(kernel=kernel, bp=bp)
    opts.update(spec.get("overrides", {}))
    model = GreenGaussTorch(parts, cfg["nvar"], device=device, group=group,
                            transport=spec.get("transport", tr["transport"]),
                            **opts)
    marks["model"] = time.time()
    state = model.distribute_state(gvar, schedules=[tr["schedule"]])
    var_T, tables = model.iter_args(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["state"] = time.time()
    return mesh, gvar, model, var_T, tables


def run_rank(spec: dict) -> dict:
    """One rank's run (module docstring).  spec: the cell's `config` and
    `traffic`, `seed`, `seconds`, `trace`, `device` ("cuda", or "cpu" for the
    tests), `t0` (the wall-clock time the run's first process started),
    optional `overrides` (model options) and `transport`."""
    from cfd_proxy_tpu_torch.models import compiled

    cfg, tr = spec["config"], spec["traffic"]
    group, rank, world = None, 0, 1
    device = spec["device"]
    if tr["ranks"] > 1:
        from cfd_proxy_tpu_torch.parallel import launch

        group, rank, world, device = launch.join_rank(
            device, tr.get("backend", "gloo"))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    marks = {"start": time.time()}
    mesh, gvar, model, var_T, tables = build(spec, group, device, marks)
    schedule, k = tr["schedule"], int(tr["steps_per_interval"])
    solver_mode = bool(cfg["solver_mode"])
    coupling = float(cfg["coupling"])
    run = model.iterate_fn(schedule, k, solver_mode, coupling=coupling)
    kind, why = compiled.dispatch(model, schedule, solver_mode)

    # warm-up (graph capture) and the window's size, both in set-up
    v = var_T
    for _ in range(WARM_INTERVALS):
        v = run(v, tables)
    _sync(device)
    marks["warm-up"] = time.time()
    took = []
    for _ in range(CALIBRATE_INTERVALS):
        t = time.perf_counter()
        v = run(v, tables)
        _sync(device)
        took.append(time.perf_counter() - t)
    t_iv = _allreduce_max([float(np.median(took))], group)[0]
    n_iv = max(1, round(spec["seconds"] / t_iv))
    if spec["trace"]:
        n_prof = max(1, math.ceil(TRACE_STEPS / k))
        i0 = max(1, min(n_iv // 3, n_iv - n_prof))
        n_iv = max(n_iv, i0 + n_prof)
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)

    # the window
    times, failed, error, prof = [], 0, None, None
    summary, counted = None, None
    t_wall0 = marks["window"] = time.time()
    t_first = time.perf_counter()
    for i in range(n_iv):
        if spec["trace"] and i == i0 - 1:
            # the profiler starts an interval ahead of the stretch, so that
            # its start-up falls outside it
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
        if prof is not None and i == i0:
            span = record_function(trace.STRETCH)
            span.__enter__()
            before = _launch_counts()
        t = time.perf_counter()
        try:
            with (record_function("cfdbench.launch_interval")
                  if prof is not None else nullcontext()):
                v = run(v, tables)
            with (record_function("cfdbench.synchronize")
                  if prof is not None else nullcontext()):
                _sync(device)
        except Exception:           # the run goes on to report the failure
            error = traceback.format_exc()
            failed = k * (n_iv - i)
            log(f"interval {i} raised:\n{error}")
            break
        times.append(time.perf_counter() - t)
        if prof is not None and i == i0 + n_prof - 1:
            span.__exit__(None, None, None)
            counted = _counted(before, _launch_counts())
            prof.__exit__(None, None, None)
            traced, prof = prof, None
    window_s = time.perf_counter() - t_first
    if prof is not None:            # an interval raised inside the stretch
        prof.__exit__(None, None, None)
    if counted is not None:
        summary = trace.from_profiler(traced, n_prof * k)
        summary["counted"] = counted
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

    checks = _check(spec, mesh, gvar, model, v, tables, device, group,
                    error is None)
    out = {"rank": rank, "world": world, "setup_s": t_wall0 - spec["t0"],
           "window_s": window_s, "intervals_s": times,
           "steps": k * len(times), "attempted": k * n_iv,
           "failed": failed, "memory_peak_bytes": int(mem_peak),
           "faces": mesh.nface, "points": mesh.npoint, "nvar": cfg["nvar"],
           "dispatch": [kind, why], "interval_probe_s": t_iv,
           "setup_stages": _stages(spec["t0"], marks),
           "checks": checks, "trace": summary,
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "foreign_modules": foreign_modules()}
    if group is not None:
        import torch.distributed as dist

        every = [None] * world
        dist.all_gather_object(every, out, group=group)
        return {"ranks": every} if rank == 0 else {"rank": rank}
    return {"ranks": [out]}


def _check(spec, mesh, gvar, model, v_w, tables, device, group,
           ran) -> dict:
    """The numbers compared (module docstring), each the largest over the
    ranks, beside its limit.  The program's state is freed before the
    reference runs."""
    cfg, tr = spec["config"], spec["traffic"]
    schedule, k = tr["schedule"], int(tr["steps_per_interval"])
    solver_mode = bool(cfg["solver_mode"])
    nvar = cfg["nvar"]
    n_chk = k if solver_mode else 1
    c_chk = 2.0 ** -math.ceil(math.log2(2 * n_chk))
    v1 = model.iterate_fn(schedule, n_chk, solver_mode,
                          coupling=c_chk)(v_w, tables)
    if solver_mode:
        st = model.refresh_state(v_w.clone(), schedules=[schedule])
        g = model(st["var_T"], st["tables"], schedule)
    else:
        g = model(v_w, tables, schedule)
    _sync(device)
    vw_h = v_w.cpu().numpy()
    v1_h = v1.cpu().numpy()
    g_h = g.float().cpu().numpy()
    rows = g_h.shape[1] // 3            # the program's rows per component
    lo = model.lo
    cols = [model.locmap[lo + i] for i in range(vw_h.shape[0])]
    gids = [model.parts[lo + i].global_ids for i in range(vw_h.shape[0])]
    model.close()
    del model, tables, v_w, v1, g
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = gg.Mesh64(mesh.faces, mesh.normals, mesh.volume, device)
    r0 = torch.as_tensor(gvar, device=device).double()
    grad = gg.gradients(ref, r0).cpu().numpy()
    dref = (gg.chain(ref, r0, c_chk, n_chk) - r0).cpu().numpy()
    del ref, r0
    diff = [0.0, 0.0]
    for i, (m, gid) in enumerate(zip(cols, gids)):
        step = _rows(v1_h[i], slice(0, nvar), m) - _rows(vw_h[i],
                                                         slice(0, nvar), m)
        diff[0] = max(diff[0], float(np.abs(step - dref[gid].T).max()))
        for d in range(3):
            got = _rows(g_h[i], slice(d * rows, d * rows + nvar), m)
            diff[1] = max(diff[1], float(np.abs(got - grad[gid, :, d].T)
                                         .max()))
    diff = [x if math.isfinite(x) else math.inf for x in diff]
    diff = _allreduce_max(diff, group)
    scale = (float(np.abs(dref).max()), float(np.abs(grad).max()))
    limits = cfg["limits"]
    out = {}
    for name, d, s in zip(CHECKS, diff, scale):
        out[name] = {"value": d / s if ran else math.inf,
                     "limit": float(limits[name])}
    return out
