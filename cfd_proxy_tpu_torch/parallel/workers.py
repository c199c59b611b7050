"""Worker functions of multi-rank runs, importable by name so that
`parallel.launch.spawn` (whose children import them afresh) can start them.

Each runs in one process or as one rank of several: it joins the group the
environment describes when there is one (`launch.world_from_env`), builds
its inputs from seeds so that every rank holds the same, and returns plain
numpy data, the same on every rank where the docstring says so.  The tests
and `chip_smoke.py` hold a multi-rank result against the one-process
result of the same function.
"""

from __future__ import annotations

import hashlib
import sys
import time
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.models.gradients_ell import DTYPES, GreenGaussModel
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops import push
from cfd_proxy_tpu_torch.parallel import launch
from cfd_proxy_tpu_torch.parallel.transport import (Dist, Peer, gather_shards,
                                                    shard_range)


def join(device: str, backend: str | None, share_device: bool):
    """(group, rank, world, device) of this process: the environment's
    group, joined with `backend` (default nccl on cuda, gloo on the cpu) and
    the rank's device selected, or (None, 0, 1, device) in a lone process."""
    if launch.world_from_env() is None:
        return None, 0, 1, device
    return launch.join_rank(device, backend, share_device)


@dataclass
class ModelCase:
    """One model configuration on a generated mesh, with its seeds."""

    nx: int
    ny: int
    nz: int
    parts: int
    device: str = "cuda"
    nvar: int = 5
    mesh_seed: int = 41
    state_seed: int = 17
    diag_frac: float = 0.25
    schedules: tuple = ("bulk", "early", "overlap")
    solver_steps: int = 0           # > 0: also the solver-mode runner
    sweeps_per_step: int = 1
    backend: str | None = None      # the group's, when there are ranks
    share_device: bool = False
    timed_steps: int = 0            # > 0: also time each schedule's loop
    digest: bool = False            # return sha256 digests, not the arrays
    model: dict = field(default_factory=dict)   # GreenGaussTorch options


def digest(a: np.ndarray) -> str:
    """sha256 of an array's bytes: a bitwise comparison that travels as a
    string (a 96^3 output is 74 MB)."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@lru_cache(maxsize=2)
def _mesh_parts(nx, ny, nz, diag_frac, mesh_seed, nparts):
    mesh = generate_mesh(nx, ny, nz, jitter=0.05, diag_frac=diag_frac,
                         shuffle=True, seed=mesh_seed)
    return mesh, partition_mesh(mesh, nparts, ghost_layers=1)


def batch(jobs: list) -> list:
    """Run several workers of this module in one process (one group joined
    once): jobs are (function name, argument tuple); returns their results
    in order."""
    return [globals()[name](*args) for name, args in jobs]


def model_outputs(case: ModelCase, parts=None, arrays=None,
                  gvar=None) -> dict:
    """Build the case's model (this rank's share), run every schedule and
    gather: {"outputs": {schedule: global array}, "solver": the solver-mode
    runner's final state over all shards (or None), "launches": this
    rank's kernel launches, "transport", "kernel_phases",
    "collective_phases", "step_ms": {schedule: slowest rank's ms per step}
    (when timed), "foreign_modules": modules of JAX or of the JAX package
    this process has imported}.  The gathered arrays are the same on every
    rank.  With `parts`, `arrays` and `gvar` the model is loaded from
    another model's relabeled partitions and plan arrays (`from_arrays`)
    and run on that state, not built on the case's mesh."""
    group, rank, world, device = join(case.device, case.backend,
                                      case.share_device)
    if arrays is None:
        mesh, parts = _mesh_parts(case.nx, case.ny, case.nz, case.diag_frac,
                                  case.mesh_seed, case.parts)
        gvar = make_state(mesh.npoint, case.nvar, seed=case.state_seed)
    counters = bs.launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    model = GreenGaussTorch(parts, case.nvar, device=device, group=group,
                            share_device=case.share_device, arrays=arrays,
                            **case.model)
    try:
        state = model.distribute_state(gvar)
        outputs = {s: model.gather_global(model.step(state, s))
                   for s in case.schedules}
        if case.digest:
            outputs = {s: digest(a) for s, a in outputs.items()}
        solver = None
        if case.solver_steps:
            v = model.iterate_fn(case.schedules[0], case.solver_steps,
                                 solver_mode=True,
                                 sweeps_per_step=case.sweeps_per_step)(
                *model.iter_args(state))
            solver = gather_shards(v, model.group).numpy()
        step_ms = {}
        for s in case.schedules if case.timed_steps else ():
            step_ms[s] = _step_ms(model, state, s, case.timed_steps)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()
                    if getattr(fn, attr)}
        return {"outputs": outputs, "solver": solver, "launches": launches,
                "transport": model.transport_name,
                "kernel_phases": model.kernel_phases,
                "collective_phases": model.coll_phases, "step_ms": step_ms,
                "rank": rank, "world": world,
                "foreign_modules": sorted(
                    k for k, v in sys.modules.items() if v is not None and
                    k.split(".")[0] in ("jax", "cfd_proxy_tpu"))}
    finally:
        model.close()


def overlap_chain(case: ModelCase, steps: int, coupling: float) -> dict:
    """The case's model (this rank's share) runs `steps` chained overlap
    steps at `coupling` under its dispatch rule (graph on the card through
    `peer`, at any rank count) and eagerly: {"dispatch": the rule's kind,
    "graph_equals_eager": this rank's two final states bit for bit,
    "moved": how far the state moved, "digest": the sha256 of the final
    state over all shards (the same on every rank), "replay_kernels": the
    kernels one replay launches (`compiled.kernel_nodes`, graph only),
    "launches": this rank's kernel launches}."""
    group, rank, world, device = join(case.device, case.backend,
                                      case.share_device)
    mesh, parts = _mesh_parts(case.nx, case.ny, case.nz, case.diag_frac,
                              case.mesh_seed, case.parts)
    gvar = make_state(mesh.npoint, case.nvar, seed=case.state_seed)
    counters = bs.launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    model = GreenGaussTorch(parts, case.nvar, device=device, group=group,
                            share_device=case.share_device, **case.model)
    try:
        state = model.distribute_state(gvar, schedules=["overlap"])
        args = model.iter_args(state)
        kind, _ = compiled.dispatch(model, "overlap")
        graph = model.iterate_fn("overlap", steps, coupling=coupling)(*args)
        eager = model.iterate_fn("overlap", steps, graph=False,
                                 coupling=coupling)(*args)
        nodes = []
        if kind == compiled.GRAPH:
            entry = next(reversed(model.graphs.values()))
            nodes = compiled.kernel_nodes(entry.graphs[0])
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        return {"dispatch": kind, "rank": rank, "world": world,
                "graph_equals_eager": bool(torch.equal(graph, eager)),
                "moved": float((eager - args[0]).abs().max()),
                "digest": digest(gather_shards(graph, model.group).numpy()),
                "replay_kernels": len(nodes),
                "launches": {k: getattr(fn, attr)
                             for k, (fn, attr) in counters.items()
                             if getattr(fn, attr)}}
    finally:
        model.close()


def ell_outputs(case: ModelCase, dtype: str = "float64",
                exact: bool = True) -> dict:
    """The ELL model's (models/gradients_ell.py, this rank's share) every
    schedule, gathered: {"outputs": {schedule: global array}, "transport"};
    the same on every rank."""
    group, _, _, device = join(case.device, case.backend, case.share_device)
    mesh, parts = _mesh_parts(case.nx, case.ny, case.nz, case.diag_frac,
                              case.mesh_seed, case.parts)
    model = GreenGaussModel(parts, case.nvar, dtype=DTYPES[dtype],
                            device=device, group=group,
                            share_device=case.share_device)
    var = model.distribute_state(make_state(mesh.npoint, case.nvar,
                                            seed=case.state_seed))
    return {"outputs": {s: model.gather_global(model.step(var, s,
                                                          exact=exact))
                        for s in case.schedules},
            "transport": model.transport_name}


def _step_ms(model, state, schedule: str, n: int) -> float:
    """Host milliseconds per step of n chained steps, the slowest rank's
    (after a warm-up run of the same length)."""
    run = model.iterate_fn(schedule, n)
    args = model.iter_args(state)
    dist = torch.distributed
    t = 0.0
    for _ in range(2):
        if model.world > 1:
            dist.barrier(group=model.group)
        t0 = time.perf_counter()
        run(*args)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        t = (time.perf_counter() - t0) * 1e3 / n
    if model.world > 1:
        x = torch.tensor([t], dtype=torch.float64)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=model.group)
        t = float(x)
    return t


def dist_exchange(nshards: int, perms: list, shape: tuple, dtype: str,
                  seed: int, device: str = "cuda",
                  backend: str | None = None,
                  share_device: bool = False) -> np.ndarray:
    """This rank's `recv` of a `Dist` exchange of random send buffers: the
    (nshards, nph, rows, s_max) buffers come from a numpy seed (the same
    on every rank), each rank sends its slice.  Returns the rank's recv as
    raw bytes viewed uint8 (bf16 has no numpy type), shaped (P_local, nph,
    rows, s_max·itemsize)."""
    group, rank, world, device = join(device, backend, share_device)
    send = seeded_buffers(nshards, perms, shape, dtype, seed)
    lo, hi = shard_range(nshards, rank, world)
    t = Dist(perms, nshards, group, device, share_device)
    recv = t.exchange(send[lo:hi].contiguous().to(device))
    return as_bytes(recv)


def seeded_buffers(nshards: int, perms: list, shape: tuple, dtype: str,
                   seed: int) -> torch.Tensor:
    """(nshards, nph, *shape) random buffers from a numpy seed, f32 or
    rounded to bf16; a shard that sends nothing in a phase (it is in no
    pair of perms[k]) holds zeros there, as the model's send mask leaves
    it."""
    x = np.random.default_rng(seed).standard_normal(
        (nshards, len(perms), *shape)).astype(np.float32)
    for k, perm in enumerate(perms):
        idle = sorted(set(range(nshards)) - {s for s, _ in perm})
        x[idle, k] = 0.0
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def as_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a uint8 array (last axis widened)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy().copy()


def overlap_ref_exchange(case: ModelCase) -> dict:
    """The fused kernel's plain version with a transport: the case's model
    (packed), its interior operands, a seeded init and the model's own
    packed send buffers through `sweep_blocks_overlap_ref(...,
    transport=model.transport)`.  Returns {"grad", "recv"} over all shards
    (the same on every rank)."""
    group, rank, world, device = join(case.device, case.backend,
                                      case.share_device)
    mesh, parts = _mesh_parts(case.nx, case.ny, case.nz, case.diag_frac,
                              case.mesh_seed, case.parts)
    gvar = make_state(mesh.npoint, case.nvar, seed=case.state_seed)
    model = GreenGaussTorch(parts, case.nvar, device=device, group=group,
                            **case.model)
    state = model.distribute_state(gvar)
    init = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (case.parts, model.rows, model.ndev)).astype(np.float32))
    init = init[model.lo:model.hi].contiguous().to(device)
    send = model._pack(init, model.pack_scale, model.halo_t)
    g, r = bs.sweep_blocks_overlap_ref(
        state["var_T"], *model._operands("interior", state["tables"]), init,
        send, model.dsts, model.srcs, model.op, transport=model.transport)
    return {"grad": gather_shards(g, model.group).numpy(),
            "recv": gather_shards(r, model.group).numpy()}


def push_ring(nph: int, rows: int, lanes: int, device: str = "cuda",
              share_device: bool = False, backend: str | None = "gloo"
              ) -> dict:
    """K6 around a ring of ranks, every mode, twice each: rank r's send
    buffers hold r + 1 + a seeded pattern, so what arrives names its
    sender.  Returns {"bitwise": every recv equalled the plain version's,
    "modes": per mode}.  On the CPU the plain version itself runs through
    `Dist`."""
    from cfd_proxy_tpu_torch.tools.icibench import make_transport

    group, rank, world, device = join(device, backend, share_device)
    transport = make_transport(world, nph, rows, lanes, device, group)
    base = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, nph, rows, lanes)).astype(np.float32))
    modes = {}
    try:
        for mode in push.MODES:
            ok = True
            for it in range(2):
                bump = float(10 * it)
                send = (base + (rank + 1) + bump).to(device)
                got = push.push_phases(send, transport, mode).cpu()
                if mode in ("full", "nobar"):
                    want = base + ((rank - 1) % world + 1) + bump
                    ok = ok and bool(torch.equal(got, want))
                    # nobar has no barrier in the kernel: the group's
                    # keeps a sender off a buffer that is still being read
                    if world > 1:
                        torch.distributed.barrier(group=group)
                else:                   # phase 0, copied locally
                    ok = ok and bool(torch.equal(got[:, 0], send[:, 0].cpu()))
            modes[mode] = ok
    finally:
        if isinstance(transport, Peer):
            transport.close()
    return {"bitwise": all(modes.values()), "modes": modes, "rank": rank}


def raises(message: str) -> None:
    """A rank that fails: joins the group, then raises (launcher tests)."""
    launch.join_group("gloo")
    raise RuntimeError(message)


def never_joins(seconds: float) -> None:
    """Rank 0 waits for a group that rank 1 never joins (launcher tests):
    rank 0's `init_process_group` times out, rank 1 sleeps."""
    rank, _, _ = launch.world_from_env()
    if rank == 0:
        launch.join_group("gloo", timeout_s=seconds)
    else:
        time.sleep(600)
