"""Start and join the ranks of a multi-process run.

Two ways in.  `spawn(world, fn, args)` starts `world` processes on this
machine (`torch.multiprocessing`, start method "spawn": a forked child
would inherit a CUDA context it cannot use), hands each its rank and a
`file://` rendezvous in a fresh temporary directory through the
environment (never a fixed TCP port: several runs may share a machine),
calls `fn(*args)` in each, and returns the ranks' results in rank order.
Or `torchrun` starts the processes and sets `RANK`, `WORLD_SIZE` and
`LOCAL_RANK` itself.  Either way the worker calls `join_group(backend)`,
which reads the environment and returns the process group.

`fn` must be importable by name (a module-level function of an installed or
importable package): the children import it afresh.

A run cannot hang its parent.  `init_process_group` gets a timeout; the
parent polls its children and, when one dies or raises, or when the time
limit passes, kills the rest and raises a `RuntimeError` that carries the
child's traceback.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cfd_proxy_tpu_torch.utils.errors import check
from cfd_proxy_tpu_torch.utils.timing import two_point_sampler

ENV_INIT = "CFD_PROXY_DIST_INIT"        # spawn's rendezvous, a file:// URL
INIT_TIMEOUT_S = 60.0


def world_from_env() -> tuple[int, int, int] | None:
    """(rank, world size, local rank) when a launcher set them, else None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return (rank, int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", rank)))


def join_group(backend: str, timeout_s: float = INIT_TIMEOUT_S):
    """Join the process group the environment describes (`spawn`'s or
    torchrun's) and return (group, rank, world size, local rank).  For the
    nccl backend the caller selects its CUDA device first."""
    env = world_from_env()
    check(env is not None, "join_group: RANK and WORLD_SIZE are not set "
          "(start the ranks with parallel.launch.spawn or torchrun)")
    rank, world, local = env
    if not dist.is_initialized():
        # spawn's file rendezvous, else torchrun's MASTER_ADDR/MASTER_PORT
        dist.init_process_group(
            backend, init_method=os.environ.get(ENV_INIT, "env://"),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD, rank, world, local


def rank_device(device: str, local_rank: int, share_device: bool) -> str:
    """The device of a rank: `cuda:<local rank>`, modulo the cards when
    several ranks may share one; the CPU as it is."""
    if device != "cuda":
        return device
    cards = torch.cuda.device_count()
    return f"cuda:{local_rank % cards if share_device else local_rank}"


def join_rank(device: str, backend: str | None = None,
              share_device: bool = False):
    """(group, rank, world size, device) of this process as one rank of the
    environment's group: selects the rank's CUDA device, then joins with
    `backend` (default nccl on cuda, gloo on the cpu)."""
    env = world_from_env()
    check(env is not None, "join_rank: RANK and WORLD_SIZE are not set "
          "(start the ranks with parallel.launch.spawn or torchrun)")
    device = rank_device(device, env[2], share_device)
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.startswith("cuda") else "gloo")
    group, rank, world, _ = join_group(backend)
    return group, rank, world, device


def leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def slowest_rank_sampler(group, device, run_small, run_big, iters: int):
    """`two_point_sampler` across the ranks of `group`: each rank times its
    own two loops, each entered after a barrier, and the sample is the
    slowest rank's per-step time (one all-reduce MAX per sample, outside
    the timed loops), as an MPI run reports it.  None on every rank when no
    rank's sample cleared the noise floor."""
    def after_barrier(fn):
        def run():
            dist.barrier(group=group)
            fn()
        return run

    inner = two_point_sampler(after_barrier(run_small),
                              after_barrier(run_big), iters)

    def sample():
        v = inner()
        t = torch.tensor([0.0 if v is None else v], dtype=torch.float64)
        if dist.get_backend(group) == "nccl":
            t = t.to(device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t) if float(t) > 0 else None

    return sample


def _child(rank: int, world: int, init: str, fn, args, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), **{ENV_INIT: init})
    torch.set_num_threads(1)      # many ranks share the machine's cores
    try:
        out = fn(*args)
        leave_group()
        results.put((rank, True, out))
    except BaseException:           # the parent raises with this text
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(world: int, fn, args: tuple = (), *, timeout_s: float = 300.0
          ) -> list:
    """Run fn(*args) in `world` new processes; returns their results in
    rank order.  Raises RuntimeError, after killing every child, when a
    child raises or dies or `timeout_s` passes."""
    check(world >= 1, "spawn: need at least one rank, got %d", world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="cfd-ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world, init, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        failure = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world and failure is None:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                    if ok:
                        got[rank] = out
                    else:
                        failure = f"rank {rank} raised:\n{out}"
                    continue
                except queue_mod.Empty:
                    pass
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode != 0
                        and r not in got]
                if dead and results.empty():
                    failure = (f"rank {dead[0]} died with exit code "
                               f"{procs[dead[0]].exitcode} and no message")
                elif time.monotonic() > deadline:
                    failure = (f"time limit of {timeout_s:.0f} s passed "
                               f"with ranks {sorted(set(range(world)) - set(got))} "
                               f"still running")
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"spawn of {world} ranks failed: {failure}")
    return [got[r] for r in range(world)]
