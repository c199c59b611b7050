"""Push bench — MEASURES what the fused overlap kernel's push machinery
costs by itself, per payload size and per part of the protocol.

Counterpart of `cfd_proxy_tpu/tools/icibench.py`.  One launch of K6
(`ops/push.py::push_phases`, csrc/push_bench.cu) fires N push phases of a
(rows, S) float32 buffer through the device code the fused kernel's peer
form runs (csrc/push_common.cuh): readiness barrier, peer stores, arrival
flags and the final wait.  The loop is the reference's chained one (each
iteration's state depends on what the push received), timed with the
two-point sampler, every loop ended by a device synchronise; five samples,
the median reported, as GB/s of payload and of memory traffic (read +
write).  On the card the loop replays one chained step captured as CUDA
graphs (`models/compiled.py`, the body "push": it holds no collective, so
at any rank count), as the reference jits its `fori_loop`; each row ends
with the dispatch its loop took.

    python -m cfd_proxy_tpu_torch.tools.icibench --phases 1 2 4 \\
        --mb 0.125 1 8 32
    python -m cfd_proxy_tpu_torch.tools.icibench --ranks 2 --share-device \\
        --dist-backend gloo --mb 1

`--mode` decomposes the small-payload fixed cost: full = barrier + stores +
arrival wait (production); nobar = stores and arrival wait without the
readiness barrier; baronly = the barrier alone; empty = neither (the bare
launch).  baronly and empty still copy phase 0 locally, as the reference's
do, so the chained loop depends on the kernel.  Differences between modes
at one payload size attribute the fixed cost.

At `--ranks 1` every push is a SELF-send on the card: a device-to-device
copy through the push code, an upper bound for any rate between two cards
and a calibration of the per-phase overhead.  At `--ranks W` rank r pushes
to rank r+1 (mapped memory); every sample is the slowest rank's.  Ranks
that share one card (`--share-device`) time-slice it: such a run checks
the mechanism and its times mean nothing.

`--link-gbps` has no default: no link rate is assumed.  Given one, the
last line suggests min(measured, link) for a scaling model; without it the
line is not printed.  `--device cpu` runs the plain version (a copy per
phase through the loopback or dist transport) and measures nothing real.
"""

from __future__ import annotations

import argparse
import collections
import types

import numpy as np
import torch

from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.ops.push import MODES, push_phases
from cfd_proxy_tpu_torch.parallel import launch
from cfd_proxy_tpu_torch.parallel.transport import (DIST_BACKENDS, Dist,
                                                    Loopback, Peer)
from cfd_proxy_tpu_torch.utils.errors import check
from cfd_proxy_tpu_torch.utils.timing import two_point_sampler

SAMPLES = 5
RANKS_TIMEOUT_S = 900.0


def payload_lanes(mb: float, rows: int) -> int:
    """Lanes S of a (rows, S) f32 buffer of about `mb` megabytes, a
    multiple of 128 (the reference's rule)."""
    return max(128, int(round(mb * 1e6 / (rows * 4) / 128)) * 128)


def ring_map(world: int, nph: int) -> tuple[np.ndarray, np.ndarray]:
    """(dsts, srcs) of the bench: one shard per rank, rank r pushes every
    phase to rank r+1 (itself at one rank)."""
    r = np.arange(world, dtype=np.int32)[:, None]
    ones = np.ones((1, nph), np.int32)
    return ((r + 1) % world) * ones, ((r - 1) % world) * ones


def make_transport(world: int, nph: int, rows: int, lanes: int, device,
                   group):
    """The bench's transport: `Peer` on CUDA; on the CPU the plain
    version's `Loopback` or `Dist`."""
    dsts, srcs = ring_map(world, nph)
    if torch.device(device).type == "cuda":
        return Peer(dsts, srcs, rows=rows, s_max=lanes, dtype=torch.float32,
                    device=device, group=group)
    if world == 1:
        return Loopback(dsts, device)
    perms = [[(r, (r + 1) % world) for r in range(world)]] * nph
    return Dist(perms, world, group, device)


def chain_host(transport, device) -> types.SimpleNamespace:
    """What `compiled.runner` reads of a model, for the push chain: the
    device, the transport's kind and rank count, and a graph cache (free it
    with `.graphs.clear()` before the transport closes)."""
    kind = {"peer": "peer", "loopback": "loopback"}.get(
        getattr(transport, "name", ""), "dist")
    return types.SimpleNamespace(
        device=torch.device(device), transport_kind=kind,
        world=getattr(transport, "world", 1),
        graphs=collections.OrderedDict())


def chained_runner(send: torch.Tensor, transport, mode: str, host=None,
                   graph: bool | None = None,
                   coupling: float = compiled.COUPLING):
    """run(n) → v: n chained pushes, v ← v + coupling·recv (the reference's
    1e-30 by default, which leaves an f32 state as it was: a check that
    must see the pushes takes a larger one), then a device synchronise
    (the reference's loop, icibench.py:146-152), through `compiled.runner`
    for the body "push" on `host` (`chain_host`): on the card the step
    captured as CUDA graphs and replayed, on the CPU eager.  run.dispatch:
    the (kind, reason) its loops take; graph: as in `compiled.use_graph`."""
    host = host or chain_host(transport, send.device)

    def body(v, out=None):
        return torch.add(v, coupling * push_phases(v, transport, mode),
                         out=out)

    def run(n: int) -> torch.Tensor:
        v = compiled.runner(host, body, n, ("push", mode, coupling),
                            graph=graph, schedule="push")(send)
        if v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
        return v

    run.dispatch = ((compiled.EAGER, "graph=False") if graph is False else
                    compiled.dispatch(host, "push"))
    return run


def bench_rank(args: argparse.Namespace) -> list:
    """One rank's bench: [(phases, MB per phase, seconds per iteration or
    None, dispatch)] per (phases, payload); a multi-rank run joins its
    group first and reports the slowest rank's samples."""
    group, world, device = None, 1, args.device
    if args.ranks > 1:
        group, _, world, device = launch.join_rank(
            args.device, args.dist_backend, args.share_device)
    elif args.device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    rows_out = []
    n0 = max(1, args.iters // 10)
    for nph in args.phases:
        for mb in args.mb:
            lanes = payload_lanes(mb, args.rows)
            transport = make_transport(world, nph, args.rows, lanes, device,
                                       group)
            send = torch.ones((1, nph, args.rows, lanes),
                              dtype=torch.float32, device=device)
            host = chain_host(transport, device)
            run = chained_runner(send, transport, args.mode, host)
            run(n0)
            run(n0 + args.iters)                    # warm both lengths
            small, big = (lambda: run(n0)), (lambda: run(n0 + args.iters))
            if world == 1:
                sample = two_point_sampler(small, big, args.iters)
            else:
                sample = launch.slowest_rank_sampler(group, device, small,
                                                     big, args.iters)
            vals = [v for v in (sample() for _ in range(SAMPLES))
                    if v is not None]
            rows_out.append((nph, args.rows * lanes * 4 / 1e6,
                             float(np.median(vals)) if vals else None,
                             run.dispatch[0]))
            host.graphs.clear()         # before the memory they read goes
            if hasattr(transport, "close"):
                transport.close()
    return rows_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.icibench")
    ap.add_argument("--phases", type=int, nargs="+", default=[1, 2, 4],
                    help="push phases fired per kernel (self-sends at one "
                         "rank)")
    ap.add_argument("--mb", type=float, nargs="+",
                    default=[0.125, 1.0, 8.0, 32.0],
                    help="payload megabytes PER PHASE")
    ap.add_argument("--rows", type=int, default=24,
                    help="buffer rows (24 = gg gradient payload)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="a link's rate, for the suggestion line (no "
                         "default: none is assumed)")
    ap.add_argument("--mode", default="full", choices=list(MODES),
                    help="fixed-cost decomposition: full = barrier + "
                         "stores + arrival wait; nobar = without the "
                         "barrier; baronly = the barrier alone; empty = "
                         "neither")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes; rank r pushes to rank r+1")
    ap.add_argument("--dist-backend", default=None,
                    choices=list(DIST_BACKENDS),
                    help="the group's backend (default: nccl on cuda, gloo "
                         "on cpu)")
    ap.add_argument("--share-device", action="store_true",
                    help="allow more ranks than cards (a check, not a "
                         "timing)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    check(args.ranks >= 1 and min(args.phases) >= 1 and args.rows >= 1
          and args.iters >= 1, "--ranks, --phases, --rows and --iters must "
          "be positive")
    check(args.device != "cuda" or torch.cuda.is_available(),
          "--device cuda but torch sees no CUDA device (--device cpu runs "
          "the plain version)")
    check(args.device != "cuda" or args.share_device
          or args.ranks <= torch.cuda.device_count(), "--ranks %d exceeds "
          "the %d CUDA devices (--share-device puts several ranks on one)",
          args.ranks, torch.cuda.device_count())
    check((args.rows * 4 * 128) % 16 == 0, "--rows %d", args.rows)
    env = launch.world_from_env()
    check(env is None or env[1] == args.ranks, "--ranks %d, but the "
          "launcher started %s processes", args.ranks, env and env[1])
    if args.ranks == 1 or env is not None:
        table = bench_rank(args)
        if env is not None and env[0] != 0:
            return 0
    else:
        table = launch.spawn(args.ranks, bench_rank, (args,),
                             timeout_s=RANKS_TIMEOUT_S)[0]

    mode = args.mode
    if args.device == "cpu":
        print("# WARNING: no GPU — the plain version measures nothing real")
    if args.ranks > 1 and args.share_device:
        print("# ranks share one GPU, time-sliced: a check of the "
              "mechanism, not a timing")
    print(f"# mode={mode} (barrier={'on' if mode in ('full', 'baronly') else 'off'}, "
          f"copy={'on' if mode in ('full', 'nobar') else 'off'}) "
          f"ranks={args.ranks}")
    print(f"{'phases':>6} {'MB/phase':>9} {'ms/iter':>9} {'GB/s payload':>13} "
          f"{'GB/s HBM r+w':>13}")
    best_gbps = 0.0
    for nph, mb, t, how in table:
        if t is None:
            print(f"{nph:>6} {mb:>9.3f}   below dispatch-noise floor  "
                  f"dispatch={how}")
            continue
        gbps = nph * mb * 1e6 / t / 1e9
        best_gbps = max(best_gbps, gbps)
        print(f"{nph:>6} {mb:>9.3f} {t * 1e3:>9.3f} {gbps:>13.1f} "
              f"{2 * gbps:>13.1f}  dispatch={how}")
    if best_gbps and args.link_gbps is not None:
        sug = min(best_gbps, args.link_gbps)
        print(f"# peak payload rate {best_gbps:.1f} GB/s; suggested "
              f"scaling-model link rate {sug:.1f} GB/s "
              f"(= min(measured, {args.link_gbps} GB/s link))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
