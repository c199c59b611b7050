"""Measure the scaling model's inputs on a card, through the solver CLI.

    python -m cfd_proxy_tpu_torch.tools.scaling_inputs rates
    python -m cfd_proxy_tpu_torch.tools.scaling_inputs chain

`rates`: for each --nx, the P=1 `bulk` step of

    python -m cfd_proxy_tpu_torch.solver --nx N --ny N --nz N --parts 1 \\
        --schedule bulk [--src-dtype bfloat16 --meta-dtype bfloat16]

(the second form for the `reduced` table), run in this process; prints
each command, its step median, ns per face, peak device memory, the
run's wall time (host set-up included) and the process's peak host
memory, then the rows of `scaling_model.RATE_TABLES`.

`chain`: the exchange chain of a P=8-shaped shard on one card, the
reference's fake-phase rungs: for each --sends S,

    python -m cfd_proxy_tpu_torch.solver --nx 48 --ny 48 --nz 48 \\
        --parts 1 --min-phases 6 --fake-sends S --schedule all

gives bulk - nocomm and overlap - nocomm per step, and the same model's
pack and unpack (`GreenGaussTorch._pack`, `_unpack`) are timed on the
device alone (`utils.devtime.held_device_ms`), as is Loopback's copy.  A
least-squares line of the pack's device time over the gathered columns
(nphases x s_max) gives `--pack-ns-per-col`; `--bulk-fixed-us` and
`--overlap-fixed-us` are the medians of bulk - nocomm and overlap - nocomm
less that pack term.  The step is launch-bound at this size, so the step
time's own slope over the columns drowns in the host's noise (it is
printed beside); Loopback's device copy stands in for the wire the model
charges apart, and only its launch stays in the bases.

The solver's timed loops take its dispatch rule (`models/compiled.py`):
on the card each replays the step's CUDA graphs, so the rates and
the chain are those of graph dispatch (the host's launches out of the
step), as the bench's rows are.  Every line names the device the solver
ran on; `--device cpu` runs the
kernels' plain versions (the mechanics, not a card's numbers).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import resource

import time

import numpy as np
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.solver import main as solver_main
from cfd_proxy_tpu_torch.utils.devtime import held_device_ms

REDUCED = ["--src-dtype", "bfloat16", "--meta-dtype", "bfloat16"]
CHAIN_PHASES = 6    # the P=8 partition of the 96³ mesh has 6 phases
# chained steps per two-point sample: about 0.2 s of loop at the launch
# floor (~20 µs a step) or at the sweep's rate, whichever is longer
LOOP_FACES = 2e8


def solve(argv: list[str]) -> dict:
    """One solver run in this process; its JSON report."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = solver_main([*argv, "--json"])
    if rc != 0:
        raise SystemExit(f"solver {' '.join(argv)}: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def command(argv: list[str]) -> str:
    return "python -m cfd_proxy_tpu_torch.solver " + " ".join(argv)


def mesh_args(nx: int) -> list[str]:
    return ["--nx", str(nx), "--ny", str(nx), "--nz", str(nx), "--parts", "1"]


def peak_gb(device: str) -> float | None:
    if device != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 1e9


def host_peak_gb() -> float:
    """This process's peak resident memory so far (Linux: KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def rate_point(nx: int, rate: str = "f32", device: str = "cuda",
               iters: int = 0, verify: bool = False) -> dict:
    """The P=1 bulk step at nx³: the solver's report plus `argv`,
    `step_ms` and `ns_per_face`.  iters 0: ~LOOP_FACES faces a loop."""
    nface_est = 3.16 * nx ** 3          # generate_mesh at diag_frac 0.2
    iters = iters or int(min(5000, max(100, LOOP_FACES / nface_est)))
    argv = [*mesh_args(nx), "--schedule", "bulk", "--iters", str(iters),
            "--device", device, *(REDUCED if rate == "reduced" else []),
            *([] if verify else ["--no-verify"])]
    res = solve(argv)
    ms = res["schedules"]["bulk"]["median_s"] * 1e3
    return {**res, "argv": argv, "step_ms": ms,
            "ns_per_face": ms * 1e6 / res["nface"]}


def chain_point(nx: int, phases: int, sends: int, iters: int,
                device: str = "cuda", verify: bool = False) -> dict:
    """The P=1 fake-phase chain: the solver's report plus `argv`, the
    gathered columns `cols` (nphases x s_max) and bulk - nocomm and
    overlap - nocomm in µs."""
    argv = [*mesh_args(nx), "--min-phases", str(phases), "--fake-sends",
            str(sends), "--schedule", "all", "--iters", str(iters),
            "--device", device, *([] if verify else ["--no-verify"])]
    res = solve(argv)
    nocomm = res["nocomm_median_s"]
    return {**res, "argv": argv, "cols": res["nphases"] * res["s_max"],
            "bulk_us": (res["schedules"]["bulk"]["median_s"] - nocomm) * 1e6,
            "overlap_us":
                (res["schedules"]["overlap"]["median_s"] - nocomm) * 1e6}


def device_us(fn, device: str, n: int = 50) -> float:
    """Mean µs per call: on the card its device time alone; on the CPU the
    host's wall time."""
    if device == "cuda":
        return held_device_ms(fn, n) * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def pack_device_us(nx: int, phases: int, sends: int,
                   device: str = "cuda") -> dict:
    """The fake-phase model's pack + unpack of the gradient rows (24, f32)
    and Loopback's copy of their send buffers, µs per call each."""
    mesh = generate_mesh(nx, nx, nx, jitter=0.05, diag_frac=0.2, seed=0)
    model = GreenGaussTorch(partition_mesh(mesh, 1), 7, min_phases=phases,
                            fake_sends=sends, device=device)
    g = torch.zeros((1, model.rows, model.ndev), device=device)
    buf = model._pack(g, model.send_mask, model.halo_t)
    return {"cols": model.nphases * model.s_max,
            "pack_us": device_us(lambda: model._unpack(
                g, model._pack(g, model.send_mask, model.halo_t)), device),
            "copy_us": device_us(lambda: model.transport.exchange(buf),
                                 device)}


def rates(args) -> int:
    rows: dict[str, list] = {r: [] for r in args.rate}
    for nx in args.nx:
        for r in args.rate:
            if args.device == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            res = rate_point(nx, r, args.device, args.iters)
            rows[r].append((res["nface"], res["ns_per_face"], nx,
                            res["step_ms"]))
            print(f"{command(res['argv'])}\n  device={res['device']} "
                  f"rate={r} nface={res['nface']} bp={res['bp']} "
                  f"step_ms={res['step_ms']:.5f} "
                  f"ns_per_face={res['ns_per_face']:.5f} "
                  f"peak_gb={peak_gb(args.device)} "
                  f"wall_s={res['wall_s']:.1f} "
                  f"host_peak_gb={host_peak_gb():.2f}", flush=True)
    for r, rr in rows.items():
        print(f'"{r}": [')
        for nface, nspf, nx, ms in rr:
            print(f"    ({nface:_}, {nspf:.4f}),  # nx={nx}, {ms:.5f} ms")
        print("],")
    return 0


def chain(args) -> int:
    pts = []        # (cols, bulk - nocomm, overlap - nocomm, pack, copy) µs
    for rep in range(args.repeats):
        for s in args.sends:
            res = chain_point(args.nx, CHAIN_PHASES, s, args.iters,
                              args.device)
            dev = pack_device_us(args.nx, CHAIN_PHASES, s, args.device)
            pts.append((res["cols"], res["bulk_us"], res["overlap_us"],
                        dev["pack_us"], dev["copy_us"]))
            print(f"{command(res['argv'])}\n  device={res['device']} "
                  f"repeat={rep} cols={res['cols']} "
                  f"nocomm_us={res['nocomm_median_s'] * 1e6:.3f} "
                  f"bulk-nocomm_us={res['bulk_us']:.3f} "
                  f"overlap-nocomm_us={res['overlap_us']:.3f} "
                  f"pack+unpack_us={dev['pack_us']:.3f} "
                  f"loopback_copy_us={dev['copy_us']:.3f}",
                  flush=True)
    cols, bulk, over, pack, copy = (np.array(c, float) for c in zip(*pts))
    slope_us, pack_base_us = np.polyfit(cols, pack, 1)
    step_slope_us = np.polyfit(cols, bulk, 1)[0]
    print(f"BULK_FIXED_US = {np.median(bulk - slope_us * cols):.3f}\n"
          f"PACK_NS_PER_COL = {slope_us * 1e3:.5f}\n"
          f"OVERLAP_FIXED_US = {np.median(over - slope_us * cols):.3f}\n"
          f"  (n={len(pts)} points, device={res['device']}; pack+unpack "
          f"device intercept {pack_base_us:.3f} us; Loopback copy "
          f"{np.median(copy):.3f} us median; bulk - nocomm's own slope "
          f"{step_slope_us * 1e3:.5f} ns/col)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.scaling_inputs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("rates", help="the sweep-rate tables")
    r.add_argument("--nx", type=int, nargs="+",
                   default=[24, 32, 50, 96, 160, 224])
    r.add_argument("--rate", nargs="+", default=["f32", "reduced"],
                   choices=["f32", "reduced"])
    r.add_argument("--iters", type=int, default=0,
                   help="chained steps per sample (default: by size)")
    c = sub.add_parser("chain", help="the exchange chain's parameters")
    c.add_argument("--nx", type=int, default=48)
    c.add_argument("--sends", type=int, nargs="+", default=[1024, 2432, 4096])
    c.add_argument("--iters", type=int, default=2000)
    c.add_argument("--repeats", type=int, default=3,
                   help="passes over --sends, in turns")
    for p in (r, c):
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return rates(args) if args.cmd == "rates" else chain(args)


if __name__ == "__main__":
    raise SystemExit(main())
