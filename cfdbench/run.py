"""The benchmark of the PyTorch and CUDA port (`cfd_proxy_tpu_torch`):

    python3 -m cfdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One cell of BENCHMARK.json a run: the inputs
from the seed, the program's set-up, a window of report intervals for about
`--seconds`, then the comparison with the plain reference (cfdbench/cell.py).
Information goes to standard error; the last line of standard output is the
result, one JSON object:

    correct, attempted, failed   the comparison's verdict; steps dispatched
                                 in the window, and those of intervals that
                                 raised
    metrics                      --trace 0: the cell's end-to-end metrics;
                                 --trace 1: its per-layer metrics
    device                       platform, kind, count, memory_peak_bytes,
                                 power_limit_w; traced: busy_s, window_s
    breakdown                    traced only: device_ops, idle_gaps
    checks                       each number compared beside its limit

The end-to-end metrics, from the host's clock:

    faces_per_s      the global mesh's faces × steps completed in the window ÷
                     the window's seconds (on several ranks the slowest rank's)
    interval_ms_p95  the 95th percentile of every report interval's time (k
                     chained steps and a synchronise; on several ranks each
                     interval's slowest)
    setup_s          from the start of the process to the first timed interval

A cell on several chips starts one process a card (`cfd_proxy_tpu_torch.
parallel.launch.spawn`, its rendezvous under TMPDIR) and waits for them.
The run exits with a code other than 0 and prints no result without enough
CUDA cards, or when a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "cfdbench", ".cache")


def process_start() -> float:
    """The wall-clock time this process started (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def power_limits(n: int) -> float | None:
    """The lowest power limit (W) of the first n cards, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return min(float(x) for x in out[:n])
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def percentile(values: list, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(ranks: list) -> dict:
    """faces_per_s, interval_ms_p95 and setup_s from the ranks' raw
    readings, each on the slowest rank."""
    n = min(len(r["intervals_s"]) for r in ranks)
    iv = [max(r["intervals_s"][i] for r in ranks) * 1e3 for i in range(n)]
    steps = min(r["steps"] for r in ranks)
    window = max(r["window_s"] for r in ranks)
    return {"faces_per_s": ranks[0]["faces"] * steps / window,
            "interval_ms_p95": percentile(iv, 95) if iv else math.inf,
            "setup_s": max(r["setup_s"] for r in ranks),
            "_median_ms": percentile(iv, 50) if iv else math.inf,
            "_intervals": n}


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def assemble(cell: dict, ranks: list, traced: bool,
             power: float | None) -> tuple[dict, list]:
    """The result line's object and the information lines before it."""
    from cfdbench import cell as cellmod
    from cfdbench import roofline, trace

    r0 = ranks[0]
    info = [f"cell {cell['name']}: {r0['faces']} faces, {r0['points']} "
            f"points, nvar {r0['nvar']}, {len(ranks)} rank(s)",
            f"dispatch {r0['dispatch'][0]} ({r0['dispatch'][1]})",
            f"roofline bytes {roofline.problem_bytes(r0['faces'], r0['points'], r0['nvar'])}"
            f" ({len(ranks)} chip(s); {roofline.least_seconds(dict(faces=r0['faces'], points=r0['points'], nvar=r0['nvar'], chips=len(ranks), kind=r0['device_name'])) * 1e3:.6f} ms a step at the bound)"]
    e2e = end_to_end(ranks)
    info.append(f"window: {e2e['_intervals']} intervals of "
                f"{cell['traffic']['steps_per_interval']} steps, "
                f"{max(r['window_s'] for r in ranks):.6f} s, interval "
                f"median {e2e['_median_ms']:.6f} ms, p95 "
                f"{e2e['interval_ms_p95']:.6f} ms (probe "
                f"{r0['interval_probe_s'] * 1e3:.6f} ms)")
    info.append("setup_s by rank: " + ", ".join(
        f"{r['setup_s']:.3f}" for r in ranks))
    info.append(f"set-up stages (s), rank 0: {json.dumps(r0['setup_stages'])}")
    problem = {"faces": r0["faces"], "points": r0["points"],
               "nvar": r0["nvar"], "chips": len(ranks),
               "kind": r0["device_name"]}
    device = {"platform": "gpu" if r0["device_name"] != "cpu" else "cpu",
              "kind": r0["device_name"], "count": len(ranks),
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in ranks),
              "power_limit_w": power}
    metrics, breakdown = {}, None
    if traced:
        sums = [r["trace"] for r in ranks]
        if all(s is not None for s in sums):
            for s, r in zip(sums, ranks):
                sweeps = sum(c for n, (c, _) in s["ops"].items()
                             if "sweep_" in n)
                info.append(
                    f"trace rank {r['rank']}: {s['steps']} steps, "
                    f"{sum(c for c, _ in s['ops'].values())} device records, "
                    f"{sweeps} sweep records against {s['counted']['sweep']} "
                    f"sweep launches the program counted")
                if sweeps < s["counted"]["sweep"]:
                    info.append(f"trace rank {r['rank']}: CUPTI dropped "
                                f"{s['counted']['sweep'] - sweeps} sweep "
                                "records; the sweep's device time reads low")
            for name in cell["per_layer"]:
                value = cellmod.metric_reader(name)(sums, problem)
                if value is not None:
                    metrics[name] = value
            device["busy_s"] = sum(s["busy_us"] for s in sums) / len(sums) \
                * 1e-6
            device["window_s"] = max(s["stretch_us"] for s in sums) * 1e-6
            breakdown = trace.combine(sums)
        else:
            info.append("trace: the window ended before its traced stretch")
    else:
        metrics = {k: e2e[k] for k in cell["end_to_end"]}
    units = cell["units"]
    checks = r0["checks"]
    failed = max(r["failed"] for r in ranks)
    correct = failed == 0 and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": r0["attempted"],
           "failed": failed,
           "metrics": {k: {"value": finite(v), "unit": units[k]}
                       for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    return out, info


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m cfdbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    # the program's build and kernel caches stay inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    import torch

    from cfdbench import cell as cellmod

    cell = cellmod.find_cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        cellmod.log(f"{args.workload} needs {chips} CUDA card(s); this "
                    f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    spec = {"config": cell["config"], "traffic": cell["traffic"],
            "seed": args.seed, "seconds": args.seconds,
            "trace": bool(args.trace), "device": "cuda", "t0": t0}
    res = run_spec(spec, t0)
    foreign = sorted(set(cellmod.foreign_modules()).union(
        *(r["foreign_modules"] for r in res)))
    if foreign:
        cellmod.log(f"modules of JAX or of the JAX package were loaded: "
                    f"{', '.join(foreign)}; no result")
        return 3
    out, info = assemble(cell, res, bool(args.trace), power_limits(chips))
    for line in info:
        cellmod.log(line)
    for name, c in out["checks"].items():
        cellmod.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


def run_spec(spec: dict, t0: float) -> list:
    """The ranks' raw readings: in this process at one rank, else from one
    spawned process a rank (the program's launcher), after the kernels are
    built here, where building touches no card."""
    from cfdbench import cell as cellmod

    ranks = spec["traffic"]["ranks"]
    if ranks == 1:
        return cellmod.run_rank(spec)["ranks"]
    from cfd_proxy_tpu_torch.parallel import launch

    if spec["device"] == "cuda":
        from cfd_proxy_tpu_torch.ops import _cuda

        built = _cuda.build()["built"]
    else:
        built = False
    limit = (1150.0 if built else 340.0) - (time.time() - t0)
    return launch.spawn(ranks, cellmod.run_rank, (spec,),
                        timeout_s=limit)[0]["ranks"]


if __name__ == "__main__":
    sys.exit(main())
