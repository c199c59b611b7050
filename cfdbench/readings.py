"""Readings for the comparison's limits, at a cell's own size, on the chip:

    python3 -m cfdbench.readings --workload <cell> --seeds 1,2,3 [--control]

Each seed runs the cell as `cfdbench.run` does (set-up, a short window of
`--seconds` at the cell's own load, the comparison) and prints one JSON line
of the numbers compared.  --control switches on the program's own
reduced-precision path, the gradients stored in bfloat16
(`grad_dtype="bfloat16"`): the nearest precision below the configurations'
float32, whose readings have to fail the limits.  Every seed of a call runs
in one process a rank, so the kernels load once.  The benchmark's runs never
run this; PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

CONTROL = {"grad_dtype": "bfloat16"}


def seeds_rank(spec: dict, seeds: list) -> list:
    """run_rank for every seed in turn; the numbers of each (rank 0)."""
    from cfdbench import cell

    out = []
    for s in seeds:
        res = cell.run_rank(dict(spec, seed=s, t0=time.time()))
        if "ranks" in res:
            out.append({"seed": s, "checks": res["ranks"][0]["checks"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cfdbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from cfdbench import cell

    c = cell.find_cell(args.workload)
    spec = {"config": c["config"], "traffic": c["traffic"],
            "seconds": args.seconds, "trace": False, "device": "cuda",
            "overrides": CONTROL if args.control else {}}
    seeds = [int(s) for s in args.seeds.split(",")]
    if c["traffic"]["ranks"] == 1:
        rows = seeds_rank(spec, seeds)
    else:
        from cfd_proxy_tpu_torch.parallel import launch

        rows = launch.spawn(c["traffic"]["ranks"], seeds_rank,
                            (spec, seeds), timeout_s=3000)[0]
    for r in rows:
        print(json.dumps({"workload": args.workload,
                          "control": bool(args.control), **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
