"""A cell's traced run with the port's span recorder on inside every rank:

    python3 -m cfdbench.spans_ranks --workload <cell> --seed <n>
        --seconds <s>

`python3 -m cfdbench.spans` lays its additions over the process it runs
in, so the ranks that a cell on several cards spawns run without them and
their summaries hold no spans and no counters.  Here each spawned rank
enters `cfdbench.spans.laid_over` itself (`rank`), so every rank's summary
holds its spans and the port's counters, the peer transport's wait
counters among them.  The result line is `cfdbench.spans`'s, its metrics
joined by `peer_wait_pct` (`cfdbench/metrics/peer_wait_pct.py`), and
"waits": each rank's wait counters a step.  A cell of one rank runs in
this process, as under `cfdbench.spans`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from cfdbench import cell, run, spans

WAIT_METRIC = "peer_wait_pct"
# the port's wait counters (cfd_proxy_tpu_torch/parallel/transport.py)
WAITS = ("peer_wait_barrier_ns", "peer_waits_barrier", "peer_wait_arrive_ns",
         "peer_waits_arrive")


def rank(spec: dict) -> dict:
    """One rank's run with the additions laid over it in its own process."""
    with spans.laid_over(spec, True):
        return cell.run_rank(spec)


def run_ranks(spec: dict, t0: float) -> list:
    """The ranks' raw readings, as `run.run_spec` takes them."""
    n = spec["traffic"]["ranks"]
    if n == 1:
        return rank(spec)["ranks"]
    from cfd_proxy_tpu_torch.parallel import launch

    built = False
    if spec["device"] == "cuda":
        from cfd_proxy_tpu_torch.ops import _cuda

        built = _cuda.build()["built"]
    limit = (1150.0 if built else 340.0) - (time.time() - t0)
    return launch.spawn(n, rank, (spec,), timeout_s=limit)[0]["ranks"]


def report(c: dict, ranks: list, power) -> tuple[dict, list]:
    """`cfdbench.spans.report`'s line with `peer_wait_pct` and each rank's
    wait counters a step."""
    out, info = spans.report(c, ranks, power)
    sums = [r["trace"] for r in ranks if r.get("trace") is not None]
    if len(sums) < len(ranks):
        return out, info
    r0 = ranks[0]
    problem = {"faces": r0["faces"], "points": r0["points"],
               "nvar": r0["nvar"], "chips": len(ranks),
               "kind": r0["device_name"]}
    value = cell.metric_reader(WAIT_METRIC)(sums, problem)
    if value is not None:
        out["metrics"][WAIT_METRIC] = {"value": value, "unit": "%"}
    out["waits"] = [{k: s["spans"]["counters"].get(k, 0) / s["steps"]
                     for k in WAITS} for s in sums if s.get("spans")]
    return out, info


def main(argv=None) -> int:
    t0 = run.process_start()
    ap = argparse.ArgumentParser(prog="python3 -m cfdbench.spans_ranks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    os.environ["TRITON_CACHE_DIR"] = os.path.join(run.CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(run.CACHE,
                                                      "torch_extensions")
    c = cell.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c["chips"]:
        cell.log(f"{args.workload} needs {c['chips']} CUDA card(s)")
        return 2
    spec = {"config": c["config"], "traffic": c["traffic"],
            "seed": args.seed, "seconds": args.seconds, "trace": True,
            "device": "cuda", "t0": t0}
    ranks = run_ranks(spec, t0)
    out, info = report(c, ranks, run.power_limits(c["chips"]))
    for line in info:
        cell.log(line)
    out["seed"] = args.seed
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
