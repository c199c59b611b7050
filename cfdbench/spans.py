"""A cell's traced run with the port's span recorder on
(`cfd_proxy_tpu_torch/utils/spans.py`):

    python3 -m cfdbench.spans --workload <cell> --seed <n> --seconds <s>
        [--off]

It is `python3 -m cfdbench.run --trace 1`, through the harness's own
`cell.run_rank` and `run.assemble`, with these additions laid over it for
the run:

- the recorder is switched on before the model is built, so the captured
  graphs hold its events (`--off` leaves it off: the same run otherwise,
  which gives the recorder's cost);
- after each synchronise of the traced stretch, `spans.read()`, inside the
  host span `cfdbench.read_spans`;
- the stretch's summary gains "spans" (the recorder's totals over the
  stretch, taken when the harness takes its launch counts), "idle_by_host"
  (`cfdbench/idle.py`) and "intervals".

The result line is a traced run's, its metrics joined by the span metrics
(SPAN_METRICS, each read by `cfdbench/metrics/<name>.py`; a metric whose
spans or counters are missing is left out) and three objects: "spans"
(device ms per step of each span, the rank that spends most), "counters"
(per step) and "idle_by_host" (`idle.combine`: ms per report interval).
An information line holds the consistency check: the step's device spans
per step plus the runner's copies (the trace's Memcpy records) against
the trace's busy time per step.

These metrics are not the benchmark's yet: a `--trace 1` run reports them
once `cell.run_rank` makes these additions itself (PERF.md, Open
questions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from contextlib import contextmanager

from cfdbench import cell, idle, run, trace

SPAN_METRICS = ("exchange_glue_ms", "rebuild_ms", "halo_live_pct",
                "idle_in_runner_ms")
CONSISTENT = 0.03       # spans and copies against busy, per step


def recorder():
    """The port's span recorder module, or None where the port has none."""
    try:
        from cfd_proxy_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def span_ms(ranks: list, names) -> float | None:
    """Device ms per step in the port's spans `names` ("cfd.<name>"), the
    highest rank's; None where no rank recorded any of them."""
    got = []
    for r in ranks:
        sp = r.get("spans")
        if not sp or not sp["steps"]:
            continue
        hit = [sp["spans"][n][1] for n in names if n in sp["spans"]]
        if hit:
            got.append(sum(hit) / sp["steps"])
    return max(got) if got else None


def consistency(summary: dict) -> tuple[float, float] | None:
    """(device spans + copies, busy), us per step, of a rank's summary; None
    without device spans."""
    sp = summary.get("spans")
    if not sp or not sp["steps"]:
        return None
    spans_us = sum(ms for _, ms in sp["spans"].values()) * 1e3 / sp["steps"]
    copies_us = sum(us for n, (_, us) in summary["ops"].items()
                    if n.startswith("Memcpy")) / summary["steps"]
    return spans_us + copies_us, summary["busy_us"] / summary["steps"]


@contextmanager
def laid_over(spec: dict, on: bool):
    """The additions (module docstring) laid over the harness's module
    functions for the block: `cell._sync`, `cell._launch_counts` and
    `trace.from_profiler`, in this process (ranks spawned for a cell on
    several cards run without them, and their summaries hold no spans)."""
    k = int(spec["traffic"]["steps_per_interval"])
    from torch.profiler import record_function

    spans = recorder()
    snaps: list = []
    sync, counts, summarize = (cell._sync, cell._launch_counts,
                               trace.from_profiler)

    def read_sync(device):
        sync(device)
        if spans is not None and len(snaps) == 1:     # inside the stretch
            with record_function("cfdbench.read_spans"):
                spans.read()

    def counts_and_totals():
        if spans is not None:
            spans.read()
            snaps.append(spans.totals())
        return counts()

    def from_profiler(prof, steps):
        out = summarize(prof, steps)
        out["idle_by_host"] = idle.from_profiler(prof)
        out["intervals"] = steps // k
        if len(snaps) == 2:
            out["spans"] = spans.since(*snaps)
        return out

    if spans is not None:
        spans.reset()
        (spans.enable if on else spans.disable)()
    cell._sync, cell._launch_counts = read_sync, counts_and_totals
    trace.from_profiler = from_profiler
    try:
        yield
    finally:
        cell._sync, cell._launch_counts = sync, counts
        trace.from_profiler = summarize
        if spans is not None:
            spans.disable()


def report(c: dict, ranks: list, power) -> tuple[dict, list]:
    """The result line's object and the information lines before it."""
    out, info = run.assemble(c, ranks, True, power)
    sums = [r["trace"] for r in ranks if r.get("trace") is not None]
    if len(sums) < len(ranks):
        return out, info
    r0 = ranks[0]
    problem = {"faces": r0["faces"], "points": r0["points"],
               "nvar": r0["nvar"], "chips": len(ranks),
               "kind": r0["device_name"]}
    for name in SPAN_METRICS:
        value = cell.metric_reader(name)(sums, problem)
        if value is not None:
            out["metrics"][name] = {"value": value,
                                    "unit": "%" if name.endswith("_pct")
                                    else "ms"}
    per_step: dict = {}
    counters: dict = {}
    for s in sums:
        sp = s.get("spans")
        if not sp:
            continue
        for n, (_, ms) in sp["spans"].items():
            if sp["steps"]:
                per_step[n] = max(per_step.get(n, 0.0), ms / sp["steps"])
        for n, v in sp["counters"].items():
            if v:
                counters[n] = counters.get(n, 0) + v / s["steps"]
        check = consistency(s)
        if check is not None:
            got, busy = check
            info.append(f"spans: {sp['steps']} steps read; device spans "
                        f"and copies {got:.3f} us a step against busy "
                        f"{busy:.3f} us ({100 * (got / busy - 1):+.2f} %, "
                        f"within {100 * CONSISTENT:.0f} %: "
                        f"{abs(got / busy - 1) <= CONSISTENT})")
    out["spans"] = dict(sorted(per_step.items(), key=lambda kv: -kv[1]))
    out["counters"] = counters
    if all("idle_by_host" in s for s in sums):
        out["idle_by_host"] = idle.combine(sums)
    return out, info


def main(argv=None) -> int:
    t0 = run.process_start()
    ap = argparse.ArgumentParser(prog="python3 -m cfdbench.spans",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--off", action="store_true",
                    help="leave the recorder off (the recorder's cost)")
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
    with laid_over(spec, not args.off):
        ranks = run.run_spec(spec, t0)
    out, info = report(c, ranks, run.power_limits(c["chips"]))
    for line in info:
        cell.log(line)
    out["recorder"] = "off" if args.off else "on"
    out["seed"] = args.seed
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
