"""Per-layer metrics, one reader a file, found by the metric's name in
BENCHMARK.json (`cfdbench/metrics/<name>.py`).

A reader is `read(ranks, problem) -> float | None`: `ranks` holds each
rank's trace summary (`cfdbench/trace.py`), `problem` the global mesh's
`faces` and `points`, `nvar`, `chips` and the card's `kind`.  A reader that
finds nothing to read returns None, and the metric is left out of the line.
"""

SWEEP = "sweep_"            # the sweep kernels' names (K1, K2, K3 and forms)
UPDATE = "chain_update"     # the chained update's kernels


def per_step_us(summary: dict, keep) -> float:
    """Device us per step of the activities whose name `keep` accepts."""
    us = sum(t for n, (_, t) in summary["ops"].items() if keep(n))
    return us / summary["steps"]
