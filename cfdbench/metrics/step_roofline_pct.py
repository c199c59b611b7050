"""step_roofline_pct (device): the least time of one chip's share of the
problem's bytes (`cfdbench/roofline.py`) ÷ the traced stretch's wall time
per step, in %: the whole step's share of the chip's bandwidth bound, which
bounds `sweep_roofline_pct` from below whatever kernels the step runs."""

from cfdbench.roofline import least_seconds


def read(ranks, problem):
    if not any(r["busy_us"] for r in ranks):
        return None
    us = max(r["stretch_us"] / r["steps"] for r in ranks)
    return 100.0 * least_seconds(problem) / (us * 1e-6)
