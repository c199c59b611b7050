"""sweep_roofline_pct (kernels: `ops/blocksweep.py` → `csrc/sweep_*.cu`):
the least time of one chip's share of the problem's bytes
(`cfdbench/roofline.py`) ÷ the device time per step of the kernels whose
name holds `sweep_`, on the slowest chip, in %."""

from cfdbench.metrics import SWEEP, per_step_us
from cfdbench.roofline import least_seconds


def read(ranks, problem):
    us = max(per_step_us(r, lambda n: SWEEP in n) for r in ranks)
    return 100.0 * least_seconds(problem) / (us * 1e-6) if us > 0 else None
