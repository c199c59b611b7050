"""Wall-clock timing and per-iteration statistics.

Analogue of the reference's `util.c` timer + the per-variant
min/median/max iteration-time table printed by the reference program
(SURVEY.md §2 L0, §5.1, §5.5).  On the device, timed regions are bracketed
with device synchronisations by the caller; this module only aggregates.

The port's copy of `cfd_proxy_tpu/utils/timing.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def two_point_sampler(run_small, run_big, iters: int, *,
                      noise_frac: float = 0.05):
    """The repo's canonical timing primitive: two-point chained-loop
    sampling (BASELINE.md).

    run_small / run_big are zero-arg callables that each execute a chained
    on-device loop to COMPLETION (the caller forces completion, e.g. with
    a device synchronise) of n0 and n0+iters iterations respectively.  The
    returned sample() times both and yields (t_big - t_small)/iters —
    per-iteration seconds with the per-run fixed cost cancelled — or None when the difference is below noise_frac of t_big
    (the dispatch-noise floor: the sample no longer measures the
    iteration).  Callers must compile/warm both runners BEFORE sampling.

    Used by solver.time_schedule, so the method is fixed in one place.
    """
    def sample():
        t0 = time.perf_counter()
        run_big()
        t_big = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_small()
        t_small = time.perf_counter() - t0
        diff = t_big - t_small
        if diff < noise_frac * t_big:
            return None
        return diff / iters

    return sample


class Timer:
    """Simple wall-clock stopwatch (monotonic, like the reference's now())."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


@dataclass
class IterationStats:
    """Collects per-iteration wall times for one benchmark variant."""

    name: str
    times: list[float] = field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.times.append(seconds)

    @property
    def n(self) -> int:
        return len(self.times)

    def _sorted(self) -> list[float]:
        # zero collected samples degrade to NaN stats (a readable "no
        # measurement" row) instead of IndexError/ZeroDivisionError from a
        # public-API caller that never hit solver.time_schedule's guard
        return sorted(self.times) or [float("nan")]

    @property
    def min(self) -> float:
        return self._sorted()[0]

    @property
    def max(self) -> float:
        return self._sorted()[-1]

    @property
    def median(self) -> float:
        s = self._sorted()
        m = len(s) // 2
        return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times \
            else float("nan")

    def summary(self) -> dict:
        # one shared sort instead of three property re-sorts
        s = self._sorted()
        m = len(s) // 2
        med = s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])
        return {
            "name": self.name,
            "iters": self.n,
            "min_s": s[0],
            "median_s": med,
            "mean_s": self.mean,
            "max_s": s[-1],
        }


def format_stats_table(stats: list[IterationStats], *, ref: str | None = None) -> str:
    """Pretty table of variant timings, with speedup vs a reference variant.

    Mirrors the reference program's stdout table (per comm-variant min/median/
    max and speedup vs bulk-sync; SURVEY.md §5.5).
    """
    lines = [
        f"{'variant':<28} {'iters':>5} {'min(ms)':>9} {'med(ms)':>9} {'max(ms)':>9} {'speedup':>8}"
    ]
    import math

    ref_med = None
    if ref is not None:
        for s in stats:
            if s.name == ref:
                ref_med = s.median
    # `is not None` + finite, NOT truthiness: a ref median of exactly 0.0
    # (or the NaN noise-floor sentinel) must print '-' rather than silently
    # dropping the column / printing nan speedups
    have_ref = (ref_med is not None and math.isfinite(ref_med)
                and ref_med > 0.0)
    for s in stats:
        ok = have_ref and math.isfinite(s.median) and s.median > 0.0
        sp = f"{ref_med / s.median:8.2f}" if ok else f"{'-':>8}"
        lines.append(
            f"{s.name:<28} {s.n:>5} {s.min * 1e3:>9.3f} {s.median * 1e3:>9.3f} "
            f"{s.max * 1e3:>9.3f} {sp}"
        )
    return "\n".join(lines)
