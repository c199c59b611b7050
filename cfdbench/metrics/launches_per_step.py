"""launches_per_step (dispatch: `models/compiled.py`): kernel records of the
traced stretch ÷ its steps, on the rank that launches most.  Copies and
fills are not kernels and are not counted."""

from cfdbench.trace import is_kernel


def read(ranks, problem):
    counts = [sum(c for n, (c, _) in r["ops"].items() if is_kernel(n))
              / r["steps"] for r in ranks]
    return max(counts) if any(counts) else None
