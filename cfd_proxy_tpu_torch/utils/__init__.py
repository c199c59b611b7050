"""L0 substrate: error checking + timing/statistics.

Reference equivalents: `error_handling.h` (SUCCESS_OR_DIE/ASSERT macros) and
`util.c/h` (wall-clock timer, per-iteration min/median/max stats) — see
SURVEY.md §2 L0 and §5.1.

The port's copy of `cfd_proxy_tpu/utils/__init__.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from cfd_proxy_tpu_torch.utils.errors import CheckError, check, check_index_array
from cfd_proxy_tpu_torch.utils.timing import IterationStats, Timer, format_stats_table


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x."""
    return ((x + m - 1) // m) * m


__all__ = [
    "CheckError",
    "check",
    "check_index_array",
    "Timer",
    "IterationStats",
    "format_stats_table",
    "round_up",
]
