"""Error-checking helpers.

TPU-native analogue of the reference's `error_handling.h` check macros
(`ASSERT` / `SUCCESS_OR_DIE`-style wrappers around MPI/GASPI/netCDF return
codes; SURVEY.md §3 row 1).  Here errors surface as Python exceptions with
contextual messages; array-shaped invariants get dedicated validators because
index arrays (sendidx/recvidx/faces) are the correctness-critical metadata.

The port's copy of `cfd_proxy_tpu/utils/errors.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from __future__ import annotations

import numpy as np


class CheckError(RuntimeError):
    """Raised when a framework invariant is violated (ASSERT analogue)."""


def check(cond: bool, msg: str, *args) -> None:
    """Fatal check: raise CheckError with a formatted message if cond is false."""
    if not cond:
        raise CheckError(msg % args if args else msg)


def check_index_array(
    idx: np.ndarray,
    *,
    name: str,
    lo: int,
    hi: int,
    unique: bool = False,
) -> None:
    """Validate an index array: integer dtype, 1-D, all values in [lo, hi).

    Used on sendidx/recvidx/face adjacency before they are baked into static
    device metadata (where an out-of-range index would silently clamp or wrap
    under XLA gather/scatter semantics instead of faulting like C would).
    """
    check(np.issubdtype(idx.dtype, np.integer), "%s: dtype %s is not integer", name, idx.dtype)
    check(idx.ndim == 1, "%s: expected 1-D, got shape %s", name, idx.shape)
    if idx.size:
        mn, mx = int(idx.min()), int(idx.max())
        check(mn >= lo, "%s: min index %d < %d", name, mn, lo)
        check(mx < hi, "%s: max index %d >= %d", name, mx, hi)
    if unique:
        check(np.unique(idx).size == idx.size, "%s: indices are not unique", name)
