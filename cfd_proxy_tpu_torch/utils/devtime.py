"""Device time of short calls on a CUDA card.

A CUDA-event mean over calls enqueued onto an idle stream measures the
host's launch rate when a call's kernels are shorter than their launches.
`held_device_ms` first puts a sleep kernel on the stream, so the host has
enqueued all n calls before the card starts them: the events then time the
card alone.
"""

from __future__ import annotations

import time

import torch

from cfd_proxy_tpu_torch.utils.errors import check

SLEEP_CYCLES_PER_S = 2.0e9     # torch.cuda._sleep: about the SM clock


def held_device_ms(fn, n: int) -> float:
    """Mean device milliseconds per call of n calls of fn that run back to
    back on the current CUDA device.  The sleep is lengthened until it
    outlasts the enqueueing."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0       # an upper bound: may have waited
    torch.cuda.synchronize()
    cycles = int((2 * host_s + 2e-4) * SLEEP_CYCLES_PER_S)
    for _ in range(6):
        held = torch.cuda.Event()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        held.record()
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        covered = not held.query()          # still asleep: all n were queued
        torch.cuda.synchronize()
        if covered:
            return e0.elapsed_time(e1) / n
        cycles *= 2
    check(False, "held_device_ms: the host could not enqueue ahead of the "
          "card")
