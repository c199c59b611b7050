"""The traced run's arithmetic: a `torch.profiler` trace of a stretch of the
window reduced to what the per-layer metrics read.

The reduction follows `chip_smoke.py::device_profile` (device time by kernel
name, launches per step, records a step lacks), copied so that the yardstick
does not move with the program, and adds the timeline: the union of the
device's busy intervals and the idle gaps between them, each named by the
host operation that was running when it began.

A rank's summary, `summarize(...)`:

    steps        steps the stretch ran
    stretch_us   the stretch's wall time (host clock, the profiler's)
    busy_us      the union of every device activity in it
    ops          {name: [records, device us]}: kernels, copies and fills
    gaps         the 10 longest idle gaps, [host operation, us]
"""

from __future__ import annotations

STRETCH = "cfdbench.traced_stretch"     # the host span around the stretch
HOST_SPANS = "cfdbench."                 # the harness's own host spans
NAME_CHARS = 96                          # kernel names are cut to this
MEM_OPS = ("Memcpy", "Memset")           # device activities that are no kernel
TOP = 10


def is_kernel(name: str) -> bool:
    return not name.startswith(MEM_OPS)


def merge(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy: list, lo: float, hi: float) -> list:
    """The gaps [a, b) of [lo, hi) that no interval of `busy` (merged)
    covers."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def host_label(host: list, t: float) -> str:
    """The innermost host operation running at time t (host: (start, end,
    name)), else "no host operation"."""
    best = None
    for a, b, name in host:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, b, name)
    return best[2] if best else "no host operation"


def summarize(device: list, host: list, lo: float, hi: float,
              steps: int) -> dict:
    """A rank's summary (module docstring) from its device activities and
    host operations, each (start us, end us, name), over the stretch
    [lo, hi) that ran `steps` steps.  Activities are counted where they
    start inside the stretch."""
    inside = [(a, b, n[:NAME_CHARS]) for a, b, n in device if lo <= a < hi]
    ops: dict = {}
    for a, b, n in inside:
        rec = ops.setdefault(n, [0, 0.0])
        rec[0] += 1
        rec[1] += b - a
    busy = merge([(a, min(b, hi)) for a, b, _ in inside])
    gaps = sorted(idle_gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    return {"steps": int(steps), "stretch_us": hi - lo,
            "busy_us": sum(b - a for a, b in busy), "ops": ops,
            "gaps": [[host_label(host, a), b - a] for a, b in gaps]}


def from_profiler(prof, steps: int) -> dict:
    """A rank's summary from a finished `torch.profiler.profile` whose
    stretch ran inside a `record_function(STRETCH)` span."""
    from torch.autograd import DeviceType

    device, host, span = [], [], None
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # a host span's copy on the device's timeline is no activity
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(HOST_SPANS)):
                device.append((a, b, e.name))
        elif e.name == STRETCH:
            span = (a, b)
        else:
            host.append((a, b, e.name))
    if span is None:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    return summarize(device, host, span[0], span[1], steps)


def combine(ranks: list) -> dict:
    """The `breakdown` of the result line from the ranks' summaries: the
    device operations by seconds per chip and the longest idle gaps."""
    secs: dict = {}
    for r in ranks:
        for n, (_, us) in r["ops"].items():
            secs[n] = secs.get(n, 0.0) + us * 1e-6 / len(ranks)
    top = sorted(secs.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    for i, r in enumerate(ranks):
        tag = f"rank {i}: " if len(ranks) > 1 else ""
        gaps += [[tag + label, us * 1e-6] for label, us in r["gaps"]]
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": gaps[:TOP]}
