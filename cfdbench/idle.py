"""The idle device time of a traced stretch, split by where the host was.

`trace.summarize` names an idle gap by the host operation running when the
gap begins.  When the last kernel of a report interval ends, the host is
always still waiting in the harness's synchronise, so that label hides what
follows: the wake-up, the harness's Python and the port's runner.  Here
every idle microsecond of the stretch is put down to the host at that
instant, from the same events `trace.from_profiler` reads:

    innermost   {host operation: us}: the innermost one covering the
                instant (the one that began last, as `trace.host_label`
                picks), NONE where none does
    within      {span: us}: for each of the harness's and the port's own
                host spans (names starting "cfdbench." or "cfd.") in the
                stretch, the idle time while the host was inside it at any
                depth, so a parent's holds its children's; 0 for a span
                that covered no idle time
    turnaround  {host operation: us}: `innermost` of the report intervals'
                turnarounds alone: the gaps in which an interval's launch
                (`cfdbench.launch_interval`) begins, from the last kernel of
                one interval to the first of the next; the rest of the idle
                time lies between kernels inside the intervals
"""

from __future__ import annotations

from cfdbench import trace

OWN = ("cfdbench.", "cfd.")       # the harness's spans, the port's
NONE = "no host operation"
LAUNCH = "cfdbench.launch_interval"


def split(device: list, host: list, lo: float, hi: float) -> dict:
    """{"innermost", "within"} (module docstring) of the stretch [lo, hi)
    from its device activities and host operations, each (start us, end
    us, name).  The device is busy where `trace.summarize` has it: the
    union of the activities that start inside the stretch.  One sweep over
    the host operations' and the gaps' ends, in order."""
    busy = trace.merge([(a, min(b, hi)) for a, b, _ in device
                        if lo <= a < hi])
    gaps = trace.idle_gaps(busy, lo, hi)
    host = sorted((a, b, n) for a, b, n in host if a < hi and b > lo)
    innermost: dict = {}
    turnaround: dict = {}
    within = {n: 0.0 for _, _, n in host if n.startswith(OWN)}
    launches = [a for a, _, n in host if n == LAUNCH]
    turns = [(a, b) for a, b in gaps
             if any(a <= t <= b for t in launches)]
    points = sorted({lo, hi, *(t for g in gaps for t in g),
                     *(t for a, b, _ in host for t in (a, b) if lo < t < hi)})
    active: list = []           # the host operations covering, by start
    i = j = 0
    t = 0                       # the turnaround gaps passed
    for p, q in zip(points, points[1:]):
        while i < len(host) and host[i][0] <= p:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > p]
        while j < len(gaps) and gaps[j][1] <= p:
            j += 1
        if j == len(gaps) or gaps[j][0] > p:
            continue                # [p, q) is busy
        label = active[-1][2] if active else NONE
        innermost[label] = innermost.get(label, 0.0) + (q - p)
        for n in {h[2] for h in active if h[2] in within}:
            within[n] += q - p
        while t < len(turns) and turns[t][1] <= p:
            t += 1
        if t < len(turns) and turns[t][0] <= p:
            turnaround[label] = turnaround.get(label, 0.0) + (q - p)
    return {"innermost": innermost, "within": within,
            "turnaround": turnaround}


def from_profiler(prof) -> dict:
    """`split` of a finished `torch.profiler.profile` whose stretch ran
    inside a `record_function(trace.STRETCH)` span, its events filtered as
    `trace.from_profiler` filters them."""
    from torch.autograd import DeviceType

    device, host, span = [], [], None
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(OWN)):
                device.append((a, b, e.name))
        elif e.name == trace.STRETCH:
            span = (a, b)
        else:
            host.append((a, b, e.name))
    if span is None:
        raise RuntimeError(f"the trace holds no {trace.STRETCH} span")
    return split(device, host, span[0], span[1])


def combine(ranks: list) -> dict:
    """The ranks' splits as ms per report interval, each label's the
    highest rank's, largest first (each rank's summary holds
    "idle_by_host" and "intervals")."""
    out = {}
    for key in ("innermost", "within", "turnaround"):
        ms: dict = {}
        for r in ranks:
            for n, us in r["idle_by_host"][key].items():
                ms[n] = max(ms.get(n, 0.0), us * 1e-3 / r["intervals"])
        out[key] = sorted(([n, v] for n, v in ms.items()),
                          key=lambda kv: -kv[1])
    return out
