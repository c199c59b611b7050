"""The port's span recorder: where the time of the step and of its runner
goes, under CUDA graph replay as under eager dispatch.

Off by default, and then free: `span(name)` and `step()` return one shared
no-op context, which allocates nothing, calls no torch function and adds no
node to a captured graph.  `enable()`, before a model captures its graphs
(models/compiled.py), switches it on.  Then each span

- is a host range, `torch.profiler.record_function("cfd.<name>")`, while a
  profiler records (outside one a range costs host time and shows
  nowhere): it shares the profiler's clock with the device trace,
  lands in the profiler's trace (`solver.py --profile`'s Chrome trace among
  them) and nests, which gives it its parent;
- given a CUDA device, and inside a `step()` (one chained step of the
  runner), records a timing CUDA event at its boundaries.  Each event is
  recorded on a side stream of its own that forks from the current stream
  there, and the step's end joins the side streams back: the event fires
  when the work before it is done, no later work waits for it, and no
  event waits for another (in line, an event held the next kernel back by
  about 3 us on the H100).  The events are `external`, so stream capture
  makes each an event-record node of the graph, on a branch of its own,
  which every replay records anew.  Where one span closes and the next
  opens on the same stream the two share the boundary: N abutting phases
  take N + 1 events.  The placements keep every device operation of a step
  inside a span, so no work falls between two abutting spans.

A graph with event nodes still replays slower (about 3.5 us a node a step
on the H100, between the graphs), so the runner captures its steps without
events too and replays the timed pair only as the last two steps of a call
(models/compiled.py): their events are the ones `read()` takes.

`read()`, after a synchronise, takes the events of the steps run since the
last read (under graph the last replay of each graph replayed, eagerly
every step) and adds each span's device time to the totals: its self time,
the part of its range that its child spans leave (`recv_fill` inside
`sweep.interior`).  It also copies the peer transport's four wait words
to the host (`parallel/transport.py::read_waits`: the readiness and
arrival waits of K3-peer and K6 that spun, ns and count), the only read of
device memory the recorder makes outside its events.  Each sample keeps
the interval it came from (`samples()`).  `totals()` gives {"spans":
{"cfd.<name>": [samples, device ms]}, "steps": steps read, "counters": the
port's counters (`compiled.counters()`)}.

The spans, where they sit, and what they serve:

    sweep.bulk, sweep.boundary,   models/gradients.py `_sweep` (and the
    sweep.interior                gather boundary's zero fill, a second
                                  `sweep.boundary` before it), `_overlap`
                                  (the fused K3 call, which holds its
                                  in-kernel push): the sweep kernels
    pack, unpack                  `_pack` (and `_overlap`'s split of the
                                  buffers between carriers), `_unpack`:
                                  the exchange's glue
    recv_fill                     the receive buffer's zeros in the overlap
                                  wrappers (ops/blocksweep.py): glue
    exchange                      parallel/transport.py `Loopback.start`,
                                  `Dist.start`, `Dist.finish`: device time
                                  where the carrier moves data (the loopback
                                  copy, a collective)
    update                        `chain_body`, `solver_body`: the chained
                                  update (ops/update.py)
    rebuild, var_exchange         `_build_tables`, `_var_exchange` (a leaf:
                                  its pack and unpack are its own): the
                                  solver step's table rebuild
    runner, runner.lookup,        models/compiled.py `runner`, host only:
    runner.copy_in,               the schedule's check, the graph key and
    runner.replay,                the cache; the state copied in; the
    runner.copy_out               replays and their counts; the copy out:
                                  the report interval's turnaround
"""

from __future__ import annotations

import collections
import contextlib

import torch

PREFIX = "cfd."
LOG_SAMPLES = 65536     # samples kept with their interval (the newest)
SIDE_STREAMS = 16       # side streams a stream forks its events onto

NOOP = contextlib.nullcontext()


class _Step:
    """One step's boundary events, in the order they were recorded, and its
    spans, (name, first event, last event, parent span or -1)."""

    __slots__ = ("events", "spans", "forked")

    def __init__(self):
        self.events: list = []
        self.spans: list = []
        self.forked: dict = {}      # stream handle: (stream, sides used)

    def self_ms(self) -> list:
        """(name, device ms) of each span: its range less its children's.
        The events must have completed."""
        ev = self.events
        at = [0.0]
        for a, b in zip(ev, ev[1:]):
            at.append(at[-1] + a.elapsed_time(b))
        total = [at[e] - at[s] for _, s, e, _ in self.spans]
        own = list(total)
        for i, (_, _, _, parent) in enumerate(self.spans):
            if parent >= 0:
                own[parent] -= total[i]
        return [(sp[0], ms) for sp, ms in zip(self.spans, own)]


class _Recorder:
    def __init__(self):
        self.on = False
        self.reset()

    def reset(self) -> None:
        self.cur: _Step | None = None   # the open step, if any
        self.stack: list = []           # its open device spans
        self.quiet = 0                  # leaf spans open
        self.tail = None                # stream of the last close, if last
        self.sides: dict = {}           # the side streams of each stream
        self.graphs: dict = {}          # replayed graphs' steps, by id
        self.eager: list = []           # eager steps not read yet
        self.totals: dict = {}
        self.steps = 0
        self.reads = 0
        self.log = collections.deque(maxlen=LOG_SAMPLES)

    def boundary(self, dev: torch.device, close: bool) -> int:
        """The index of the step's event at this boundary: the last close's
        where an open follows it on the same stream, else a new one, on a
        side stream forked from it here (the step's k-th event on the
        stream's k-th, in turn)."""
        stream = torch.cuda.current_stream(dev)
        handle = stream.cuda_stream
        events = self.cur.events
        shared = not close and self.tail == handle
        self.tail = handle if close else None
        if shared:
            return len(events) - 1
        sides = self.sides.setdefault(handle, [])
        used = self.cur.forked.setdefault(handle, (stream, []))[1]
        k = len(used) % SIDE_STREAMS
        if k == len(sides):
            sides.append(torch.cuda.Stream(dev))
        side = sides[k]
        side.wait_stream(stream)
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record(side)
        events.append(ev)
        used.append(side)
        return len(events) - 1

    def open(self, name: str, dev: torch.device) -> None:
        first = self.boundary(dev, close=False)
        self.cur.spans.append((name, first, -1,
                               self.stack[-1] if self.stack else -1))
        self.stack.append(len(self.cur.spans) - 1)

    def close(self, dev: torch.device) -> None:
        i = self.stack.pop()
        name, first, _, parent = self.cur.spans[i]
        self.cur.spans[i] = (name, first, self.boundary(dev, close=True),
                             parent)


_rec = _Recorder()


class _Span:
    __slots__ = ("name", "dev", "leaf", "rf")

    def __init__(self, name: str, dev, leaf: bool, host: bool):
        self.name = PREFIX + name
        self.dev = dev
        self.leaf = leaf
        self.rf = torch.profiler.record_function(self.name) if host else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.dev is not None:
            _rec.open(self.name, self.dev)
        _rec.quiet += self.leaf

    def __exit__(self, *exc):
        _rec.quiet -= self.leaf
        if self.dev is not None:
            _rec.close(self.dev)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _StepScope:
    __slots__ = ("step",)

    def __enter__(self) -> _Step:
        self.step = _rec.cur = _Step()
        _rec.stack, _rec.tail = [], None
        return self.step

    def __exit__(self, *exc):
        step, _rec.cur, _rec.tail = self.step, None, None
        # each stream waits for its side streams (a capture joins every
        # stream it forked)
        for stream, used in step.forked.values():
            for side in used[:SIDE_STREAMS]:
                stream.wait_stream(side)
        # a captured step's events are read when its graph has replayed
        if step.events and not torch.cuda.is_current_stream_capturing():
            _rec.eager.append(step)
        return False


def enable() -> None:
    """Switch the recorder on (before the model captures its graphs: a graph
    captured while it was off holds no event)."""
    _rec.on = True


def disable() -> None:
    _rec.on = False


def enabled() -> bool:
    return _rec.on


def reset() -> None:
    """Drop every total, sample and step not read yet."""
    _rec.reset()


def span(name: str, device: torch.device | None = None, leaf: bool = False):
    """The context of span "cfd.<name>" (module docstring): the shared no-op
    while the recorder is off; a host range while a profiler records, and
    device events where `device` is a CUDA device, a `step()` is open and
    no leaf span is (the shared no-op where it would be neither).  A leaf
    span keeps the device time of the spans inside it: they are host
    ranges only (the var exchange's pack and unpack)."""
    if not _rec.on:
        return NOOP
    dev = device if (device is not None and device.type == "cuda"
                     and _rec.cur is not None and not _rec.quiet) else None
    host = torch.autograd._profiler_enabled()
    if dev is None and not host:
        return NOOP
    return _Span(name, dev, leaf, host)


def step():
    """The context of one chained step (the runner's): its spans' device
    events are grouped into one step, which `read()` takes after an eager
    step and, for a captured one, after `replayed`.  As the context's
    target, the step (None while the recorder is off)."""
    if not _rec.on:
        return NOOP
    return _StepScope()


def replayed(steps) -> None:
    """Mark the captured steps of the graphs just replayed for the next
    `read()`: their events hold the last replay's times."""
    if not _rec.on:
        return
    for s in steps:
        if s is not None and s.events:
            _rec.graphs[id(s)] = s


def read(interval: int | None = None) -> None:
    """Add the device time of every step marked since the last read to the
    totals, each sample tagged with `interval` (default: this read's
    number), and, while the recorder is on, the peer kernels' wait words to
    the counters.  Call it after a synchronise that covers those steps."""
    if _rec.on:
        from cfd_proxy_tpu_torch.parallel import transport

        transport.read_waits()
    if interval is None:
        interval = _rec.reads
    _rec.reads += 1
    steps = [*_rec.graphs.values(), *_rec.eager]
    _rec.graphs, _rec.eager = {}, []
    for s in steps:
        _rec.steps += 1
        for name, ms in s.self_ms():
            t = _rec.totals.setdefault(name, [0, 0.0])
            t[0] += 1
            t[1] += ms
            _rec.log.append((interval, name, ms))


def totals() -> dict:
    """{"spans": {span: [samples, device ms]}, "steps": steps read,
    "counters": {name: value} of the port's counters, the peer wait words
    as of the last `read()`}."""
    from cfd_proxy_tpu_torch.models import compiled

    return {"spans": {k: list(v) for k, v in _rec.totals.items()},
            "steps": _rec.steps, "counters": compiled.counts()}


def since(before: dict, after: dict) -> dict:
    """The totals `after` less `before` (two `totals()`): a stretch's."""
    spans = {}
    for k, (n, ms) in after["spans"].items():
        n0, ms0 = before["spans"].get(k, (0, 0.0))
        if n > n0:
            spans[k] = [n - n0, ms - ms0]
    return {"spans": spans, "steps": after["steps"] - before["steps"],
            "counters": {k: v - before["counters"].get(k, 0)
                         for k, v in after["counters"].items()}}


def samples() -> list:
    """The newest samples read, (interval, span, device ms), oldest first."""
    return list(_rec.log)
