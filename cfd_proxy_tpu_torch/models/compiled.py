"""Compiled dispatch of the chained step: CUDA graphs of one step, replayed.

Counterpart of the JAX package's jit + `lax.fori_loop` sites
(`cfd_proxy_tpu/models/gradients_pallas.py:1028, 1096-1104, 1140-1172`,
`models/gradients.py:127, 149, 172-181`): the reference compiles the step
and the whole chained loop into one executable that the host dispatches
once.  Here the models' `iterate_fn` runners take one of two forms:

- **graph**: one chained step (the model's step body, or the solver-mode
  body: table rebuild, sweeps with their updates, var exchange) is
  captured with `torch.cuda.CUDAGraph` on two static state buffers, once
  from each into the other, and the two graphs are replayed in turn, n
  steps in all, n chosen at call time as the reference's `fori_loop`
  bound is.  The first call of a configuration runs step 1 eagerly on a
  side stream (it builds the kernel library, raises the kernels'
  shared-memory limits and fills the allocator's pool), captures the two
  graphs, then replays n − 1 times; later calls copy the caller's state in
  and replay n times.  The step's last operation writes the other buffer
  (the update `ops.update.chain_update(v, g, COUPLING, out=...)`: the
  eager loop's kernel and types, only the destination given), so the graph
  equals the eager loop bit for bit and no step copies the state.  The
  caller's state is left untouched and a new tensor comes back, as JAX
  returns a new array.
- **eager**: the same body, step by step from Python.

`dispatch(model, schedule, solver_mode)` decides per chained body, by one
rule: graph on a CUDA device wherever every exchange of that body runs in
a kernel or on the device.  That is every body at one rank, with
`loopback` or `peer` (whose launch epochs are device words the kernels
advance, csrc/push_common.cuh, so a replay meets its own flags), and at
several ranks through `peer` the bodies whose only exchange is the
in-kernel push: the static `overlap` chain with no phase routed to the
collective carrier, `nocomm`, and the push bench's chain ("push",
tools/icibench.py).  Eager, with a stated reason (`EAGER_REASONS`), on the
CPU and wherever an exchange goes through `torch.distributed`.  There is
no fallback: a capture that fails where the rule says graph raises, and
asking for a graph where the rule says eager raises `CheckError`.

Each model keeps its graphs in `model.graphs`, an OrderedDict keyed on
the body's key (schedule, solver mode, sweeps, coupling), the state's
shape and dtype (its values are copied in) and the data pointer, shape and
dtype of every table tensor the body reads: a new tables dict
(`refresh_state` returns one) captures anew.  An entry holds its tables,
so a pointer in a live graph always names the tensor it was captured on.
`close()` frees the graphs and their pools.

The chained update's factor, COUPLING = 1e-30, is the reference's: in f32
it leaves the state as it was to the last bit, so a result after n steps
shows nothing of the gradients.  The runners take a larger one
(`iterate_fn(..., coupling=)`) where a check must see each step's
gradients in the state it carries (the tests, chip_smoke.py's `graph`
phase).

Counters.  The port's counters (`counters()`) are function attributes.
The step's Python raises the kernel wrappers' launch counts
(`ops/blocksweep.py::_count`, `launch_counters()`), the bytes the
exchange's pack writes, padded and live (`halo_bytes`, `halo_live_bytes`,
models/gradients.py), and the graphs captured (`captures`).  The peer
kernels' waits that spun (`peer_wait_*`, parallel/transport.py) are device
words that only `spans.read()` copies to the host, never a step.  A replay runs
no Python, so the capture records which counters its step raised, takes
those counts back (a captured launch runs nothing) and the runner adds
them once per replay (`Entry.delta`); `captures` is raised after the take
back, so a replay does not raise it.  `kernel_nodes` lists the kernels a
replay launches, read from the captured graph; chip_smoke.py's `graph`
phase holds them against the kernels CUPTI sees an eager step launch and
against the counts a replay adds.  `event_nodes` counts the graph's
event-record nodes: the span recorder's (utils/spans.py), none while it is
off.

Spans (utils/spans.py, off by default).  Each eager step is a
`spans.step()`, which groups its device spans.  The graphs the runner
replays hold no span event; with the recorder on, `capture` also captures
each graph's step once more inside a `spans.step()` (`Entry.timed`: the
same kernels, and the spans' event nodes), and the runner replays that
pair as the last two steps of a call, whose events `spans.read()` then
takes: a graph with event nodes replays slower, and only the last replay
of each is read.  The runner's own host spans: `cfd.runner` around a
call, and inside it `cfd.runner.lookup` (the schedule's check, the graph
key, the cache), `cfd.runner.copy_in`, `cfd.runner.replay` (the replays
and their counts) and `cfd.runner.copy_out`.
"""

from __future__ import annotations

import collections
import contextlib
import time
import typing

import torch

from cfd_proxy_tpu_torch.ops import blocksweep, halo_pack, push, update
from cfd_proxy_tpu_torch.parallel import transport
from cfd_proxy_tpu_torch.utils import spans
from cfd_proxy_tpu_torch.utils.errors import check

GRAPH, EAGER = "graph", "eager"
GRAPH_REASON = ("cuda, every exchange of the step in a kernel or on the "
                "device: the chained step is captured once and replayed as "
                "CUDA graphs")
EAGER_REASONS = {
    "cpu": "cpu: no CUDA graphs on the CPU; the plain versions run op by op",
    "dist": "dist: an exchange of the step goes through torch.distributed "
            "(--transport dist; at several ranks the bulk and early "
            "exchanges, solver mode's var exchange and the phases "
            "slice_size routes to the collective carrier): gloo staging "
            "synchronises the host, and several ranks need several GPUs",
}
# the chained bodies whose only exchange, at several ranks through peer,
# can be the in-kernel push ("push": the push bench's chain)
IN_KERNEL = ("overlap", "nocomm", "push")
CACHE_SIZE = 8          # graphs a model keeps (least recently used go)
COUPLING = 1e-30        # the reference's chained update: v + 1e-30 · g

# runner calls per (kind, reason) since the last `take_calls`: which
# dispatch a run's chained loops took
_CALLS: collections.Counter = collections.Counter()


def dispatch(model, schedule: str | None = None,
             solver_mode: bool = False) -> tuple[str, str]:
    """(GRAPH or EAGER, the reason) for a model's chained runner of
    `schedule` (None: a body of unknown exchanges), solver mode or not:
    graph on a CUDA device at one rank with `loopback` or `peer`, and at
    several ranks through `peer` for a static body of IN_KERNEL whose push
    carries every phase (overlap: the model holds its `Peer` and routes no
    phase); else eager."""
    if torch.device(model.device).type != "cuda":
        return EAGER, EAGER_REASONS["cpu"]
    kind = getattr(model, "transport_kind", "loopback")
    if kind not in ("loopback", "peer"):
        return EAGER, EAGER_REASONS["dist"]
    if model.world == 1:
        return GRAPH, GRAPH_REASON
    in_kernel = not solver_mode and schedule in IN_KERNEL and not (
        schedule == "overlap" and (getattr(model, "peer", None) is None
                                   or getattr(model, "routed", False)))
    return (GRAPH, GRAPH_REASON) if in_kernel else \
        (EAGER, EAGER_REASONS["dist"])


def dispatch_all(model, schedules, solver_mode: bool = False
                 ) -> tuple[str, str]:
    """GRAPH where every listed schedule's runner replays graphs, else the
    first eager one's (EAGER, reason): what a run's timed loops took."""
    for s in schedules:
        kind, why = dispatch(model, s, solver_mode)
        if kind == EAGER:
            return kind, why
    return GRAPH, GRAPH_REASON


def use_graph(model, graph: bool | None, schedule: str | None = None,
              solver_mode: bool = False) -> bool:
    """Whether a runner replays a graph: graph None follows `dispatch`,
    False runs eager, True demands the graph and raises where the rule
    says eager."""
    kind, why = dispatch(model, schedule, solver_mode)
    if graph is None:
        return kind == GRAPH
    check(not graph or kind == GRAPH, "graph=True: this model's chained "
          "step runs eagerly (%s)", why)
    return bool(graph)


def take_calls() -> dict:
    """{kind: runner calls} since the last call, with the reasons of the
    eager ones under "eager_reasons"; then start counting anew."""
    out: dict = {}
    reasons = []
    for (kind, why), n in _CALLS.items():
        out[kind] = out.get(kind, 0) + n
        if kind == EAGER and why not in reasons:
            reasons.append(why)
    if reasons:
        out["eager_reasons"] = reasons
    _CALLS.clear()
    return out


# ------------------------------------------------------------ counters

def launch_counters() -> dict:
    """The port's launch counters a chained body can raise: the sweep
    kernels', the chained update's, the halo pack's and K6's (the push
    bench's chain)."""
    return {**blocksweep.launch_counters(), **update.launch_counters(),
            **halo_pack.launch_counters(), **push.launch_counters()}


def counters() -> dict:
    """The port's counters, {name: (function, attribute)}: the launch
    counters, the pack's `halo_bytes` and `halo_live_bytes`
    (models/gradients.py), the peer kernels' waits that spun
    (`peer_wait_*`, parallel/transport.py: host copies of device words,
    which only `spans.read()` takes) and `captures`, the graphs captured."""
    from cfd_proxy_tpu_torch.models import gradients

    return {**launch_counters(), **gradients.halo_counters(),
            **transport.wait_counters(), "captures": (capture, "captures")}


def counts() -> dict:
    """{name: value} of every counter of `counters()`."""
    return {k: getattr(fn, a) for k, (fn, a) in counters().items()}


def _set_counts(values: dict) -> None:
    for k, (fn, a) in counters().items():
        setattr(fn, a, values[k])


def _add_counts(delta: dict, times: int) -> None:
    if times <= 0:
        return
    registry = counters()
    for k, d in delta.items():
        fn, a = registry[k]
        setattr(fn, a, getattr(fn, a) + d * times)


# --------------------------------------------------------------- cache

class Entry(typing.NamedTuple):
    """One captured step: its two graphs and state buffers (`capture`), the
    counts one replay stands for, the tensors it reads (held, so the
    pointers in the graphs stay theirs), the capture's seconds, and, with
    the span recorder on, the timed twin of each graph with its step of
    spans, [(graph, spans.step)] (None while the recorder is off)."""
    graphs: list
    bufs: tuple
    delta: dict
    keep: list
    seconds: float
    timed: list | None


def _sig(t: torch.Tensor, ptr: bool) -> tuple:
    return ((t.data_ptr(),) if ptr else ()) + (tuple(t.shape), t.dtype,
                                               str(t.device))


def _tensors(rest) -> list:
    """The tensors of the runner's extra arguments (a tables dict, or
    nothing), in a fixed order."""
    out = []
    for a in rest:
        if isinstance(a, dict):
            out += [(k, a[k]) for k in sorted(a)]
        elif isinstance(a, torch.Tensor):
            out.append(("", a))
    return out


def graph_key(key, var_T: torch.Tensor, rest) -> tuple:
    return (key, _sig(var_T, False),
            tuple((k, _sig(t, True)) for k, t in _tensors(rest)))


# -------------------------------------------------------------- capture

@contextlib.contextmanager
def _no_sync():
    """Raise on any host synchronisation inside the block: a captured step
    must not wait for the card."""
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


@contextlib.contextmanager
def _side_stream(dev: torch.device):
    """The block on a fresh stream that starts after, and is waited for
    by, the device's current one (the warm-up before a capture)."""
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


def _record(step, pool=None):
    """A CUDA graph of step()'s launches, captured on its own stream under
    the sync check, into the memory pool `pool`, else a pool of its own,
    and instantiated; its node graph is kept (`kernel_nodes` reads it).
    Nothing runs."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, pool=pool):
        with _no_sync():
            step()
    graph.instantiate()
    return graph


def _graph_nodes(graph):
    """(cuda driver, [(node, CUgraphNodeType)]) of a captured graph
    (`cuGraphGetNodes`, `cuGraphNodeGetType`)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    num = ctypes.c_size_t(0)
    _ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(num)),
        "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * num.value)()
    _ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(num)),
        "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
            "cuGraphNodeGetType")
        out.append((node, kind.value))
    return cu, out


def _ok(rc: int, what: str) -> None:
    check(rc == 0, "%s failed (CUresult %d)", what, rc)


def event_nodes(graph) -> int:
    """The event-record nodes of a captured graph (the span recorder's:
    none while it is off)."""
    return sum(kind == 7 for _, kind in _graph_nodes(graph)[1])  # EVENT_RECORD


def kernel_nodes(graph) -> list:
    """The kernels one replay of a captured graph launches: the demangled
    symbol of each of its kernel nodes, read from the graph through the
    driver (`cuGraphGetNodes`, `cuGraphKernelNodeGetParams`,
    `cuFuncGetName` or `cuKernelGetName`)."""
    import ctypes

    cxx = ctypes.CDLL("libstdc++.so.6")
    demangle = cxx.__cxa_demangle
    demangle.restype = ctypes.c_void_p
    demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int)]
    free = ctypes.CDLL("libc.so.6").free
    free.argtypes = [ctypes.c_void_p]

    class Params(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 7),
                    ("kernelParams", ctypes.c_void_p),
                    ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                    ("ctx", ctypes.c_void_p)]

    cu, nodes = _graph_nodes(graph)
    out = []
    for node, kind in nodes:
        if kind != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = Params()
        _ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                             ctypes.byref(p)),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            _ok(cu.cuFuncGetName(ctypes.byref(name),
                                 ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            _ok(cu.cuKernelGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.kern)),
                "cuKernelGetName")
        status = ctypes.c_int(-1)
        buf = demangle(name.value, None, None, ctypes.byref(status))
        if status.value == 0:
            out.append(ctypes.string_at(buf).decode())
            free(buf)
        else:
            out.append(name.value.decode())
    return out


def capture(body, var_T: torch.Tensor, rest: tuple) -> Entry:
    """Two state buffers, `bufs[0]` a copy of var_T; step 1 eagerly on a
    side stream, bufs[0] → bufs[1] (counted: its kernels run; its first
    calls fill the wrappers' host-side caches); then graph i captured as
    the step bufs[i] → bufs[1 − i], both in one memory pool (they never run
    at once, and nothing they allocate outlives a replay).  The captures'
    counts are taken back; one capture's is the delta a replay adds.  With
    the span recorder on, each graph's step is captured once more inside a
    `spans.step()`, into the same pool (`Entry.timed`)."""
    t0 = time.perf_counter()
    bufs = (var_T.clone(), torch.empty_like(var_T))
    with _side_stream(var_T.device), spans.step():
        body(bufs[0], *rest, out=bufs[1])
    warm = counts()
    graphs, delta, timed = [], None, []

    def step(i):
        body(bufs[i], *rest, out=bufs[1 - i])

    def timed_step(i, into):
        with spans.step() as st:
            step(i)
        into.append(st)

    try:
        for i in (0, 1):
            graphs.append(_record(lambda i=i: step(i),
                                  graphs[0].pool() if graphs else None))
            if delta is None:
                after = counts()
                delta = {k: after[k] - warm[k] for k in after
                         if after[k] != warm[k]}
        if spans.enabled():
            for i in (0, 1):
                st: list = []
                timed.append((_record(lambda i=i: timed_step(i, st),
                                      graphs[0].pool()), st[0]))
    except Exception as e:
        raise RuntimeError(f"CUDA graph capture of the chained step failed "
                           f"({type(e).__name__}: {e}); dispatch said graph "
                           f"and nothing falls back to eager") from e
    finally:
        _set_counts(warm)
    capture.captures += len(graphs) + len(timed)
    return Entry(graphs, bufs, delta, _tensors(rest),
                 time.perf_counter() - t0, timed or None)


capture.captures = 0


# -------------------------------------------------------------- runners

def runner(model, body, n: int, key, *, graph: bool | None = None,
           schedule: str | None = None, solver_mode: bool = False,
           precheck=None):
    """The chained n-step runner of `body(v, *rest, out=None) -> v'` (v is
    not written; v' is a new tensor, or `out` when given, which the step's
    last operation writes as it would a new tensor): run(var_T, *rest) →
    the state after n steps, a new tensor.  graph: as in `use_graph`, for
    the body's schedule and solver mode (the dispatch rule's inputs).  key:
    what tells this body from the model's others.  precheck(var_T, *rest),
    when given, runs first at every call and raises on arguments the body
    cannot take.

    Under graph the captured steps live in `model.graphs` (an OrderedDict,
    the least recently used dropped past CACHE_SIZE), keyed on `key`, the
    state's shape and dtype (its values are copied in) and the data
    pointer, shape and dtype of every tensor of `rest`: a new tables dict
    captures anew.  The state lives in the entry's two buffers, and graph
    i takes buffer i to buffer 1 − i: the steps alternate the two, so no
    step copies the state."""
    check(n >= 0, "n must be >= 0, got %d", n)
    if not use_graph(model, graph, schedule, solver_mode):
        why = (dispatch(model, schedule, solver_mode)[1] if graph is None
               else "graph=False")

        def run_eager(var_T, *rest):
            with spans.span("runner"):
                if precheck is not None:
                    precheck(var_T, *rest)
                _CALLS[(EAGER, why)] += 1
                v = var_T
                for _ in range(n):
                    with spans.step():
                        v = body(v, *rest)
                return v

        return run_eager

    cache = model.graphs

    def run_graph(var_T, *rest):
        with spans.span("runner"):
            with spans.span("runner.lookup"):
                if precheck is not None:
                    precheck(var_T, *rest)
                _CALLS[(GRAPH, GRAPH_REASON)] += 1
                if n == 0:
                    return var_T.clone()
                k = graph_key(key, var_T, rest)
                entry = cache.get(k)
                if entry is not None:
                    cache.move_to_end(k)
            done = cur = 0
            if entry is None:
                entry = cache[k] = capture(body, var_T, rest)
                while len(cache) > CACHE_SIZE:
                    cache.popitem(last=False)
                done = cur = 1          # the eager warm-up was step 1
            else:
                with spans.span("runner.copy_in"):
                    entry.bufs[0].copy_(var_T)
            m, timed = n - done, entry.timed
            with spans.span("runner.replay"):
                for j in range(m):
                    # the last two steps on the timed twins, if any
                    (entry.graphs[cur] if timed is None or j < m - 2
                     else timed[cur][0]).replay()
                    cur = 1 - cur
                _add_counts(entry.delta, m)
            if timed is not None:
                # the twins replayed: the last step's, and the one before
                spans.replayed(timed[i][1] for i in [1 - cur, cur][:m])
            with spans.span("runner.copy_out"):
                return entry.bufs[cur].clone()

    return run_graph
