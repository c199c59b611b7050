"""The compiled dispatch of the chained step (models/compiled.py).

On the CPU (no CUDA graphs here):

- the dispatch rule and its reasons over CPU/CUDA × loopback/peer/dist ×
  ranks × schedule × solver mode (at several ranks through peer, graph only
  for the static bodies whose exchange is the in-kernel push, and not when
  slice_size routes a phase to the collective carrier), and `graph=True`
  where the rule says eager raising `CheckError`;
- the factored step and solver bodies (`chain_body`, `solver_body`), run
  eagerly through `iterate_fn` at a coupling (C) that makes the state carry
  each step's gradients (the reference's 1e-30 leaves an f32 state as it
  was to the last bit, so a result after n steps would show nothing of
  them): bit for bit equal to the loops they were factored out of (kept
  here as they were, the factor made a parameter) and within 1e-6 relative
  of the JAX model's loop at the same coupling, built as its `iterate_fn`
  builds it from its jitted step, table rebuild and var exchange
  (`GreenGaussPallas(..., interpret=True)` on the same plan data), with
  the first step's gradients held against its `step`: packed and gather;
  bulk, early, overlap and nocomm; P ∈ {1, 3}; solver mode at 1 and 2
  sweeps per step; the flux model;
- the runner's bookkeeping with the graph primitive replaced by a stand-in
  that records a step's Python (as a capture does: the wrappers count)
  and replays the recorded step with the tensors it was recorded on
  without counting (`_record`, `_side_stream`): the launch counters raised
  by the capture taken back once and added once per replay, the state
  after n steps bit for bit the eager loop's, one replayed step's
  gradients the eager step's, the caller's state untouched, and the cache
  key (a new tables dict captures anew, and a replay after
  `refresh_state` reads the new tables; the solver body, which reads no
  table, does not; `close()` frees every graph).

On the card (`cuda` marker; skipped here; no JAX imported, so `python -m
pytest --noconftest tests/test_torch_compiled.py -m cuda` runs there):
graph against eager bit for bit at C, the port's kernels among the
captured graph's kernel nodes one per launch the runner adds, one replayed
step's gradients equal to the eager step's and within the reference's 1e-5 of the f64
golden, per schedule, packed and gather, chained and solver mode, and a
fresh capture after `refresh_state` whose replay reads the new tables.
"""

import collections
import contextlib
import re
import types

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.models.gradients import (SCHEDULE_CLASSES,
                                                  GreenGaussTorch,
                                                  PSDFluxModel)
from cfd_proxy_tpu_torch.models.gradients_ell import GreenGaussModel
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops.plan import NV
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

NVAR = 5
BP = 128
PORT_TOL = 1e-6      # port vs reference, relative to max(1, max|ref|)
SCHEDULES = ("bulk", "early", "overlap", "nocomm")
STEPS = 2
C = 0.1              # the coupling that makes the state carry the gradients


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def models(mesh):
    """(op, P, kernel) → (JAX model, port model on its plan data), built
    on first use.  JAX is imported here, so the card's cases run without
    it."""
    from cfd_proxy_tpu.models import GreenGaussPallas
    from cfd_proxy_tpu.models import PSDFluxModel as JaxFlux
    from cfd_proxy_tpu_torch.convert import plans_from_jax

    cache = {}

    def get(op, npart, kernel):
        key = (op, npart, kernel)
        if key not in cache:
            parts = partition_mesh(mesh, npart, ghost_layers=1)
            jcls, tcls = ((GreenGaussPallas, GreenGaussTorch) if op == "gg"
                          else (JaxFlux, PSDFluxModel))
            jm = jcls(parts, NVAR, bp=BP, interpret=True, kernel=kernel)
            tm = tcls.from_arrays(jm.parts, NVAR, plans_from_jax(jm),
                                  device="cpu")
            cache[key] = jm, tm
        return cache[key]

    return get


# --------------------------------------------------------- the rule

def _fake(device="cuda", transport="loopback", world=1, peer=True,
          routed=False):
    """What the rule reads of a model; `peer`: it holds its Peer (the
    overlap push has phases to carry), `routed`: slice_size sent phases to
    the collective carrier."""
    return types.SimpleNamespace(
        device=torch.device(device), transport_kind=transport, world=world,
        peer=object() if peer and transport == "peer" else None,
        routed=routed)


BODIES = (*SCHEDULES, "push", None)      # None: a body of unknown exchanges
GRAPH_AT_ONE_RANK = [
    ("cuda", t, 1, s, solver, {}, "graph")
    for t in ("loopback", "peer") for s in BODIES for solver in (False, True)
    if not (solver and s in ("push", None))]
RULE_CASES = GRAPH_AT_ONE_RANK + [
    # several ranks through peer: the static in-kernel bodies replay
    ("cuda", "peer", 2, "overlap", False, {}, "graph"),
    ("cuda", "peer", 4, "overlap", False, {}, "graph"),
    ("cuda", "peer", 2, "nocomm", False, {}, "graph"),
    ("cuda", "peer", 2, "push", False, {}, "graph"),
    ("cuda", "peer", 4, "push", False, {}, "graph"),
    # ... the rest go through torch.distributed
    ("cuda", "peer", 2, "bulk", False, {}, "dist"),
    ("cuda", "peer", 2, "early", False, {}, "dist"),
    ("cuda", "peer", 4, "early", False, {}, "dist"),
    ("cuda", "peer", 2, None, False, {}, "dist"),
    ("cuda", "peer", 2, "overlap", True, {}, "dist"),   # the var exchange
    ("cuda", "peer", 2, "nocomm", True, {}, "dist"),
    ("cuda", "peer", 2, "overlap", False, {"routed": True}, "dist"),
    ("cuda", "peer", 2, "overlap", False, {"peer": False}, "dist"),
    ("cuda", "dist", 1, "bulk", False, {}, "dist"),
    ("cuda", "dist", 1, "overlap", False, {}, "dist"),
    ("cuda", "dist", 2, "overlap", False, {}, "dist"),
    ("cuda", "dist", 2, "nocomm", False, {}, "dist"),
    ("cuda", "dist", 4, "push", False, {}, "dist"),
    ("cpu", "loopback", 1, "bulk", False, {}, "cpu"),
    ("cpu", "loopback", 1, "overlap", True, {}, "cpu"),
    ("cpu", "dist", 2, "overlap", False, {}, "cpu"),
    ("cpu", "peer", 2, "overlap", False, {}, "cpu"),
    ("cpu", "loopback", 1, "push", False, {}, "cpu"),
]


@pytest.mark.parametrize("device,transport,world,schedule,solver,extra,want",
                         RULE_CASES)
def test_dispatch_rule(device, transport, world, schedule, solver, extra,
                       want):
    model = _fake(device, transport, world, **extra)
    got, why = compiled.dispatch(model, schedule, solver)
    assert got == ("graph" if want == "graph" else "eager")
    if want == "graph":
        assert why == compiled.GRAPH_REASON
        assert compiled.use_graph(model, None, schedule, solver)
    else:
        assert why == compiled.EAGER_REASONS[want]
        assert not compiled.use_graph(model, None, schedule, solver)
        with pytest.raises(CheckError, match="graph=True.*" + want):
            compiled.use_graph(model, True, schedule, solver)
    assert not compiled.use_graph(model, False, schedule, solver)


def test_no_peer_reason_left():
    """The peer transport's launch epochs are device words: no eager
    reason names it, and the dist reason names what goes through
    torch.distributed."""
    assert set(compiled.EAGER_REASONS) == {"cpu", "dist"}
    why = compiled.EAGER_REASONS["dist"]
    for what in ("--transport dist", "bulk and early", "var exchange",
                 "slice_size"):
        assert what in why


def test_dispatch_all_sums_up_a_run():
    w2 = _fake(transport="peer", world=2)
    assert compiled.dispatch_all(w2, ["overlap", "nocomm"])[0] == "graph"
    assert compiled.dispatch_all(w2, ["bulk", "overlap"]) == (
        "eager", compiled.EAGER_REASONS["dist"])
    assert compiled.dispatch_all(w2, ["overlap"], solver_mode=True)[0] == \
        "eager"
    assert compiled.dispatch_all(_fake(transport="peer"),
                                 SCHEDULES, True)[0] == "graph"


def test_graph_true_raises_where_the_rule_says_eager(models, gvar):
    _, tm = models("gg", 1, "packed")
    assert compiled.dispatch(tm) == ("eager", compiled.EAGER_REASONS["cpu"])
    with pytest.raises(CheckError, match="graph=True.*cpu"):
        tm.iterate_fn("bulk", 2, graph=True)
    with pytest.raises(CheckError, match="graph=True.*cpu"):
        tm.iterate_fn("bulk", 2, solver_mode=True, graph=True)
    ell = GreenGaussModel(tm.parts, NVAR, device="cpu")
    with pytest.raises(CheckError, match="graph=True.*cpu"):
        ell.iterate_fn("bulk", 2, graph=True)
    for fake, s in ((_fake(transport="dist", world=2), "overlap"),
                    (_fake(transport="peer", world=2), "bulk"),
                    (_fake(transport="peer", world=2, routed=True),
                     "overlap")):
        with pytest.raises(CheckError, match="graph=True.*dist"):
            compiled.use_graph(fake, True, s)
        assert not compiled.use_graph(fake, None, s)
    assert compiled.use_graph(_fake(), None)
    assert compiled.use_graph(_fake(transport="peer"), None, "early", True)
    assert not compiled.use_graph(_fake(), False)


def test_calls_report_the_dispatch(models, gvar):
    _, tm = models("gg", 1, "packed")
    st = tm.distribute_state(gvar, schedules=["bulk"])
    compiled.take_calls()
    tm.iterate_fn("bulk", 1)(*tm.iter_args(st))
    tm.iterate_fn("bulk", 1, graph=False)(*tm.iter_args(st))
    got = compiled.take_calls()
    assert got["eager"] == 2 and "graph" not in got
    assert compiled.EAGER_REASONS["cpu"] in got["eager_reasons"]
    assert "graph=False" in got["eager_reasons"]
    assert compiled.take_calls() == {}


# ------------------------------------------- the factored bodies, eager

def _parent_chain(model, var_T, tables, schedule, n, c):
    """The chained loop as it was before the bodies were factored out
    (its factor 1e-30 made the parameter c)."""
    v = var_T
    for _ in range(n):
        g = model(v, tables, schedule)
        v = v + c * g[:, :NV]
    return v


def _parent_solver(model, var_T, schedule, n, sweeps_per_step, c):
    """The solver-mode loop as it was before the bodies were factored out
    (its factor 1e-30 made the parameter c)."""
    needed = SCHEDULE_CLASSES[schedule]
    v = var_T
    for _ in range(n):
        tb = model._build_tables(v, needed)
        for _ in range(sweeps_per_step):
            v = v + c * model(v, tb, schedule)[:, :NV]
        v = model._var_exchange(v)
    return v


def _jax_loop(jm, js, schedule, n, c, sweeps=0):
    """The JAX model's chained loop (sweeps 0) or solver-mode loop at
    coupling c, from the pieces its `iterate_fn` jits into one loop
    (gradients_pallas.py:1096-1104, 1140-1172): its step, its table
    rebuild of the classes the schedule reads, its var exchange."""
    step = jm.step_fn(schedule)
    args = jm.iter_args(js)
    v, rest = args[0], list(args[1:])
    if not sweeps:
        for _ in range(n):
            v = v + c * step(v, *rest)[:, :NV, :]
        return np.asarray(v)
    needed = SCHEDULE_CLASSES[schedule]
    tables = jm._build_tables_fn(needed)
    exch = jm._var_exchange_fn()
    slot = {"bulk": 0, "boundary": 1, "interior": 2}
    plans = {"bulk": rest[8], "boundary": rest[9], "interior": rest[10]}
    for _ in range(n):
        tb = list(rest)
        for cls, t in zip(needed, tables(v, *[plans[k] for k in needed])):
            tb[slot[cls]] = t
        for _ in range(sweeps):
            v = v + c * step(v, *tb)[:, :NV, :]
        v = exch(v, rest[3], rest[4])
    return np.asarray(v)


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() / scale < PORT_TOL


CHAIN = [pytest.param("gg", p, k, s, id=f"gg-P{p}-{k}-{s}")
         for p in (1, 3) for k in ("packed", "gather") for s in SCHEDULES]
CHAIN += [pytest.param("flux", 3, "packed", "overlap",
                       id="flux-P3-packed-overlap"),
          pytest.param("flux", 1, "gather", "bulk", id="flux-P1-gather-bulk")]


@pytest.mark.parametrize("op,npart,kernel,schedule", CHAIN)
def test_chain_body_equals_parent_loop_and_reference(models, gvar, op, npart,
                                                     kernel, schedule):
    jm, tm = models(op, npart, kernel)
    st = tm.distribute_state(gvar)
    js = jm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    _close(tm.step(st, schedule), jm.step(js, schedule))
    got = tm.iterate_fn(schedule, STEPS, coupling=C)(*tm.iter_args(st))
    assert torch.equal(st["var_T"], var0)        # the caller's state stays
    assert (got - var0).abs().max() > 1e-3       # the gradients moved it
    assert torch.equal(got, _parent_chain(tm, var0, st["tables"], schedule,
                                          STEPS, C))
    _close(got, _jax_loop(jm, js, schedule, STEPS, C))


SOLVER = [pytest.param("gg", p, k, s, n, id=f"gg-P{p}-{k}-{s}-N{n}")
          for p, s in ((1, "bulk"), (3, "overlap"))
          for k in ("packed", "gather") for n in (1, 2)]
SOLVER += [pytest.param("gg", 3, "gather", "early", 2, id="gg-P3-gather-early-N2"),
           pytest.param("flux", 3, "gather", "bulk", 2,
                        id="flux-P3-gather-bulk-N2")]


@pytest.mark.parametrize("op,npart,kernel,schedule,sweeps", SOLVER)
def test_solver_body_equals_parent_loop_and_reference(models, gvar, op, npart,
                                                      kernel, schedule,
                                                      sweeps):
    jm, tm = models(op, npart, kernel)
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    got = tm.iterate_fn(schedule, STEPS, solver_mode=True,
                        sweeps_per_step=sweeps, coupling=C)(
        *tm.iter_args(st))
    assert torch.equal(st["var_T"], var0)
    assert (got - var0).abs().max() > 1e-3
    assert torch.equal(got, _parent_solver(tm, var0, schedule, STEPS, sweeps,
                                           C))
    _close(got, _jax_loop(jm, jm.distribute_state(gvar), schedule, STEPS, C,
                          sweeps))


# -------------------------------------- the runner's bookkeeping (CPU)

class _StandInGraph:
    """Replays a recorded step on the CPU the way a CUDA graph does: the
    step's work is done on the tensors it was recorded with, and no
    wrapper's Python counts a launch."""

    def __init__(self, step):
        self.step = step
        self.replays = 0

    def pool(self):
        return None

    def replay(self):
        before = compiled.counts()
        self.step()
        compiled._set_counts(before)
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    """The graph primitive on the CPU: recording runs the step's Python
    (so its wrappers count, as under a real capture); the rule says graph
    for every model.  Unlike a capture, recording also computes: graph 0
    rewrites buffer 1 with the value the warm-up step left there, and
    graph 1 writes buffer 0, which the first replay (graph 1) overwrites,
    so the runner's state is as a capture leaves it."""
    graphs = []

    def record(step, pool=None):
        step()
        graphs.append(_StandInGraph(step))
        return graphs[-1]

    monkeypatch.setattr(compiled, "_record", record)
    monkeypatch.setattr(compiled, "_side_stream",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(compiled, "dispatch",
                        lambda model, schedule=None, solver_mode=False:
                        (compiled.GRAPH, compiled.GRAPH_REASON))
    return graphs


def _bump(v, tables=None, out=None):
    """A body whose step 'launches' K1 once and K4 twice."""
    bs.sweep_blocks.launches += 1
    bs.pack_srcs.launches += 2
    return torch.add(v, 1.0, out=out)


def test_counts_recorded_once_and_added_per_replay(stand_in, monkeypatch):
    model = types.SimpleNamespace(device=torch.device("cpu"),
                                  graphs=collections.OrderedDict())
    k1, k4 = bs.sweep_blocks.launches, bs.pack_srcs.launches
    # the counts this test raises go back when it ends: later tests in the
    # process read the counts of a CPU run as none
    monkeypatch.setattr(bs.sweep_blocks, "launches", k1)
    monkeypatch.setattr(bs.pack_srcs, "launches", k4)
    v0 = torch.zeros(4)
    got = compiled.runner(model, _bump, 5, "bump")(v0)
    assert torch.equal(got, torch.full((4,), 5.0))
    assert torch.equal(v0, torch.zeros(4))
    # step 1 eager (counted), the capture taken back, 4 replays added
    assert (bs.sweep_blocks.launches - k1, bs.pack_srcs.launches - k4) == \
        (5, 10)
    entry, = model.graphs.values()
    assert entry.delta == {"sweep_blocks": 1, "pack_srcs": 2}
    # two graphs (buffer 0 → 1, 1 → 0), replayed in turn from buffer 1
    assert [g.replays for g in stand_in] == [2, 2]
    got = compiled.runner(model, _bump, 3, "bump")(v0 + 10)
    assert torch.equal(got, torch.full((4,), 13.0))
    assert (bs.sweep_blocks.launches - k1, bs.pack_srcs.launches - k4) == \
        (8, 16)
    assert len(stand_in) == 2                    # one capture
    assert [g.replays for g in stand_in] == [4, 3]
    assert torch.equal(compiled.runner(model, _bump, 0, "bump")(v0), v0)


def test_captures_counted_once_per_graph(stand_in):
    model = types.SimpleNamespace(device=torch.device("cpu"),
                                  graphs=collections.OrderedDict())
    c0 = compiled.capture.captures
    run = compiled.runner(model, lambda v, out=None: torch.add(v, 1.0,
                                                               out=out),
                          4, "add")
    run(torch.zeros(3))
    run(torch.zeros(3))
    assert compiled.capture.captures - c0 == 2     # two graphs, once
    entry, = model.graphs.values()
    assert "captures" not in entry.delta and entry.timed is None


@pytest.mark.parametrize("graph", [None, False])
def test_runner_prechecks_the_schedule(models, gvar, stand_in, graph):
    _, tm = models("gg", 3, "packed")
    st = tm.distribute_state(gvar, schedules=["bulk"])
    run = tm.iterate_fn("early", 2, graph=graph, coupling=C)
    with pytest.raises(CheckError, match="schedule 'early' needs"):
        run(*tm.iter_args(st))
    assert not tm.graphs
    tm.close()


def _grad_probe(tm, schedule, solver=False):
    """(run, g): a chained body whose step also copies its gradients into
    the static buffer g (its tables rebuilt from v in solver mode), run
    through `compiled.runner` one step at a time: after a replay g holds
    the replayed step's gradients."""
    needed = SCHEDULE_CLASSES[schedule]
    g = torch.empty(tm.nlocal, tm.rows, tm.ndev, dtype=tm.grad_t,
                    device=tm.device)

    def probe(v, tables, out=None):
        gv = tm(v, tm._build_tables(v, needed) if solver else tables,
                schedule)
        g.copy_(gv)
        return torch.add(v, C * gv[:, :NV], out=out)

    return (lambda graph: compiled.runner(tm, probe, 1,
                                          ("probe", schedule, solver, id(g)),
                                          graph=graph)), g


def _replayed_grad(tm, st, schedule, solver=False):
    """One replayed step's gradients and one eager step's, from the probe:
    the first graph call runs step 1 eagerly and captures, the second
    replays graph 0 once (g cleared before it)."""
    run, g = _grad_probe(tm, schedule, solver)
    run(False)(*tm.iter_args(st))
    eager = g.clone()
    graph = run(None)
    graph(*tm.iter_args(st))
    g.zero_()
    graph(*tm.iter_args(st))
    return g.clone(), eager


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_graph_runner_equals_eager_bitwise(models, gvar, stand_in, schedule):
    _, tm = models("gg", 3, "packed")
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    eager = tm.iterate_fn(schedule, 3, graph=False, coupling=C)(
        *tm.iter_args(st))
    graph = tm.iterate_fn(schedule, 3, coupling=C)(*tm.iter_args(st))
    again = tm.iterate_fn(schedule, 3, coupling=C)(*tm.iter_args(st))
    assert (eager - var0).abs().max() > 1e-3
    assert torch.equal(graph, eager) and torch.equal(again, eager)
    assert torch.equal(st["var_T"], var0)
    solver = tm.iterate_fn(schedule, 2, solver_mode=True, sweeps_per_step=2,
                           coupling=C)
    assert torch.equal(solver(*tm.iter_args(st)), tm.iterate_fn(
        schedule, 2, solver_mode=True, sweeps_per_step=2, graph=False,
        coupling=C)(*tm.iter_args(st)))
    for solver_mode in (False, True):
        got, want = _replayed_grad(tm, st, schedule, solver_mode)
        assert torch.equal(got, want)
        assert torch.equal(got, tm.step(st, schedule))
    tm.close()


def test_cache_key_new_tables_capture_anew(models, gvar, stand_in):
    _, tm = models("gg", 3, "gather")
    tm.close()
    st = tm.distribute_state(gvar, schedules=["bulk"])
    run = tm.iterate_fn("bulk", 2, coupling=C)
    run(*tm.iter_args(st))
    tm.iterate_fn("bulk", 5, coupling=C)(*tm.iter_args(st))  # n: not keyed
    assert len(tm.graphs) == 1
    st2 = tm.refresh_state(st["var_T"] * 1.5, schedules=["bulk"])
    got = run(*tm.iter_args(st2))
    assert len(tm.graphs) == 2
    assert torch.equal(got, tm.iterate_fn("bulk", 2, graph=False,
                                          coupling=C)(*tm.iter_args(st2)))
    # a replay after refresh_state reads the new tables
    g1, _ = _replayed_grad(tm, st, "bulk")
    g2, want = _replayed_grad(tm, st2, "bulk")
    assert torch.equal(g2, want) and not torch.equal(g1, g2)
    tm.iterate_fn("early", 2)(*tm.iter_args(tm.distribute_state(gvar)))
    assert len(tm.graphs) == 5
    # the solver body reads no table: a new tables dict is the same graph
    solver = tm.iterate_fn("bulk", 2, solver_mode=True)
    solver(*tm.iter_args(st))
    solver(*tm.iter_args(st2))
    assert len(tm.graphs) == 6
    tm.close()
    assert not tm.graphs


def test_ell_model_takes_the_runner(mesh, gvar, stand_in):
    parts = partition_mesh(mesh, 3, ghost_layers=1)
    m = GreenGaussModel(parts, NVAR, dtype=torch.float64, device="cpu")
    st = m.distribute_state(gvar)
    graph = m.iterate_fn("early", 3, exact=True, coupling=C)(
        *m.iter_args(st))
    eager = m.iterate_fn("early", 3, exact=True, graph=False, coupling=C)(
        *m.iter_args(st))
    assert (eager - m.iter_args(st)[0]).abs().max() > 1e-3
    assert torch.equal(graph, eager) and len(m.graphs) == 1
    m.close()
    assert not m.graphs


# ------------------------------------------------------------ on the card

GOLDEN_TOL = 1e-5    # a step against the f64 golden (the reference's gate)
PORT_KERNEL = re.compile(r"\b(?:sweep|pack|chain)_\w*kernel\b")  # csrc's


@pytest.fixture(scope="module")
def cuda_models(mesh, gvar):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have "
                    "no CPU mode)")
    parts = partition_mesh(mesh, 3, ghost_layers=1)
    return {k: GreenGaussTorch(parts, NVAR, bp=BP, kernel=k,
                               device=torch.device("cuda", 0))
            for k in ("packed", "gather")}


def _golden_relmax(tm, g, mesh, gvar):
    from cfd_proxy_tpu_torch.solver import golden

    want = golden("gg", mesh, gvar)
    return np.abs(tm.gather_global(g) - want).max() / max(
        1.0, np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["packed", "gather"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_cuda_graph_equals_eager_bitwise(cuda_models, mesh, gvar, kernel,
                                         schedule):
    tm = cuda_models[kernel]
    assert compiled.dispatch(tm)[0] == "graph"
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    for solver in (False, True):
        eager = tm.iterate_fn(schedule, 5, solver, graph=False, coupling=C)(
            *tm.iter_args(st))
        graph = tm.iterate_fn(schedule, 5, solver, coupling=C)(
            *tm.iter_args(st))
        again = tm.iterate_fn(schedule, 5, solver, coupling=C)(
            *tm.iter_args(st))
        torch.cuda.synchronize()
        assert (eager - var0).abs().max() > 1e-3
        assert torch.equal(graph, eager) and torch.equal(again, eager)
        # what a replay launches: the port's kernels among the captured
        # graph's kernel nodes, one per launch the runner adds
        entry = next(reversed(tm.graphs.values()))
        nodes = [compiled.kernel_nodes(g) for g in entry.graphs]
        ours = [k for k in nodes[0] if PORT_KERNEL.search(k)]
        assert sorted(nodes[0]) == sorted(nodes[1])
        launches = compiled.launch_counters()
        assert len(ours) == sum(d for k, d in entry.delta.items()
                                if k in launches) > 0
        got, want = _replayed_grad(tm, st, schedule, solver)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert _golden_relmax(tm, got, mesh, gvar) < GOLDEN_TOL
    tm.close()


@pytest.mark.cuda
def test_cuda_recapture_after_refresh_state(cuda_models, mesh, gvar):
    tm = cuda_models["gather"]
    tm.close()
    st = tm.distribute_state(gvar, schedules=["bulk"])
    tm.iterate_fn("bulk", 3, coupling=C)(*tm.iter_args(st))
    st2 = tm.refresh_state(st["var_T"] * 1.5, schedules=["bulk"])
    got = tm.iterate_fn("bulk", 3, coupling=C)(*tm.iter_args(st2))
    assert len(tm.graphs) == 2
    want = tm.iterate_fn("bulk", 3, graph=False, coupling=C)(
        *tm.iter_args(st2))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # a replay after refresh_state reads the new tables: the gradients of
    # 1.5 × the state
    g1, _ = _replayed_grad(tm, st, "bulk")
    g2, want2 = _replayed_grad(tm, st2, "bulk")
    torch.cuda.synchronize()
    assert torch.equal(g2, want2) and not torch.equal(g1, g2)
    assert _golden_relmax(tm, g2, mesh, 1.5 * gvar) < GOLDEN_TOL
    tm.close()
