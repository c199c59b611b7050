"""The port's span recorder (utils/spans.py) and counters (models/compiled.py
`counters`).

On the CPU:

- off, `span()` and `step()` are the one shared no-op, and an eager step's
  outputs and counts are those of a step with the recorder on (which adds
  host ranges only on the CPU), with no cfd.* range in a profiler trace;
- on, the cfd.* host ranges of an eager P=2 step appear in a
  `torch.profiler` trace, nested under the runner's span (the var
  exchange's pack and unpack under cfd.var_exchange, the sweeps and the
  update under cfd.runner);
- the pack's `halo_bytes` and `halo_live_bytes` per step are the plan's
  s_max and send_mask arithmetic, for each exchange a step runs;
- a step's device spans read as self times: a child's range leaves its
  parent's, abutting spans share their boundary (stand-in events).

On the card (`cuda` marker; skipped here; no JAX imported, so `python -m
pytest --noconftest tests/test_torch_spans.py -m cuda` runs there): a
captured one-shard step with the recorder on replays, its device spans per
step within 5 % of CUDA-event timing of the same step's replays; the graphs
captured with it off, those the runner replays with it on, and the timed
twins hold the same kernel nodes, and only the twins event nodes.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops.plan import NV
from cfd_proxy_tpu_torch.utils import spans

torch.set_num_threads(1)

NVAR = 5
C = 0.1              # a coupling at which the state carries the gradients
SCHEDULES = ("bulk", "early", "overlap", "nocomm")


@pytest.fixture(scope="module")
def p2():
    mesh = generate_mesh(8, 7, 6, jitter=0.05, diag_frac=0.25, seed=3)
    gvar = make_state(mesh.npoint, NVAR, seed=1)
    parts = partition_mesh(mesh, 2, ghost_layers=1)
    model = {h: GreenGaussTorch(parts, NVAR, bp=128, device="cpu",
                                halo_dtype=h)
             for h in ("float32", "bfloat16")}
    return model, gvar


@pytest.fixture
def recorder():
    """The recorder as a test leaves it: off and empty."""
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


def _run(model, st, schedule, solver, n=2):
    c0 = compiled.counts()
    v = model.iterate_fn(schedule, n, solver, coupling=C)(
        *model.iter_args(st))
    c1 = compiled.counts()
    return v, {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}


def test_off_span_is_the_shared_noop(recorder):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    got = {recorder.span("pack"), recorder.span("pack", cpu),
           recorder.span("sweep.bulk", cuda), recorder.span("a", leaf=True),
           recorder.step()}
    assert got == {recorder.NOOP}
    with recorder.step() as st:
        assert st is None
    recorder.read()
    assert recorder.totals()["spans"] == {} and \
        recorder.totals()["steps"] == 0


@pytest.mark.parametrize("solver", [False, True])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_off_and_on_steps_equal(p2, recorder, schedule, solver):
    model, gvar = p2[0]["float32"], p2[1]
    st = model.distribute_state(gvar)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off, counts_off = _run(model, st, schedule, solver)
    assert not [e for e in prof.events() if e.name.startswith("cfd.")]
    recorder.enable()
    on, counts_on = _run(model, st, schedule, solver)
    assert torch.equal(on, off) and counts_on == counts_off
    assert (on - st["var_T"]).abs().max() > 1e-3


def _parents(e) -> list:
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


# schedule → the step's spans in order (a P=2 step on one process: loopback,
# the fused kernel's plain version for overlap)
STEP_SPANS = {
    "bulk": ["sweep.bulk", "pack", "exchange", "unpack", "update"],
    "early": ["sweep.boundary", "pack", "exchange", "sweep.interior",
              "unpack", "update"],
    "overlap": ["sweep.boundary", "pack", "sweep.interior", "unpack",
                "update"],
    "nocomm": ["sweep.bulk", "update"],
}


@pytest.mark.parametrize("solver", [False, True])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_host_spans_nest_in_a_profiler_trace(p2, recorder, schedule,
                                             solver):
    model, gvar = p2[0]["float32"], p2[1]
    st = model.distribute_state(gvar)
    recorder.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(model, st, schedule, solver, n=1)
    ours = [e for e in sorted(prof.events(), key=lambda e:
                              e.time_range.start)
            if e.name.startswith("cfd.")]
    want = ["runner"] + ["rebuild"] * solver + STEP_SPANS[schedule] + \
        ["var_exchange", "pack", "exchange", "unpack"] * solver
    assert [e.name for e in ours] == ["cfd." + n for n in want]
    for e in ours[1:]:
        up = [n for n in _parents(e) if n.startswith("cfd.")]
        assert up[-1] == "cfd.runner"
        inside_var = e.time_range.start >= next(
            (x.time_range.start for x in ours
             if x.name == "cfd.var_exchange"), float("inf"))
        assert up[:-1] == (["cfd.var_exchange"] if inside_var
                           and e.name != "cfd.var_exchange" else [])


@pytest.mark.parametrize("halo", ["float32", "bfloat16"])
@pytest.mark.parametrize("solver", [False, True])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_halo_counters_match_the_plan(p2, schedule, solver, halo):
    model, gvar = p2[0][halo], p2[1]
    n = 2
    _, counts = _run(model, model.distribute_state(gvar), schedule, solver,
                     n=n)
    live = int(np.count_nonzero(model.send_mask.numpy()))
    assert live == model.live_cols > 0
    padded = model.nlocal * model.nphases * model.s_max
    # the gradient exchange: 3·NV rows in the halo dtype; the var
    # exchange (solver mode): NV rows in f32
    esize = 2 if halo == "bfloat16" else 4
    packs = [(model.rows, esize)] * (schedule != "nocomm") + \
        [(NV, 4)] * solver
    want = {"halo_bytes": n * sum(padded * r * s for r, s in packs),
            "halo_live_bytes": n * sum(live * r * s for r, s in packs)}
    assert {k: counts.get(k, 0) for k in want} == want
    assert model.rows == 3 * NV


class _Event:
    """A stand-in timing event at a time (ms) on a made-up timeline."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_self_times_leave_children_and_share_boundaries():
    st = spans._Step()
    st.events = [_Event(t) for t in (0.0, 1.0, 1.5, 1.75, 4.0, 5.0)]
    # boundary | interior (recv_fill inside it) | update, abutting
    st.spans = [("cfd.sweep.boundary", 0, 1, -1),
                ("cfd.sweep.interior", 1, 4, -1),
                ("cfd.recv_fill", 2, 3, 1),
                ("cfd.update", 4, 5, -1)]
    assert st.self_ms() == [("cfd.sweep.boundary", 1.0),
                            ("cfd.sweep.interior", 2.75),
                            ("cfd.recv_fill", 0.25), ("cfd.update", 1.0)]


def test_read_totals_and_since(recorder):
    st = spans._Step()
    st.events = [_Event(0.0), _Event(2.0)]
    st.spans = [("cfd.pack", 0, 1, -1)]
    recorder.enable()
    before = recorder.totals()
    recorder.replayed([st, None])
    recorder.replayed([st])             # marked once however often
    recorder.read(7)
    after = recorder.totals()
    assert after["spans"] == {"cfd.pack": [1, 2.0]} and after["steps"] == 1
    assert recorder.samples() == [(7, "cfd.pack", 2.0)]
    recorder.read()                     # nothing marked since
    got = recorder.since(before, recorder.totals())
    assert got["spans"] == {"cfd.pack": [1, 2.0]} and got["steps"] == 1
    assert set(got["counters"]) == set(compiled.counters())


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_cuda_span_totals_agree_with_event_timing(recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have "
                    "no CPU mode)")
    dev = torch.device("cuda", 0)
    # the benchmark's one-card mesh: a step long beside the few us between
    # two graph launches, which the replays' timing holds and no span does
    mesh = generate_mesh(96, 96, 96, jitter=0.05, diag_frac=0.2, seed=0)
    gvar = make_state(mesh.npoint, 7, seed=5)
    parts = partition_mesh(mesh, 1, ghost_layers=1)
    model = GreenGaussTorch(parts, 7, device=dev)
    st = model.distribute_state(gvar, schedules=["bulk"])
    entries = {}
    for on in (False, True):
        (recorder.enable if on else recorder.disable)()
        model.close()
        model.iterate_fn("bulk", 2)(*model.iter_args(st))
        entries[on] = next(iter(model.graphs.values()))
    off, on = entries[False], entries[True]
    assert off.timed is None and len(on.timed) == 2
    for g_off, g_on, (g_timed, _) in zip(off.graphs, on.graphs, on.timed):
        nodes = compiled.kernel_nodes(g_off)
        assert compiled.kernel_nodes(g_on) == nodes
        assert compiled.kernel_nodes(g_timed) == nodes
        assert compiled.event_nodes(g_off) == compiled.event_nodes(g_on) == 0
        assert compiled.event_nodes(g_timed) == 3   # sweep | update, abutting
    assert off.delta == on.delta
    # the step timed by events around the replays of its graphs (the first
    # replay keeps the card busy while the host queues the rest); its spans
    # read from the timed twins, replayed last as the runner does
    reps = 200
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    recorder.read()
    on.graphs[0].replay()
    t0.record()
    for i in range(reps):
        on.graphs[i % 2].replay()
    t1.record()
    for g, _ in on.timed:
        g.replay()
    torch.cuda.synchronize()
    recorder.replayed(s for _, s in on.timed)
    before = recorder.totals()
    recorder.read()
    got = recorder.since(before, recorder.totals())
    assert got["steps"] == 2
    assert set(got["spans"]) == {"cfd.sweep.bulk", "cfd.update"}
    per_step = sum(ms for _, ms in got["spans"].values()) / got["steps"]
    timed = t0.elapsed_time(t1) / reps
    assert abs(per_step / timed - 1) < 0.05, (per_step, timed)
    model.close()
