"""The benchmark's reading of the port's spans and counters: the idle split
by host span (`cfdbench/idle.py`), the span metrics' readers
(`cfdbench/metrics/<name>.py`) and the traced run with the recorder on
(`cfdbench/spans.py`), on the CPU.  The benchmark's own tests are in
`cfdbench/tests`."""

import pytest

from cfdbench import cell, idle
from cfdbench import spans as spanrun

METRICS = ("exchange_glue_ms", "rebuild_ms", "halo_live_pct",
           "idle_in_runner_ms")
PROBLEM = {"faces": 1, "points": 1, "nvar": 7, "chips": 1, "kind": "cpu"}

# a report interval's turnaround: the last kernel ends at 10 while the host
# waits in the synchronise, the next starts at 30 after the runner's lookup
DEVICE = [(0.0, 10.0, "sweep_packed_kernel"), (30.0, 40.0, "chain_update")]
HOST = [(0.0, 16.0, "cfdbench.synchronize"),
        (5.0, 15.0, "cudaDeviceSynchronize"),
        (17.0, 41.0, "cfdbench.launch_interval"),
        (18.0, 35.0, "cfd.runner"), (20.0, 26.0, "cfd.runner.lookup"),
        (27.0, 33.0, "cfd.runner.replay"), (28.0, 29.0, "cudaGraphLaunch"),
        (36.0, 38.0, "cfd.runner.copy_out")]


@pytest.mark.parametrize("lo,hi,innermost,within,turn", [
    # the gap [10, 30) split where the host was: not all to the
    # synchronise, where it began
    (0.0, 40.0,
     {"cudaDeviceSynchronize": 5.0, "cfdbench.synchronize": 1.0,
      idle.NONE: 1.0, "cfdbench.launch_interval": 1.0, "cfd.runner": 3.0,
      "cfd.runner.lookup": 6.0, "cfd.runner.replay": 2.0,
      "cudaGraphLaunch": 1.0},
     {"cfdbench.synchronize": 6.0, "cfdbench.launch_interval": 13.0,
      "cfd.runner": 12.0, "cfd.runner.lookup": 6.0,
      "cfd.runner.replay": 3.0, "cfd.runner.copy_out": 0.0}, True),
    # a stretch cut inside the gap, and one after the last kernel
    (12.0, 25.0,
     {"cudaDeviceSynchronize": 3.0, "cfdbench.synchronize": 1.0,
      idle.NONE: 1.0, "cfdbench.launch_interval": 1.0, "cfd.runner": 2.0,
      "cfd.runner.lookup": 5.0},
     {"cfdbench.synchronize": 4.0, "cfdbench.launch_interval": 8.0,
      "cfd.runner": 7.0, "cfd.runner.lookup": 5.0}, True),
    (30.0, 44.0,
     {"cfdbench.launch_interval": 1.0, idle.NONE: 3.0},
     {"cfdbench.launch_interval": 1.0, "cfd.runner": 0.0,
      "cfd.runner.replay": 0.0, "cfd.runner.copy_out": 0.0}, False),
])
def test_idle_split_by_covering_host_span(lo, hi, innermost, within, turn):
    got = idle.split(DEVICE, HOST, lo, hi)
    # the gap [10, 30) holds the launch of the next interval (at 17): the
    # turnaround; the gap after the last kernel does not
    assert got == {"innermost": innermost, "within": within,
                   "turnaround": innermost if turn else {}}
    # every idle microsecond is put down once
    busy = sum(min(b, hi) - max(a, lo) for a, b, _ in DEVICE
               if lo <= a < hi)
    assert sum(got["innermost"].values()) == pytest.approx(hi - lo - busy)


def test_idle_turnaround_leaves_the_gaps_inside_intervals():
    # a gap between two kernels of an interval, the host in the synchronise
    device = [(0.0, 10.0, "k"), (12.0, 16.0, "k"), (30.0, 40.0, "k")]
    got = idle.split(device, HOST, 0.0, 40.0)
    assert got["innermost"]["cudaDeviceSynchronize"] == 2.0     # [10, 12)
    assert "cudaDeviceSynchronize" not in got["turnaround"]
    assert got["turnaround"] == {idle.NONE: 1.0,
                                 "cfdbench.launch_interval": 1.0,
                                 "cfd.runner": 3.0, "cfd.runner.lookup": 6.0,
                                 "cfd.runner.replay": 2.0,
                                 "cudaGraphLaunch": 1.0}    # [16, 30)


def test_idle_combine_per_interval_highest_rank():
    ranks = [{"intervals": 2, "idle_by_host": idle.split(DEVICE, HOST,
                                                         0.0, 40.0)},
             {"intervals": 4, "idle_by_host": {
                 "innermost": {"cudaDeviceSynchronize": 40.0},
                 "within": {"cfd.runner": 4.0}, "turnaround": {}}}]
    got = idle.combine(ranks)
    assert got["innermost"][0] == ["cudaDeviceSynchronize", 0.01]
    assert dict(got["within"])["cfd.runner"] == 0.006


def _summary(**extra):
    """A rank's trace summary (cfdbench/trace.py) of 4 steps, 2 intervals."""
    s = {"steps": 4, "stretch_us": 100.0, "busy_us": 80.0,
         "ops": {"sweep_packed_kernel": [4, 60.0],
                 "Memcpy DtoD (Device -> Device)": [2, 4.0]},
         "gaps": [], "counted": {"sweep": 4}}
    s.update(extra)
    return s


@pytest.mark.parametrize("name", METRICS)
def test_readers_none_without_spans(name):
    read = cell.metric_reader(name)
    assert read([_summary()], PROBLEM) is None
    assert read([_summary(), _summary()], PROBLEM) is None


def _spans(steps, counters=None, **ms):
    return {"spans": {"cfd." + k.replace("_", ".", 1) if k.startswith(
        "sweep_") else "cfd." + k: [steps, v] for k, v in ms.items()},
            "steps": steps, "counters": counters or {}}


@pytest.mark.parametrize("name,ranks,want", [
    ("exchange_glue_ms",
     [_spans(2, pack=0.1, recv_fill=0.02, unpack=0.06, sweep_interior=0.5),
      _spans(2, pack=0.2, unpack=0.06)], 0.13),
    ("exchange_glue_ms", [_spans(2, sweep_bulk=0.3, update=0.05)], None),
    ("rebuild_ms", [_spans(4, rebuild=0.12, var_exchange=0.02,
                           sweep_bulk=0.4)], 0.035),
    ("rebuild_ms", [_spans(0)], None),
    ("halo_live_pct",
     [_spans(2, counters={"halo_bytes": 400, "halo_live_bytes": 30}),
      _spans(2, counters={"halo_bytes": 600, "halo_live_bytes": 70})],
     10.0),
    ("halo_live_pct", [_spans(2, counters={"halo_bytes": 0,
                                           "halo_live_bytes": 0})], None),
])
def test_span_readers(name, ranks, want):
    got = cell.metric_reader(name)([_summary(spans=r) for r in ranks],
                                   PROBLEM)
    assert got == (want if want is None else pytest.approx(want))


def test_idle_in_runner_reader_per_interval():
    by = idle.split(DEVICE, HOST, 0.0, 40.0)
    read = cell.metric_reader("idle_in_runner_ms")
    assert read([_summary(idle_by_host=by, intervals=2)], PROBLEM) == \
        pytest.approx(0.006)
    no_runner = idle.split(DEVICE, HOST[:3], 0.0, 40.0)
    assert read([_summary(idle_by_host=no_runner, intervals=2)],
                PROBLEM) is None


def test_consistency_of_spans_and_copies_with_busy():
    s = _summary(spans=_spans(2, sweep_bulk=0.036, update=0.002))
    assert spanrun.consistency(s) == pytest.approx((20.0, 20.0))
    assert spanrun.consistency(_summary()) is None


def test_traced_run_with_the_recorder_on_the_cpu():
    """The additions laid over a small CPU run of the eight-shard cell: the
    summary's spans, counters and idle split reach the result line, the
    pack's live share is the plan's, and the harness is as it was after."""
    import numpy as np

    from cfdbench import trace
    from cfdbench.tests.conftest import small_spec
    from cfd_proxy_tpu_torch.mesh.generator import GlobalMesh
    from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
    from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch

    from cfdbench import run

    harness = (cell._sync, cell._launch_counts, trace.from_profiler)
    c, spec = small_spec("gg96.p8.overlap", nx=6, trace=True, seconds=0.1)
    with spanrun.laid_over(spec, True):
        ranks = run.run_spec(spec, spec["t0"])
    assert (cell._sync, cell._launch_counts, trace.from_profiler) == harness
    out, info = spanrun.report(c, ranks, None)
    s = ranks[0]["trace"]
    assert s["intervals"] * c["traffic"]["steps_per_interval"] == s["steps"]
    assert s["spans"]["steps"] == 0     # no device spans on the CPU
    assert "cfd.runner" in s["idle_by_host"]["within"]
    # the live share of the plan the run built
    from cfdbench import meshgen

    g = spec["config"]["mesh"]
    mesh = meshgen.generate(g["nx"], g["ny"], g["nz"], jitter=g["jitter"],
                            diag_frac=g["diag_frac"], seed=g["seed"])
    parts = partition_mesh(GlobalMesh(coords=mesh.coords, faces=mesh.faces,
                                      normals=mesh.normals,
                                      volume=mesh.volume), 8, ghost_layers=1)
    model = GreenGaussTorch(parts, spec["config"]["nvar"], device="cpu")
    share = 100.0 * model.live_cols / np.prod(model.send_mask.shape)
    assert out["metrics"]["halo_live_pct"]["value"] == pytest.approx(share)
    assert out["counters"]["halo_bytes"] == \
        model.send_mask.numel() * model.rows * 4
    assert "exchange_glue_ms" not in out["metrics"]
    assert "idle_in_runner_ms" in out["metrics"]
