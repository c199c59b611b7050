"""The peer kernels' wait counters (csrc/push_common.cuh `spin_until`): the
four device words after the launch epochs (`parallel/transport.py`
`peer_layout`, `WAIT_COUNTERS`), their host copies among the port's
counters (`spans.read()`, `compiled.counters()`), and the benchmark's
readers of the cross-card wait (`cfdbench/metrics/interior_rank_spread_pct.py`,
`peer_wait_pct.py`, fed by `cfdbench/spans_ranks.py`) with the four-card
cell that reports them.

On the CPU: the layout's words, the counters at 0 where no `Peer` exists,
the host copy's arithmetic on stand-in words, both readers on hand-made
per-rank summaries, the cell's entry and the benchmark's share of
four-chip cells.

On the card (`cuda` marker; skipped here; no JAX imported, so `python -m
pytest --noconftest tests/test_torch_peer_wait.py -m cuda` runs there):
the overlap step through the peer transport in one process at P=2, bit for
bit the loopback step, with waits forced late on a side stream: the
counters grow, and never count more waits than the launches made.
"""

import json
import os

import pytest
import torch

from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.parallel import transport
from cfd_proxy_tpu_torch.parallel.transport import (WAIT_COUNTERS, Peer,
                                                    peer_layout)
from cfd_proxy_tpu_torch.utils import spans
from cfdbench import cell

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "gg152.w4.overlap"
SPREAD, WAIT = "interior_rank_spread_pct", "peer_wait_pct"


@pytest.fixture
def recorder():
    """The recorder as a test leaves it: off and empty."""
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("nlocal,nph,seg", [(1, 1, 16), (1, 6, 9728),
                                             (2, 2, 4096), (4, 6, 4864),
                                             (8, 6, 116736), (3, 5, 48)])
def test_peer_layout_wait_words(nlocal, nph, seg):
    """The four wait words follow the two epochs, 8-byte aligned, and end
    the block, which grows by their 32 bytes: ready, arrive, done and the
    epochs stay where they were (PeerPush::epochs + 2 in push_common.cuh)."""
    npk = nlocal * nph
    lay = peer_layout(nlocal, nph, seg)
    was = lay["flags"] + 16 * npk + 24          # the block without them
    assert lay["epochs"] == lay["flags"] + 8 * (2 * npk + 1)
    assert lay["waits"] == lay["epochs"] + 16 == was
    assert lay["waits"] % 8 == 0 and lay["bytes"] % 8 == 0
    assert lay["bytes"] == was + 32 == lay["waits"] + 8 * len(WAIT_COUNTERS)
    # no overlap with done or the epochs
    assert lay["done"] + 8 <= lay["epochs"]
    assert lay["epochs"] + 16 <= lay["waits"]
    block = torch.zeros(lay["bytes"], dtype=torch.uint8)
    words = block[lay["waits"]:lay["bytes"]].view(torch.int64)
    words[:] = torch.tensor([5, 1, 7, 2])
    assert words.shape == (4,)
    assert block[:lay["waits"]].count_nonzero() == 0


# ----------------------------------------------------------- the counters

def test_wait_counters_are_port_counters():
    reg = compiled.counters()
    for k in WAIT_COUNTERS:
        assert reg[k] == (transport.read_waits, k)
    assert set(transport.wait_counters()) == set(WAIT_COUNTERS)


def test_totals_list_the_wait_counters_at_zero_on_a_loopback_run(recorder):
    """A loopback P=2 chain on the CPU with the recorder on: no Peer exists,
    so `read()` copies nothing and the four counters read 0."""
    from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
    from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
    from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch

    mesh = generate_mesh(6, 5, 5, jitter=0.05, diag_frac=0.2, seed=4)
    parts = partition_mesh(mesh, 2, ghost_layers=1)
    model = GreenGaussTorch(parts, 3, bp=128, device="cpu")
    st = model.distribute_state(make_state(mesh.npoint, 3, seed=2))
    recorder.enable()
    before = recorder.totals()
    model.iterate_fn("overlap", 2, coupling=0.1)(*model.iter_args(st))
    recorder.read()
    after = recorder.totals()
    assert model.peer is None and model.transport_name == "loopback"
    for k in WAIT_COUNTERS:
        assert after["counters"][k] == 0
    got = recorder.since(before, after)["counters"]
    assert all(got[k] == 0 for k in WAIT_COUNTERS)


class _Words:
    """A stand-in transport: `Peer`'s host copy over CPU words."""

    _read_waits = Peer._read_waits

    def __init__(self):
        self.wait_words = torch.zeros(len(WAIT_COUNTERS), dtype=torch.int64)
        self._waits_read = [0] * len(WAIT_COUNTERS)


@pytest.fixture
def words(monkeypatch):
    for k in WAIT_COUNTERS:
        monkeypatch.setattr(transport.read_waits, k, 0)
    w = _Words()
    transport._open_peers.add(w)
    yield w
    transport._open_peers.discard(w)


def test_read_waits_adds_what_the_words_grew_by(words):
    counts = lambda: [getattr(transport.read_waits, k)  # noqa: E731
                      for k in WAIT_COUNTERS]
    words.wait_words += torch.tensor([900, 3, 40, 1])
    transport.read_waits()
    assert counts() == [900, 3, 40, 1]
    transport.read_waits()                  # nothing grew since
    assert counts() == [900, 3, 40, 1]
    words.wait_words += torch.tensor([100, 1, 0, 0])
    transport.read_waits()
    assert counts() == [1000, 4, 40, 1]
    # a closed transport leaves what was read counted
    words.wait_words = None
    transport.read_waits()
    assert counts() == [1000, 4, 40, 1]


def test_read_copies_the_words_only_while_the_recorder_is_on(words,
                                                             recorder):
    words.wait_words += torch.tensor([50, 2, 0, 0])
    recorder.read()
    assert recorder.totals()["counters"]["peer_wait_barrier_ns"] == 0
    recorder.enable()
    recorder.read()
    got = recorder.totals()["counters"]
    assert [got[k] for k in WAIT_COUNTERS] == [50, 2, 0, 0]


def test_solver_profile_reports_the_wait_counters(capsys, tmp_path):
    """`solver.py --profile`: the result's counters hold the four wait
    counters (0 through loopback) beside the counters that moved, and the
    text form prints a `counter` line each."""
    from cfd_proxy_tpu_torch import solver

    argv = ["--nx", "8", "--ny", "8", "--nz", "7", "--device", "cpu",
            "--iters", "2", "--parts", "2", "--schedule", "overlap",
            "--profile", str(tmp_path / "prof")]
    assert solver.main([*argv, "--json"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: d["counters"][k] for k in WAIT_COUNTERS} == \
        dict.fromkeys(WAIT_COUNTERS, 0)
    assert d["counters"]["halo_bytes"] > 0
    assert not spans.enabled()
    assert solver.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    for k in WAIT_COUNTERS:
        assert f"counter {k} = 0" in lines


# ------------------------------------------------------------ the readers

PROBLEM = {"faces": 1, "points": 1, "nvar": 7, "chips": 4, "kind": "cpu"}
K3_PEER = ("void (anonymous namespace)::sweep_overlap_peer_kernel<(cfd::Op)0,"
           " cfd::PackedSrc<float, float>, float>(")


def _rank(k3_us, steps=100, other_us=50.0, spans_=None):
    ops = {"void (anonymous namespace)::sweep_packed_kernel<true>(":
           [steps, other_us * steps]}
    if k3_us is not None:
        ops[K3_PEER] = [steps, k3_us * steps]
    r = {"steps": steps, "ops": ops}
    if spans_ is not None:
        r["spans"] = spans_
    return r


@pytest.mark.parametrize("k3,want", [
    ((200.0, 180.0), 10.0),
    ((250.0, 240.0, 200.0, 225.0), 20.0),
    ((300.0, 300.0, 300.0, 300.0), 0.0),
])
def test_interior_rank_spread_by_hand(k3, want):
    got = cell.metric_reader(SPREAD)([_rank(u) for u in k3], PROBLEM)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("ranks", [
    [_rank(200.0)],                         # one rank
    [_rank(None), _rank(None)],             # no sweep_overlap record
    [_rank(None), _rank(200.0)],            # one rank has one
    [],
])
def test_interior_rank_spread_is_none_without_two_ranks_of_records(ranks):
    assert cell.metric_reader(SPREAD)(ranks, PROBLEM) is None


def _spans(interior_ms, read_steps, **counters):
    c = {k: 0 for k in WAIT_COUNTERS}
    c.update(counters)
    return {"spans": {"cfd.sweep.interior": [read_steps, interior_ms]},
            "steps": read_steps, "counters": c}


def test_peer_wait_pct_by_hand():
    """Rank 1 waits most: 5 us of arrival a step (500 us over 100 steps)
    against an interior of 0.3 ms a step (0.6 ms over 2 steps read): about
    1.67 %.  The readiness waits are left out, however long."""
    quiet = _spans(0.6, 2, peer_wait_barrier_ns=9_000_000,
                   peer_waits_barrier=900, peer_wait_arrive_ns=100_000,
                   peer_waits_arrive=10)
    busy = _spans(0.6, 2, peer_wait_barrier_ns=400_000, peer_waits_barrier=40,
                  peer_wait_arrive_ns=500_000, peer_waits_arrive=90)
    ranks = [_rank(300.0, spans_=quiet), _rank(300.0, spans_=busy),
             _rank(300.0, spans_=_spans(0.6, 2))]
    got = cell.metric_reader(WAIT)(ranks, PROBLEM)
    assert got == pytest.approx(100 * 5_000 / 300_000)
    # no wait at all reads 0, a share and not a missing number
    assert cell.metric_reader(WAIT)([_rank(300.0, spans_=_spans(0.6, 2))],
                                    PROBLEM) == 0.0


@pytest.mark.parametrize("ranks", [
    [_rank(300.0), _rank(300.0)],           # no spans (cfdbench.run)
    [_rank(300.0, spans_={"spans": {"cfd.sweep.interior": [2, 0.6]},
                          "steps": 2, "counters": {"halo_bytes": 8}})],
    [_rank(300.0, spans_={"spans": {}, "steps": 2,
                          "counters": {k: 1 for k in WAIT_COUNTERS}})],
])
def test_peer_wait_pct_is_none_without_its_counters_or_span(ranks):
    assert cell.metric_reader(WAIT)(ranks, PROBLEM) is None


# -------------------------------------------------------------- the cell

def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_four_card_cell_resolves_to_four_chips_and_ranks():
    c = cell.find_cell(CELL)
    assert c["chips"] == 4 and c["traffic"]["ranks"] == 4
    assert c["traffic"]["shards"] == 4
    assert c["traffic"]["transport"] == "peer"
    assert c["traffic"]["schedule"] == "overlap"
    assert c["config"]["mesh"]["nx"] == 152
    assert SPREAD in c["per_layer"]
    others = [w["name"] for w in _bench()["workloads"] if w["name"] != CELL]
    assert others
    for name in others:
        assert SPREAD not in cell.find_cell(name)["per_layer"]


def test_spans_ranks_feeds_the_wait_reader_from_every_rank():
    """`cfdbench.spans_ranks` on the four-card cell at 10³ on four CPU
    processes (the peer transport runs as dist): the recorder runs inside
    each rank, so every rank's summary holds the recorder's totals with the
    four wait counters (0: no `Peer`), which `cfdbench.spans` leaves out
    of a spawned rank.  The CPU records no device span, so `peer_wait_pct`
    finds no interior to divide by and is left out of the line."""
    from cfdbench import spans_ranks
    from cfdbench.tests.conftest import small_spec

    c, spec = small_spec(CELL, nx=10, trace=True)
    ranks = spans_ranks.run_ranks(spec, spec["t0"])
    assert len(ranks) == 4
    for r in ranks:
        sp = r["trace"]["spans"]
        assert sp["steps"] == 0             # no device spans on the CPU
        assert all(sp["counters"][k] == 0 for k in WAIT_COUNTERS)
        assert sp["counters"]["halo_bytes"] > 0
    out, _ = spans_ranks.report(c, ranks, None)
    assert out["correct"], out["checks"]
    assert WAIT not in out["metrics"] and SPREAD not in out["metrics"]
    assert out["waits"] == [dict.fromkeys(WAIT_COUNTERS, 0.0)] * 4
    assert out["counters"]["halo_bytes"] > 0


def test_the_four_card_configuration_is_a_deployment_of_its_own():
    """`gg152` shares its upstream repository and its cut with `gg96`, so
    its source names the part of the repository that defines it: no other
    configuration has the same source and reduced keys, and its file is no
    other configuration's."""
    confs = _bench()["configs"]
    mine = [c for c in confs if c["name"] == "gg152"]
    assert len(mine) == 1
    ours = mine[0]
    assert ours["source"].startswith(
        "https://github.com/PGAS-community-benchmarks/CFD-Proxy")
    assert len(ours["source"]) <= 200 and "\n" not in ours["source"] \
        and "\t" not in ours["source"]
    for c in confs:
        if c is not ours:
            assert (c["source"], sorted(c["reduced"])) != \
                (ours["source"], sorted(ours["reduced"])), c["name"]
            assert c["file"] != ours["file"]


def test_the_wait_reader_is_a_file_and_no_entry():
    bench = _bench()
    assert WAIT not in {m["name"] for m in bench["per_layer"]}
    assert os.path.exists(os.path.join(cell.HERE, "metrics", WAIT + ".py"))


def test_at_most_a_quarter_of_the_cells_ask_for_four_chips():
    cells = _bench()["workloads"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), four
    assert {w["chips"] for w in cells} <= {1, 4}


# ------------------------------------------------------------ on the card

def _late(peer, word: str, add: int, cycles: int = 20_000_000):
    """On a side stream, after a sleep of `cycles` (about 10 ms, longer
    than the host takes to enqueue a step), add `add` to every local `word`
    ("ready" or "arrive") of the peer's block: a signal that comes late, as
    from a slower peer."""
    lay = peer_layout(peer.shape[0], peer.nph, peer.seg_bytes)
    npk = peer.shape[0] * peer.nph
    at = lay[word]
    words = peer._block[at:at + 8 * npk].view(torch.int64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(cycles)
        words.add_(add)
    return side


def _chunks(peer) -> int:
    """push_common.cuh::peer_chunks: push blocks per (shard, phase)."""
    npk = peer.shape[0] * peer.nph
    seg = peer.seg_bytes // 16
    return min(-(-seg // 512), max(1, 264 // npk))


@pytest.mark.cuda
def test_cuda_peer_waits_are_counted_and_change_no_output(recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
    from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
    from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch

    mesh = generate_mesh(24, 24, 24, jitter=0.05, diag_frac=0.2, seed=0)
    gvar = make_state(mesh.npoint, 7, seed=3)
    parts = partition_mesh(mesh, 2, ghost_layers=1)
    loop = GreenGaussTorch(parts, 7, device="cuda")
    peer_m = GreenGaussTorch(parts, 7, device="cuda", transport="peer")
    st_l = loop.distribute_state(gvar, schedules=["overlap"])
    st_p = peer_m.distribute_state(gvar, schedules=["overlap"])
    peer = peer_m.peer
    assert peer is not None
    npk = peer.shape[0] * peer.nph
    blocks = npk * _chunks(peer)
    # the first late signal loads its stream and kernels, which takes the
    # host longer than its sleep: send one that adds nothing first
    _late(peer, "ready", 0, cycles=1000).synchronize()
    recorder.enable()
    recorder.read()
    c0 = compiled.counts()

    def step():
        got = peer_m(st_p["var_T"], st_p["tables"], "overlap")
        want = loop(st_l["var_T"], st_l["tables"], "overlap")
        torch.cuda.synchronize()
        assert torch.equal(got, want)

    try:
        step()
        # a readiness signal late: the push blocks wait for one more
        # epoch than block 0 signals, which the side stream adds
        peer.epoch_words[0] += 1
        side = _late(peer, "ready", 1)
        step()
        side.synchronize()
        recorder.read()
        c1 = compiled.counts()
        assert c1["peer_waits_barrier"] - c0["peer_waits_barrier"] >= 1
        # the push blocks spun until the side stream's sleep (about 10 ms)
        # ended, less the host's enqueue of the step: over 0.1 ms in all
        assert c1["peer_wait_barrier_ns"] - c0["peer_wait_barrier_ns"] > 1e5
        # arrivals late: the last-ticket block waits for one more epoch of
        # arrivals, which the side stream adds
        peer.epoch_words[1] += 1
        side = _late(peer, "arrive", _chunks(peer))
        step()
        side.synchronize()
        step()
        recorder.read()
        c2 = compiled.counts()
        assert c2["peer_waits_arrive"] - c1["peer_waits_arrive"] >= 1
        assert c2["peer_wait_arrive_ns"] - c1["peer_wait_arrive_ns"] > 1e5
        # never more waits than the launches made: every push block's
        # readiness wait, every local arrival word's wait
        launches = 4
        assert c2["peer_waits_barrier"] - c0["peer_waits_barrier"] <= \
            launches * blocks
        assert c2["peer_waits_arrive"] - c0["peer_waits_arrive"] <= \
            launches * npk
        # every wait that spun took time
        for k, n in (("peer_wait_barrier_ns", "peer_waits_barrier"),
                     ("peer_wait_arrive_ns", "peer_waits_arrive")):
            assert c2[k] - c0[k] >= c2[n] - c0[n]
        assert peer.wait_words.tolist()[1] >= 1
    finally:
        peer_m.close()
        loop.close()
