"""The port's schedules at P shards on one device against the JAX model.

`GreenGaussTorch` on CPU tensors (the kernels' plain versions, the loopback
transport) against `GreenGaussPallas` in interpret mode on the virtual
8-device CPU mesh, for bulk, early, overlap and nocomm at P ∈ {1, 4, 8}
shards (and P = 3, not a power of two) and one or two ghost layers:

- the port against the reference, shard by shard, column for column, within
  1e-6 of max|ref| (FMA contraction and summation grouping of two
  frameworks), and both against the f64 golden within 1e-5;
- early against bulk and overlap against early within 1e-6 (the
  reference's own cross-schedule gate);
- every ghost column equal to its owner's column, bitwise;
- the P=1 forced overlap (the fused kernel on self-send phases) equal to
  the unforced one, which degrades to the early graph;
- the model built from the reference's arrays equal to the port's own host
  layer; the shipped 4-part netCDF mesh; the chained loop; the
  `entry_phases` repair.

Each JAX model is built once per (P, ghost layers) and reused across the
schedules (module-scoped cache): interpret mode is slow at P=8.
"""

import os

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.mesh.reader import read_partition
from cfd_proxy_tpu.models import GreenGaussPallas
from cfd_proxy_tpu.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy_tpu.utils.errors import CheckError
from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax
from cfd_proxy_tpu_torch.models import gradients as tg
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.parallel.topology import (build_halo_topology,
                                                   entry_phases)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVAR = 5
BP = 128
PORT_TOL = 1e-6      # port vs reference, relative to max(1, max|ref|)
GOLDEN_TOL = 1e-5    # vs the f64 golden (the reference's gate)
SCHED_TOL = 1e-6     # early vs bulk, overlap vs early (the reference's gate)
SHARDS = [(1, 1), (3, 1), (4, 1), (4, 2), (8, 1)]     # (P, ghost_layers)
SCHEDULES = ("bulk", "early", "overlap", "nocomm")


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def gref(mesh, gvar):
    g = compute_gradients_gg(gvar.astype(np.float64), mesh.faces, mesh.normals)
    return scale_gradients(g, mesh.volume, mesh.npoint).reshape(mesh.npoint, -1)


@pytest.fixture(scope="module")
def runs(mesh, gvar):
    """(P, ghost_layers) → both models and every schedule's output, built
    on first use."""
    cache = {}

    def get(npart, ghost_layers):
        key = (npart, ghost_layers)
        if key not in cache:
            parts = partition_mesh(mesh, npart, ghost_layers=ghost_layers)
            jm = GreenGaussPallas(parts, NVAR, bp=BP, interpret=True)
            js = jm.distribute_state(gvar)
            tm = GreenGaussTorch(parts, NVAR, bp=BP, device="cpu")
            ts = tm.distribute_state(gvar)
            cache[key] = {
                "jm": jm, "tm": tm, "ts": ts,
                "jax": {s: np.asarray(jm.step(js, s)) for s in SCHEDULES},
                "port": {s: tm.step(ts, s).numpy() for s in SCHEDULES},
            }
        return cache[key]

    return get


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("npart,ghost_layers", SHARDS)
def test_schedule_matches_reference_and_golden(runs, gref, npart,
                                               ghost_layers, schedule):
    r = runs(npart, ghost_layers)
    tm, jm = r["tm"], r["jm"]
    got, want = r["port"][schedule], r["jax"][schedule]
    assert tm.ndev == jm.layout.ndev and tm.nphases == jm.layout.nphases
    assert got.shape == want.shape == (npart, 24, tm.ndev)
    for d in range(npart):        # shard by shard
        scale = max(1.0, np.abs(want[d]).max())
        assert np.abs(got[d] - want[d]).max() / scale < PORT_TOL, d
    denom = max(1.0, np.abs(gref).max())
    for name, g in (("port", tm.gather_global(torch.from_numpy(got))),
                    ("jax", jm.gather_global(want))):
        assert np.abs(g - gref).max() / denom < GOLDEN_TOL, name
    # early vs bulk, overlap vs early: the port's own cross-schedule gate
    prev = {"early": "bulk", "overlap": "early"}.get(schedule)
    if prev is not None:
        scale = max(1.0, np.abs(r["port"]["bulk"]).max())
        assert np.abs(got - r["port"][prev]).max() / scale < SCHED_TOL


@pytest.mark.parametrize("schedule", ("bulk", "early", "overlap"))
def test_ghosts_match_owner(runs, schedule):
    """Every ghost column equals the owner's owned column bitwise, after
    each schedule's exchange (the reference's test_pallas_ghosts_match_owner
    check)."""
    r = runs(4, 1)
    tm = r["tm"]
    g = r["port"][schedule]
    checked = 0
    for i, p in enumerate(tm.parts):
        for e in p.comm:
            q = tm.parts[e.partner]
            back = [x for x in q.comm
                    if x.partner == p.part_id and x.round == e.round]
            send_cols = tm.locmap[e.partner][back[0].sendidx]
            recv_cols = tm.locmap[i][e.recvidx]
            if len(send_cols) == 0:
                continue
            np.testing.assert_array_equal(g[i][:, recv_cols],
                                          g[e.partner][:, send_cols])
            checked += len(send_cols)
    assert checked > 0
    # nocomm fills no ghost column: they stay zero-scaled
    ghosts = slice(tm.ghost_start, tm.ghost_start + tm.nphases * tm.s_max)
    assert not r["port"]["nocomm"][:, :, ghosts].any()


def test_force_rdma_p1_overlap_equals_unforced(mesh, gvar, monkeypatch):
    """At one shard, overlap with the fused kernel forced (self-send phases
    of masked zeros) equals the unforced overlap, which runs the early
    graph, bitwise on the owned columns; only the forced model calls the
    fused kernel."""
    calls = []
    fused = tg.sweep_blocks_overlap
    monkeypatch.setattr(tg, "sweep_blocks_overlap",
                        lambda *a: calls.append(1) or fused(*a))
    parts = partition_mesh(mesh, 1)
    forced = GreenGaussTorch(parts, NVAR, bp=BP, force_rdma=True,
                             device="cpu")
    plain = GreenGaussTorch(parts, NVAR, bp=BP, device="cpu")
    assert forced.has_comm and not plain.has_comm
    assert not forced.moves
    ga = forced.step(forced.distribute_state(gvar), "overlap").numpy()
    assert len(calls) == 1
    gb = plain.step(plain.distribute_state(gvar), "overlap").numpy()
    assert len(calls) == 1
    n = forced.ghost_start
    np.testing.assert_array_equal(ga[:, :, :n], gb[:, :, :n])


@pytest.mark.parametrize("npart", [1, 4])
def test_from_arrays_equals_own_host_layer_sharded(mesh, gvar, npart):
    """Built from the reference's arrays (every class, every shard, the
    exchange tables), the model holds and computes exactly what it holds
    and computes from its own host layer."""
    parts = partition_mesh(mesh, npart, ghost_layers=1)
    jm = GreenGaussPallas(parts, NVAR, bp=BP, interpret=True)
    arrays = plans_from_jax(jm)
    conv = GreenGaussTorch.from_arrays(jm.parts, NVAR, arrays, device="cpu")
    own = GreenGaussTorch(parts, NVAR, bp=BP, device="cpu")
    assert conv.wks == own.wks and conv.ndev == own.ndev
    assert conv.perms == own.perms and conv.has_comm == own.has_comm
    for c, pl in own.plans.items():
        for name, t in pl.items():
            assert torch.equal(conv.plans[c][name], t), (c, name)
    for name in ("pack_cols", "send_mask", "pack_scale", "dsts", "srcs"):
        assert torch.equal(getattr(conv, name), getattr(own, name)), name
    for a, b in zip(conv.locmap, own.locmap):
        np.testing.assert_array_equal(a, b)
    sc = conv.distribute_state(gvar)
    so = own.distribute_state(gvar)
    js = jm.distribute_state(gvar, schedules=["bulk"])
    np.testing.assert_array_equal(sc["var_T"].numpy(), state_from_jax(js))
    for s in SCHEDULES:
        assert torch.equal(conv.step(sc, s), own.step(so, s)), s


def test_shipped_4part_mesh_matches_reference():
    """The shipped 4-part netCDF partition, every schedule, port against
    reference."""
    parts = [read_partition(os.path.join(REPO, "data", f"small.4p.{i}.nc"))
             for i in range(4)]
    npoint = sum(p.nowned for p in parts)
    state = make_state(npoint, NVAR, seed=5)
    jm = GreenGaussPallas(parts, NVAR, bp=BP, interpret=True)
    js = jm.distribute_state(state)
    tm = GreenGaussTorch(parts, NVAR, bp=BP, device="cpu")
    ts = tm.distribute_state(state)
    assert tm.moves
    for s in SCHEDULES:
        want = np.asarray(jm.step(js, s))
        got = tm.step(ts, s)
        scale = max(1.0, np.abs(want).max())
        assert np.abs(got.numpy() - want).max() / scale < PORT_TOL, s
        np.testing.assert_allclose(tm.gather_global(got),
                                   jm.gather_global(want), rtol=0,
                                   atol=PORT_TOL * scale)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_iterate_fn_chains_every_schedule(runs, schedule):
    """The chained loop feeds each step's gradients into the next state,
    at four shards, for every schedule."""
    r = runs(4, 1)
    tm, ts = r["tm"], r["ts"]
    v2 = tm.iterate_fn(schedule, 2)(*tm.iter_args(ts))
    v = ts["var_T"]
    for _ in range(2):
        v = v + 1e-30 * tm(v, ts["tables"], schedule)[:, :8]
    assert torch.equal(v2, v)
    assert v2.shape == ts["var_T"].shape


def test_entry_phases_fallback_raises(mesh):
    """entry_phases answers phase 0 when no phase carries a comm entry;
    the model's check turns that into an error (a phase that lost one of
    its pairs would otherwise mis-order the comm-first relabel silently)."""
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    topo = build_halo_topology(parts, max(p.npoint for p in parts) + 1)
    tg.check_entry_phases(parts, topo, entry_phases(parts, topo))
    ph = topo.phases[0]
    ph.perm = ph.perm[1:]                         # drop one (src, dst) pair
    with pytest.raises(CheckError, match="no exchange phase"):
        tg.check_entry_phases(parts, topo, entry_phases(parts, topo))
