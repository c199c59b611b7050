"""The multi-rank path of the port on the CPU: shards spread over the ranks
of a gloo group, against the one-process port and the JAX model.

- the `Dist` transport alone: for P in {2, 3, 4, 8} shards and every W that
  divides P, its `recv` equals `loopback(sendbufs, dsts)` BITWISE on random
  buffers from a numpy seed, f32 and bf16, on a layout with a full phase, a
  phase whose perm leaves receivers empty (they read zeros) and an empty
  phase;
- the slice: the 9x8x7 mesh at bp 128 (as tests/test_pallas_model.py),
  through `GreenGaussPallas(..., interpret=True)` and through the port at
  (P, W) in {(4, 2), (4, 4), (3, 3), (8, 2)}, every schedule: within 1e-6 x
  max|ref| of the reference (two frameworks' FMA contraction and summation
  grouping), within 1e-5 of the f64 golden (the reference's gate), and
  BITWISE equal to the port's own one-process run (the exchange is a copy,
  the kernels see the same operands); one case each of the flux model, the
  gather kernel, solver mode and the full bf16 stack at (4, 2), bitwise
  against one process and inside their goldens' bands;
- the routing: P = 8 with slice_size 4 and 1 against
  `GreenGaussPallas(..., slice_size=...)`;
- the fused kernel's plain version with a transport; a JAX model's arrays
  loaded into a W = 2 port model; the launcher's failure modes; the CLI.

Ranks are processes started by `parallel.launch.spawn`; each world size is
spawned once per module and runs all of its jobs in one group
(`workers.batch`); with the `from_arrays` case and the launcher's three
that is eight spawns, and two CLI runs start two ranks each.  Every spawn
has a time limit of 120 s at most and its children run one thread each.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.models import GreenGaussPallas, PSDFluxModel
from cfd_proxy_tpu.ops.flux import compute_psd_flux, flux_residual_scale
from cfd_proxy_tpu.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy_tpu_torch import solver
from cfd_proxy_tpu_torch.convert import plans_from_jax
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.parallel import launch, workers
from cfd_proxy_tpu_torch.parallel.transport import (Dist, Loopback, Peer,
                                                    peer_layout, peer_table)
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVAR = 5
PORT_TOL = 1e-6      # port vs reference, relative to max(1, max|ref|)
GOLDEN_TOL = 1e-5    # vs the f64 golden (the reference's gate)
BF16_BAND = (1e-5, 2e-2)    # the full bf16 stack vs the golden (reference)
SPAWN_LIMIT_S = 120
SCHEDULES = ("bulk", "early", "overlap")
BUF = (3, 16)        # rows x s_max of the transport-alone buffers
FULL = {"src_dtype": "bfloat16", "meta_dtype": "bfloat16",
        "grad_dtype": "bfloat16", "halo_dtype": "bfloat16"}


def layout(P):
    """(perms, dsts) of a three-phase exchange of P shards: a full ring, a
    phase in which only even shards send (to their successor), an empty
    phase.  dsts completes each to a permutation, as tlayout does."""
    ring = [(p, (p + 1) % P) for p in range(P)]
    part = [(p, p + 1) for p in range(0, P - 1, 2)]
    dsts = np.zeros((P, 3), np.int64)
    for k, perm in enumerate((ring, part, [])):
        d = dict(perm)
        free_dst = [q for q in range(P) if q not in d.values()]
        for p in range(P):
            dsts[p, k] = d[p] if p in d else free_dst.pop(0)
    return [ring, part, []], dsts


def case(P, **model):
    return workers.ModelCase(nx=9, ny=8, nz=7, parts=P, nvar=NVAR,
                             device="cpu",
                             model={"bp": 128, **model})


# name -> (worker, args); every job of one world size runs in one spawn
JOBS = {
    2: {
        **{f"dist-{P}-{dt}": ("dist_exchange",
                              (P, layout(P)[0], BUF, dt, 100 + P, "cpu"))
           for P in (2, 4, 8) for dt in ("float32", "bfloat16")},
        "gg-4": ("model_outputs", (case(4),)),
        "gg-8": ("model_outputs", (case(8),)),
        "flux-4": ("model_outputs", (case(4, op="flux"),)),
        "gather-4": ("model_outputs", (case(4, kernel="gather"),)),
        "bf16-4": ("model_outputs", (case(4, **FULL),)),
        "solver-4": ("model_outputs", (workers.ModelCase(
            nx=9, ny=8, nz=7, parts=4, nvar=NVAR, device="cpu",
            schedules=("early",),
            solver_steps=2, sweeps_per_step=2, model={"bp": 128}),)),
        "slice4-8": ("model_outputs", (case(8, slice_size=4),)),
        "ref-4": ("overlap_ref_exchange", (case(4),)),
        "chain-4": ("overlap_chain", (case(4), 5, 0.1)),
    },
    3: {
        **{f"dist-3-{dt}": ("dist_exchange", (3, layout(3)[0], BUF, dt, 103,
                                              "cpu"))
           for dt in ("float32", "bfloat16")},
        "gg-3": ("model_outputs", (case(3),)),
    },
    4: {
        **{f"dist-{P}-{dt}": ("dist_exchange",
                              (P, layout(P)[0], BUF, dt, 100 + P, "cpu"))
           for P in (4, 8) for dt in ("float32", "bfloat16")},
        "gg-4": ("model_outputs", (case(4),)),
    },
    8: {f"dist-8-{dt}": ("dist_exchange", (8, layout(8)[0], BUF, dt, 108,
                                         "cpu"))
        for dt in ("float32", "bfloat16")},
}


@pytest.fixture(scope="module")
def ranks():
    """ranks(W, name) -> the job's result on every rank (a list)."""
    cache = {}

    def get(world, name):
        if world not in cache:
            out = launch.spawn(world, workers.batch,
                               (list(JOBS[world].values()),),
                               timeout_s=SPAWN_LIMIT_S)
            cache[world] = {n: [out[r][i] for r in range(world)]
                            for i, n in enumerate(JOBS[world])}
        return cache[world][name]

    return get


@pytest.fixture(scope="module")
def one():
    """one(name, case) -> the one-process result of a model job (cached)."""
    cache = {}

    def get(name, c):
        if name not in cache:
            cache[name] = workers.model_outputs(c)
        return cache[name]

    return get


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
def jax_runs(mesh, gvar):
    """jax_runs(P, slice_size) -> (model, {schedule: global array})."""
    cache = {}

    def get(P, slice_size=None):
        if (P, slice_size) not in cache:
            jm = GreenGaussPallas(partition_mesh(mesh, P, ghost_layers=1),
                                  NVAR, bp=128, interpret=True,
                                  slice_size=slice_size)
            st = jm.distribute_state(gvar)
            cache[(P, slice_size)] = (jm, {
                s: jm.gather_global(np.asarray(jm.step(st, s)))
                for s in SCHEDULES})
        return cache[(P, slice_size)]

    return get


def relmax(got, ref):
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


# ------------------------------------------------------ the transport alone

def expected_recv(P, dtype, seed):
    perms, dsts = layout(P)
    send = workers.seeded_buffers(P, perms, BUF, dtype, seed)
    return workers.as_bytes(bs.loopback(send, torch.from_numpy(dsts)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,W", [(2, 2), (3, 3), (4, 2), (4, 4), (8, 2),
                                 (8, 4), (8, 8)])
def test_dist_equals_loopback_bitwise(ranks, P, W, dtype):
    got = np.concatenate(ranks(W, f"dist-{P}-{dtype}"))
    want = expected_recv(P, dtype, 100 + P)
    assert got.shape == want.shape and want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_dist_one_rank_equals_loopback_bitwise(P, dtype):
    """W = 1: no group, every pair a local copy."""
    got = workers.dist_exchange(P, layout(P)[0], BUF, dtype, 100 + P,
                                "cpu")
    np.testing.assert_array_equal(got, expected_recv(P, dtype, 100 + P))


def test_dist_leaves_receivers_outside_the_perm_zero(ranks):
    """Phase 1 moves even shards only, phase 2 nothing: every other
    receiver reads zeros (also where loopback's completed permutation
    delivered a zero buffer)."""
    got = np.concatenate(ranks(2, "dist-4-float32"))
    assert got[1, 1].any() and got[3, 1].any()
    assert not got[0, 1].any() and not got[2, 1].any()
    assert not got[:, 2].any()


def test_loopback_transport_is_the_loopback_copy():
    perms, dsts = layout(4)
    send = workers.seeded_buffers(4, perms, BUF, "float32", 7)
    t = Loopback(dsts, "cpu")
    assert t.name == "loopback"
    assert torch.equal(t.exchange(send), bs.loopback(send,
                                                     torch.from_numpy(dsts)))
    assert torch.equal(t.finish(t.start(send)), t.exchange(send))


def test_dist_refuses_nccl_on_cpu_and_shared_devices(monkeypatch):
    """The backend is named before NCCL could fail: nccl moves CUDA
    tensors only, and not between two ranks of one device."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda g: "nccl")
    monkeypatch.setattr(dist, "get_rank", lambda g: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda g: 2)
    with pytest.raises(CheckError, match="nccl moves CUDA tensors only"):
        Dist(layout(2)[0], 2, object(), "cpu")
    with pytest.raises(CheckError, match="nccl with two ranks on one device"):
        Dist(layout(2)[0], 2, object(), "cuda", share_device=True)


def test_peer_has_no_cpu_form():
    with pytest.raises(CheckError, match="no CPU form"):
        Peer(np.zeros((1, 1)), np.zeros((1, 1)), rows=24, s_max=128,
             dtype=torch.float32, device="cpu")
    parts = partition_mesh(generate_mesh(5, 4, 4, seed=0), 2)
    with pytest.raises(CheckError, match="no CPU form"):
        GreenGaussTorch(parts, NVAR, bp=128, device="cpu", transport="peer")


def test_peer_table_addresses():
    """The address table the kernels push through: rank 1 of 2 holding
    shards [2, 4) of a ring, from fake base addresses."""
    P, nph, seg = 4, 2, 4096
    dsts = np.array([[(p + 1) % P] * nph for p in range(P)], np.int32)
    srcs = np.array([[(p - 1) % P] * nph for p in range(P)], np.int32)
    lay = peer_layout(2, nph, seg)
    assert lay["flags"] % 256 == 0 and lay["flags"] >= 2 * nph * seg
    # ready, arrive (2·nph words each), done, the two launch epochs and
    # the four wait words
    assert lay["bytes"] == lay["flags"] + 8 * (2 * 2 * nph + 7)
    bases = {0: 1 << 40, 1: 1 << 41}
    t = peer_table(dsts, srcs, 2, 4, bases, seg).reshape(2, nph, 3)
    for k in range(nph):
        # shard 2 -> shard 3: this rank's local shard 1
        assert t[0, k, 0] == bases[1] + (1 * nph + k) * seg
        assert t[0, k, 1] == bases[1] + lay["arrive"] + 8 * (1 * nph + k)
        # shard 2 receives from shard 1: rank 0's local shard 1
        assert t[0, k, 2] == bases[0] + lay["ready"] + 8 * (1 * nph + k)
        # shard 3 -> shard 0: rank 0's local shard 0
        assert t[1, k, 0] == bases[0] + k * seg
        assert t[1, k, 2] == bases[1] + lay["ready"] + 8 * k


@pytest.mark.parametrize("nlocal,nph,seg", [(1, 1, 16), (1, 6, 9728),
                                             (2, 2, 4096), (4, 6, 4864),
                                             (8, 6, 116736), (3, 5, 48)])
def test_peer_layout_epoch_words(nlocal, nph, seg):
    """One rank's exchange block: recv at 0 (16-byte pieces, unchanged by
    the epochs), the flag words from a 256-byte boundary past it, then
    ready, arrive, done and the two launch epochs (barrier, copy) the
    kernels read and advance (csrc/push_common.cuh: PeerPush::epochs is
    flags + 2·npk + 1 words), then the four wait words that end the block
    (tests/test_torch_peer_wait.py)."""
    npk = nlocal * nph
    lay = peer_layout(nlocal, nph, seg)
    assert lay["recv"] == 0 and lay["recv"] % 16 == 0
    assert lay["flags"] % 256 == 0
    assert npk * seg <= lay["flags"] < npk * seg + 256
    assert lay["ready"] == lay["flags"]
    assert lay["arrive"] == lay["ready"] + 8 * npk
    assert lay["done"] == lay["arrive"] + 8 * npk
    assert lay["epochs"] == lay["done"] + 8
    assert lay["epochs"] == lay["flags"] + 8 * (2 * npk + 1)
    assert lay["epochs"] % 8 == 0
    assert lay["waits"] == lay["epochs"] + 16
    assert lay["bytes"] == lay["epochs"] + 48
    # the epoch words view as the two int64 the transport reads back
    block = torch.zeros(lay["bytes"], dtype=torch.uint8)
    words = block[lay["epochs"]:lay["waits"]].view(torch.int64)
    words[1] = 3
    assert words.shape == (2,) and block[lay["epochs"] + 8] == 3


def test_peer_keeps_no_host_epoch():
    """The launch epochs are device words: no host counter and no epoch
    argument crosses into the kernels."""
    import inspect

    from cfd_proxy_tpu_torch.ops import _cuda, blocksweep, push

    assert not hasattr(Peer, "_ready") and "epochs(" not in \
        inspect.getsource(Peer) and "self.epochs" not in \
        inspect.getsource(Peer)
    for mod in (blocksweep, push, _cuda):
        assert "epoch_ready" not in inspect.getsource(mod)
        assert "epoch_arrive" not in inspect.getsource(mod)


def test_overlap_chain_worker_equals_one_process(ranks):
    """`workers.overlap_chain`, which the card's two-process check runs
    through the peer transport under graph: on the CPU (eager, the CPU
    reason) the chained overlap state at a coupling that moves it, over two
    gloo ranks, equals the one-process state bit for bit on every rank."""
    one = workers.overlap_chain(case(4), 5, 0.1)
    assert one["dispatch"] == "eager" and one["world"] == 1
    assert one["graph_equals_eager"] and one["moved"] > 1e-3
    for r in ranks(2, "chain-4"):
        assert r["world"] == 2 and r["dispatch"] == "eager"
        assert r["graph_equals_eager"] and r["digest"] == one["digest"]
        assert r["replay_kernels"] == 0 and r["launches"] == {}


# ------------------------------------------------- the slice against JAX

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("P,W", [(4, 2), (4, 4), (3, 3), (8, 2)])
def test_ranks_match_reference_golden_and_one_process(ranks, one, jax_runs,
                                                      gref, P, W, schedule):
    res = ranks(W, f"gg-{P}")
    ref = jax_runs(P)[1][schedule]
    single = one(f"gg-{P}", case(P))["outputs"][schedule]
    for r in res:
        got = r["outputs"][schedule]
        assert r["transport"] == "dist/gloo" and r["world"] == W
        assert np.array_equal(got, single)          # bitwise, every rank
        assert relmax(got, ref) <= PORT_TOL
        assert relmax(got, gref) <= GOLDEN_TOL


def test_ranks_import_no_jax(ranks):
    assert all(r["foreign_modules"] == [] for r in ranks(2, "gg-4"))


@pytest.mark.parametrize("name,options", [
    ("flux-4", {"op": "flux"}), ("gather-4", {"kernel": "gather"}),
    ("bf16-4", FULL)])
def test_ranks_model_variants_bitwise_and_in_band(ranks, one, mesh, gvar, gref,
                                                  name, options):
    """The flux model, the gather kernel and the full bf16 stack at P = 4,
    W = 2: bitwise the one-process port, and inside their golden bands."""
    res = ranks(2, name)
    single = one(name, case(4, **options))
    if name == "flux-4":
        gold = flux_residual_scale(
            compute_psd_flux(gvar.astype(np.float64), mesh.faces,
                             mesh.normals), mesh.volume, mesh.npoint)
    else:
        gold = gref
    for s in SCHEDULES:
        for r in res:
            assert np.array_equal(r["outputs"][s], single["outputs"][s]), s
        err = relmax(res[0]["outputs"][s], gold)
        if name == "bf16-4":
            assert BF16_BAND[0] < err <= BF16_BAND[1], (s, err)
        else:
            assert err <= GOLDEN_TOL, (s, err)


def test_ranks_flux_matches_reference(ranks, mesh, gvar):
    jm = PSDFluxModel(partition_mesh(mesh, 4, ghost_layers=1), NVAR, bp=128,
                      interpret=True)
    st = jm.distribute_state(gvar)
    ref = jm.gather_global(np.asarray(jm.step(st, "early")))
    assert relmax(ranks(2, "flux-4")[0]["outputs"]["early"], ref) <= PORT_TOL


def test_ranks_solver_mode_bitwise(ranks, one):
    """Solver mode, two sweeps per step, the var exchange through `Dist`:
    the final state of every shard equals the one-process run's."""
    c = JOBS[2]["solver-4"][1][0]
    single = one("solver-4", c)
    for r in ranks(2, "solver-4"):
        assert r["solver"].shape == single["solver"].shape
        assert np.array_equal(r["solver"], single["solver"])
        assert np.array_equal(r["outputs"]["early"],
                              single["outputs"]["early"])


def test_overlap_ref_with_transport_equals_loopback(ranks):
    """K3's plain version with a transport: at W = 1 (`Loopback`) and
    across W = 2 (`Dist`) the same grad and, on the pairs that move data,
    the same recv, bitwise."""
    single = workers.overlap_ref_exchange(case(4))
    c = case(4)
    mesh_ = generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                          seed=41)
    model = GreenGaussTorch(partition_mesh(mesh_, 4), NVAR, bp=128,
                            device="cpu")
    moved = np.zeros((4, model.nphases), bool)
    for k, perm in enumerate(model.perms):
        for _, d in perm:
            moved[d, k] = True
    assert moved.any() and c.parts == 4
    for r in ranks(2, "ref-4"):
        assert np.array_equal(r["grad"], single["grad"])
        assert np.array_equal(r["recv"][moved], single["recv"][moved])
        assert not r["recv"][~moved].any()


# ------------------------------------------------------------- routing

@pytest.mark.parametrize("slice_size", [4, 1])
def test_routing_lists_equal_reference(jax_runs, mesh, slice_size):
    jm = jax_runs(8, slice_size)[0]
    tm = GreenGaussTorch(partition_mesh(mesh, 8), NVAR, bp=128, device="cpu",
                         slice_size=slice_size)
    assert tm.ici_phases == jm._ici_phases
    assert tm.dcn_phases == jm._dcn_phases
    assert tm.kernel_phases == jm._ici_phases       # loopback: in-kernel
    assert tm.coll_phases == jm._dcn_phases
    arrays = plans_from_jax(jm)
    assert arrays["inter_slice"].tolist() == [
        k in jm._dcn_phases for k in range(jm.layout.nphases)]
    tm2 = GreenGaussTorch.from_arrays(jm.parts, NVAR, arrays, device="cpu")
    assert tm2.dcn_phases == jm._dcn_phases


def test_routing_slice4_matches_reference(jax_runs, one, gref):
    """slice_size 4 at P = 8: in-kernel and collective phases mixed in one
    overlap step (W = 1: the fused kernel's plain version on the in-node
    phases, `Loopback` on the others)."""
    jm, ref = jax_runs(8, 4)
    assert jm._dcn_phases and jm._ici_phases
    res = one("slice4-8", case(8, slice_size=4))
    assert res["kernel_phases"] == jm._ici_phases
    assert res["collective_phases"] == jm._dcn_phases
    for s in SCHEDULES:
        assert relmax(res["outputs"][s], ref[s]) <= PORT_TOL
        assert relmax(res["outputs"][s], gref) <= GOLDEN_TOL


def test_routing_slice4_two_ranks(ranks, one):
    """The same at W = 2 over `Dist`: every phase is a collective one, and
    the owned results equal the one-process routed run bitwise."""
    single = one("slice4-8", case(8, slice_size=4))
    for r in ranks(2, "slice4-8"):
        assert r["kernel_phases"] == []
        for s in SCHEDULES:
            assert np.array_equal(r["outputs"][s], single["outputs"][s])


def test_routing_slice1_degrades_overlap_to_early(jax_runs, mesh, gvar, gref):
    jm, ref = jax_runs(8, 1)
    tm = GreenGaussTorch(partition_mesh(mesh, 8), NVAR, bp=128, device="cpu",
                         slice_size=1)
    real = [k for k, p in enumerate(tm.perms) if p]
    assert all(k in tm.dcn_phases for k in real)
    assert not [k for k in tm.kernel_phases if k in real]
    st = tm.distribute_state(gvar)
    early, overlap = tm.step(st, "early"), tm.step(st, "overlap")
    assert torch.equal(early, overlap)
    got = tm.gather_global(overlap)
    assert relmax(got, ref["overlap"]) <= PORT_TOL
    assert relmax(got, gref) <= GOLDEN_TOL


def test_jax_arrays_load_into_two_ranks(jax_runs, gvar, gref):
    """State carried across: a JAX model's relabeled partitions and plan
    arrays (slice_size 4, so `inter_slice` travels too) loaded into a
    W = 2 port model through `from_arrays`."""
    jm, ref = jax_runs(8, 4)
    c = workers.ModelCase(nx=0, ny=0, nz=0, parts=8, nvar=NVAR,
                          device="cpu")
    res = launch.spawn(2, workers.model_outputs,
                       (c, jm.parts, plans_from_jax(jm), gvar),
                       timeout_s=SPAWN_LIMIT_S)
    for r in res:
        assert r["collective_phases"] == list(range(jm.layout.nphases))
        for s in SCHEDULES:
            assert relmax(r["outputs"][s], ref[s]) <= PORT_TOL
            assert relmax(r["outputs"][s], gref) <= GOLDEN_TOL


# ------------------------------------------------------------ the launcher

def test_spawn_reports_a_child_that_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank [01] raised:(.|\n)*boom"):
        launch.spawn(2, workers.raises, ("boom",), timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_spawn_reports_a_child_that_never_joins():
    """Rank 1 never joins the group: rank 0's init times out after 3 s,
    the parent kills rank 1 and raises with rank 0's message."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 raised"):
        launch.spawn(2, workers.never_joins, (3.0,), timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_spawn_time_limit_kills_the_children():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="time limit of 2 s passed"):
        launch.spawn(1, time.sleep, (600,), timeout_s=2)
    assert time.monotonic() - t0 < 30


def test_world_from_env(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launch.world_from_env() is None
    with pytest.raises(CheckError, match="RANK and WORLD_SIZE"):
        launch.join_group("gloo")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert launch.world_from_env() == (1, 4, 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert launch.world_from_env() == (1, 4, 0)


# ------------------------------------------------------------------ the CLI

CLI = ["--nx", "8", "--ny", "8", "--nz", "8", "--parts", "4", "--device",
       "cpu", "--iters", "2", "--schedule", "all", "--json"]


@pytest.fixture(scope="module")
def cli_one():
    return _cli(CLI)


def _cli(argv, env=None):
    """The solver CLI in a child process with one thread (OMP_NUM_THREADS=1
    merged into `env`, default this process's environment): under xdist a
    child with torch's default pool, one thread a core, shares the cores
    with every worker, and its time follows the load (4-5 s alone, cut at
    the limit beside a loaded suite)."""
    env = {**(os.environ if env is None else env), "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", *argv],
        capture_output=True, text=True, timeout=SPAWN_LIMIT_S, cwd=REPO,
        env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_cli_two_ranks_match_one(cli_one):
    d = _cli([*CLI, "--ranks", "2"])
    assert d["ranks"] == 2 and d["transport"] == "dist/gloo"
    assert cli_one["ranks"] == 1 and cli_one["transport"] == "loopback"
    v, v1 = d["verification"], cli_one["verification"]
    assert v["early_vs_bulk_maxabs"] == 0.0
    assert v["overlap_vs_bulk_maxabs"] == 0.0
    assert v["bulk_vs_golden_relmax"] == v1["bulk_vs_golden_relmax"] < 1e-5
    assert set(d["schedules"]) == {"bulk", "early", "overlap"}


def test_cli_slice_size_runs(cli_one):
    d = _cli([*CLI, "--slice-size", "2"])
    assert d["collective_phases"] and d["kernel_phases"]
    v = d["verification"]
    assert v["overlap_vs_bulk_maxabs"] < 1e-5
    assert v["bulk_vs_golden_relmax"] < 1e-5


def test_cli_two_ranks_with_jax_unimportable(tmp_path):
    """The W = 2 run under the import block of
    tests/test_torch_model.py::test_port_runs_with_jax_unimportable: a
    sitecustomize on PYTHONPATH blocks jax and the JAX package in the
    parent AND in the spawned ranks."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['jax'] = None\n"
        "sys.modules['cfd_proxy_tpu'] = None\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{REPO}"}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax"], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=60)
    assert probe.returncode != 0, "the block is not in force"
    d = _cli(["--nx", "6", "--ny", "6", "--nz", "6", "--parts", "2",
              "--ranks", "2", "--device", "cpu", "--iters", "2", "--json"],
             env=env)
    assert d["ranks"] == 2
    assert d["verification"]["bulk_vs_golden_relmax"] < 1e-5


@pytest.mark.parametrize("argv,match", [
    (["--ranks", "2", "--parts", "4", "--transport", "peer", "--device",
      "cpu"], "--transport peer .*no CPU form"),
    (["--ranks", "3", "--parts", "4", "--device", "cpu"],
     "--ranks 3 does not divide --parts 4"),
    (["--ranks", "2", "--parts", "4", "--device", "cuda"],
     "--ranks 2 exceeds the .* CUDA devices .*--share-device"),
    (["--ranks", "2", "--parts", "4", "--device", "cuda", "--share-device",
      "--dist-backend", "nccl"], "nccl with two ranks on one device"),
    (["--ranks", "2", "--parts", "4", "--device", "cpu", "--transport",
      "loopback"], "--transport loopback holds every shard in one process"),
    (["--ranks", "2", "--parts", "4", "--device", "cpu", "--dist-backend",
      "nccl"], "--dist-backend nccl moves CUDA tensors only"),
])
def test_cli_refuses_by_name(argv, match):
    if "cuda" in argv and torch.cuda.device_count() >= 2:
        pytest.skip("the refusal needs fewer than two cards")
    with pytest.raises(CheckError, match=match):
        solver.main(["--nx", "6", "--ny", "6", "--nz", "6", *argv])
