"""The port's ELL backend (`--backend xla`) against the JAX package's.

`cfd_proxy_tpu_torch/ops/sweep_ell.py` function by function against
`cfd_proxy_tpu/ops/sweep_jax.py` on one shard's plan (f64: bitwise; f32:
1e-6 relative), the exact path against the golden's raw sums on the
plan's faces bit for bit, bulk against boundary∘interior bit for bit, the
stacked (P, ...) form against shard by shard; the model
(`models/gradients_ell.py::GreenGaussModel`) against the JAX
`GreenGaussModel` at P ∈ {1, 4 with 2 ghost layers, 8}, every schedule
(f64 exact: bitwise to JAX, to the golden's raw sums and across
schedules; f32: 1e-6 relative), on its own plans and on the JAX model's
(`convert.sweeps_from_jax`); the halo exchange's ghost rows against their
owners; two gloo ranks against one process bit for bit.  The inputs come
from seeds through the generator and `make_state`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.models import GreenGaussModel as JaxModel
from cfd_proxy_tpu.ops import sweep_jax as J
from cfd_proxy_tpu.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy_tpu.ops.prep import build_sweep_plan as jax_plan
from cfd_proxy_tpu_torch.convert import sweeps_from_jax
from cfd_proxy_tpu_torch.models.gradients_ell import GreenGaussModel
from cfd_proxy_tpu_torch.ops import sweep_ell as T
from cfd_proxy_tpu_torch.ops.prep import build_sweep_plan
from cfd_proxy_tpu_torch.parallel import launch, workers
from cfd_proxy_tpu_torch.parallel.halo import (DeviceHalo, HostHalo,
                                               complete_perms, exchange)
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

NVAR = 5
F32_TOL = 1e-6       # f32 port vs reference, relative to max|reference|
SCHEDULES = ("bulk", "early", "overlap", "nocomm")
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}


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


# ---------------------------------------------------------------- one shard

@pytest.fixture(scope="module")
def shard():
    """One shard's plan with a random send set (boundary faces present),
    the padded state and both packages' tables in f64 and f32."""
    m = generate_mesh(7, 6, 5, jitter=0.1, diag_frac=0.25, shuffle=True,
                      seed=11)
    send = np.unique(np.random.default_rng(5).integers(0, m.npoint, 30))
    plan = build_sweep_plan(m.faces, m.normals, m.npoint, m.npoint, send)
    var = np.zeros((plan.npoint_pad, NVAR))
    var[: m.npoint] = make_state(m.npoint, NVAR, seed=2)
    vol = np.random.default_rng(6).uniform(0.5, 2.0, m.npoint)
    out = {"plan": plan, "var": var}
    for name, (tdt, jdt) in DTYPES.items():
        out[name] = (T.set_volume(T.device_sweep(plan, dtype=tdt), vol,
                                  m.npoint),
                     J.set_volume(J.device_sweep(plan, dtype=jdt), vol,
                                  m.npoint),
                     torch.from_numpy(var).to(tdt), jnp.asarray(var, jdt))
    return out


def _same(got: torch.Tensor, want, dt: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dt == "f64":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= F32_TOL * scale


def test_prep_copy_builds_the_reference_plan(shard):
    m = generate_mesh(7, 6, 5, jitter=0.1, diag_frac=0.25, shuffle=True,
                      seed=11)
    send = np.unique(np.random.default_rng(5).integers(0, m.npoint, 30))
    want = jax_plan(m.faces, m.normals, m.npoint, m.npoint, send)
    got = shard["plan"]
    for f in ("faces", "normals", "face_perm", "row_face", "row_sign",
              "row_point"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for blk in ("ell_full", "ell_boundary", "ell_interior"):
        for f in ("inc_face", "inc_sign"):
            np.testing.assert_array_equal(getattr(getattr(got, blk), f),
                                          getattr(getattr(want, blk), f))
    np.testing.assert_array_equal(got.ell_boundary.points,
                                  want.ell_boundary.points)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("fn", ["face_contrib_b", "face_contrib_i",
                                "sweep_rows_segment"])
def test_contrib_and_segment_match_reference(shard, dt, fn):
    ts, js, tv, jv = shard[dt]
    if fn == "sweep_rows_segment":
        got, want = T.sweep_rows_segment(tv, ts), J.sweep_rows_segment(jv, js)
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        tol = 1e-12 if dt == "f64" else F32_TOL
        assert np.abs(got.numpy() - np.asarray(want)).max() <= tol * scale
        return
    cls = fn[-1]
    got = T.face_contrib(tv, getattr(ts, f"faces_{cls}"),
                         getattr(ts, f"normals_{cls}"))
    want = J.face_contrib(jv, getattr(js, f"faces_{cls}"),
                          getattr(js, f"normals_{cls}"))
    _same(got, want, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("exact", [True, False])
def test_sweeps_match_reference(shard, dt, exact):
    """sweep_bulk, sweep_boundary, sweep_interior (on the boundary sums)
    and scale_owned: f64 bitwise to the reference, f32 within 1e-6."""
    ts, js, tv, jv = shard[dt]
    _same(T.sweep_bulk(tv, ts, exact=exact), J.sweep_bulk(jv, js, exact=exact),
          dt)
    gb_t = T.sweep_boundary(tv, ts, exact=exact)
    gb_j = J.sweep_boundary(jv, js, exact=exact)
    _same(gb_t, gb_j, dt)
    gi_t = T.sweep_interior(tv, ts, gb_t, exact=exact)
    _same(gi_t, J.sweep_interior(jv, js, gb_j, exact=exact), dt)
    _same(T.scale_owned(gi_t, ts), J.scale_owned(jnp.asarray(gi_t.numpy()),
                                                 js), dt)


def test_ell_reduce_exact_is_the_slot_loop(shard):
    """ell_reduce exact adds the slots one at a time, in slot order; the
    gathered reduction agrees to roundoff."""
    ts, js, tv, jv = shard["f64"]
    c = T.face_contrib(tv, ts.faces_i, ts.normals_i)
    init = torch.from_numpy(np.random.default_rng(3).normal(
        size=(ts.iinc_face.shape[0], c.shape[1])))
    got = T.ell_reduce(c, ts.iinc_face, ts.iinc_sign, init, exact=True)
    want = init.clone()
    for k in range(ts.iinc_face.shape[1]):
        want = want + ts.iinc_sign[:, k:k + 1] * c[ts.iinc_face[:, k]]
    assert torch.equal(got, want)
    _same(got, J.ell_reduce(jnp.asarray(c.numpy()), js.iinc_face,
                            js.iinc_sign, jnp.asarray(init.numpy()),
                            exact=True), "f64")
    fast = T.ell_reduce(c, ts.iinc_face, ts.iinc_sign, init, exact=False)
    np.testing.assert_allclose(fast.numpy(), got.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_exact_bulk_is_the_golden_on_the_plan_faces_and_splits(shard):
    """f64 exact: the raw sums equal compute_gradients_gg on the plan's
    (reordered) faces bit for bit, and boundary∘interior equals bulk."""
    ts, _, tv, _ = shard["f64"]
    plan, var = shard["plan"], shard["var"]
    bulk = T.sweep_bulk(tv, ts, exact=True)
    want = compute_gradients_gg(var, plan.faces, plan.normals)
    np.testing.assert_array_equal(bulk.numpy(), want.reshape(len(var), -1))
    split = T.sweep_interior(tv, ts, T.sweep_boundary(tv, ts, exact=True),
                             exact=True)
    assert torch.equal(split, bulk)


def test_stacked_shards_equal_shard_by_shard(shard):
    """The (P, ...) form of every function is the one-shard form per
    shard, bit for bit (two copies of the shard, the second state
    doubled)."""
    ts, _, tv, _ = shard["f64"]
    st = T.DeviceSweep.stack([ts, ts])
    tv2 = torch.stack([tv, 2 * tv])
    for fn in (lambda v, d: T.sweep_bulk(v, d, exact=True),
               lambda v, d: T.sweep_bulk(v, d),
               lambda v, d: T.sweep_boundary(v, d, exact=True),
               T.sweep_rows_segment,
               lambda v, d: T.scale_owned(T.sweep_bulk(v, d), d)):
        got = fn(tv2, st)
        for i in range(2):
            assert torch.equal(got[i], fn(tv2[i], ts))


def test_reduce_bytes_counts_the_gathered_slots(shard):
    ts = shard["f64"][0]
    K = ts.finc_face.shape[1]
    assert T.reduce_bytes(ts, 15, torch.float64) == \
        ts.finc_face.shape[0] * K * 15 * 8
    assert T.reduce_bytes(ts, 15, torch.float32) == \
        ts.finc_face.shape[0] * K * 15 * 4


def test_tf32_refused_for_f32_on_a_card():
    """An f32 ELL sweep on a CUDA device refuses TF32 matrix products (the
    golden gate would fail); f64 and the CPU are not affected."""
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(CheckError, match="TF32"):
            T.check_no_tf32(torch.float32, torch.device("cuda"))
        T.check_no_tf32(torch.float64, torch.device("cuda"))
        T.check_no_tf32(torch.float32, torch.device("cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    T.check_no_tf32(torch.float32, torch.device("cuda"))


# -------------------------------------------------------------------- halo

def test_complete_perms_is_a_permutation_keeping_the_pairs():
    perms = (((0, 1), (1, 0)), ((2, 0),), ())
    d = complete_perms(perms, 3)
    assert d.shape == (3, 3)
    for k in range(3):
        assert sorted(d[:, k]) == [0, 1, 2]
        for s, t in perms[k]:
            assert d[s, k] == t


def test_halo_refuses_a_ghost_received_twice():
    send = np.zeros((1, 4), np.int32)
    recv = np.array([[5, 5, 8, 8]], np.int32)            # 8 = padding
    halos = [HostHalo(send, recv, (((0, 1), (1, 0)),))] * 2
    with pytest.raises(CheckError, match="received twice"):
        DeviceHalo.stack(halos, 8, 0, 2, "cpu")


@pytest.mark.parametrize("P,gl", [(4, 1), (4, 2), (8, 1)])
def test_exchange_fills_ghost_rows_from_owners(mesh, gvar, P, gl):
    """The var exchange: every row of every shard (owned and ghost) holds
    the global state of its point; padding rows stay zero."""
    parts = partition_mesh(mesh, P, ghost_layers=gl)
    model = GreenGaussModel(parts, NVAR, dtype=torch.float64, device="cpu")
    var = model.distribute_state(gvar).numpy()
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(var[i, : p.npoint], gvar[p.global_ids])
        assert not var[i, p.npoint:].any()
    stale = torch.from_numpy(var.copy())
    for i, p in enumerate(parts):
        stale[i, p.nowned:] = -1.0          # ghosts stale, padding too
    again = model.exchange_var(stale)
    assert bool((stale[0, parts[0].nowned:] == -1.0).all())   # a copy
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(again[i, : p.npoint].numpy(),
                                      var[i, : p.npoint])
    np.testing.assert_array_equal(
        exchange(torch.from_numpy(var.copy()), model.halo).numpy(), var)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def models(mesh, gvar):
    """(P, ghost layers) → (JAX model, its state, port model, port state)
    in f64 and f32."""
    out = {}
    for P, gl in ((1, 1), (4, 2), (8, 1)):
        parts = partition_mesh(mesh, P, ghost_layers=gl)
        for name, (tdt, jdt) in DTYPES.items():
            jm = JaxModel(parts, NVAR, dtype=jdt)
            tm = GreenGaussModel(parts, NVAR, dtype=tdt, device="cpu")
            out[P, name] = (jm, jm.distribute_state(gvar), tm,
                            tm.distribute_state(gvar))
    return out


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_model_f64_exact_bitwise(models, gref, P, schedule):
    """f64 exact: the port equals the JAX model bit for bit at every shard
    count and schedule, every schedule equals bulk, and the owned rows sit
    within 1e-15 relative of the golden."""
    jm, js, tm, ts = models[P, "f64"]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got = tm.step(ts, schedule, exact=True)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.step(js, schedule, exact=True)))
    if schedule != "nocomm":
        assert torch.equal(got, tm.step(ts, "bulk", exact=True))
    g = tm.gather_global(got)
    assert np.abs(g - gref).max() / max(1.0, np.abs(gref).max()) <= 1e-15


@pytest.mark.parametrize("P", [1, 4, 8])
def test_model_f64_raw_sums_are_the_golden_on_each_shard(models, P):
    """Each shard's exact raw sums equal compute_gradients_gg over that
    shard's plan faces and its exchanged state, bit for bit."""
    _, _, tm, ts = models[P, "f64"]
    raw = T.sweep_bulk(ts, tm.dsweep, exact=True)
    for i, plan in enumerate(tm.plans):
        v = ts[i].numpy()
        want = compute_gradients_gg(v, plan.faces, plan.normals)
        np.testing.assert_array_equal(raw[i].numpy(),
                                      want.reshape(len(v), -1))


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_model_f32_matches_reference(models, gref, P, schedule):
    jm, js, tm, ts = models[P, "f32"]
    want = np.asarray(jm.step(js, schedule))
    got = tm.step(ts, schedule).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= F32_TOL * scale
    if schedule != "nocomm":
        g = tm.gather_global(torch.from_numpy(got))
        assert np.abs(g - gref).max() / max(1.0, np.abs(gref).max()) < 1e-5


@pytest.mark.parametrize("P", [1, 4])
def test_model_loads_the_reference_tables(models, P):
    """On the JAX model's own tables and halo lists (sweeps_from_jax) the
    port gives the bits of its own build (the plans are equal)."""
    jm, _, tm, ts = models[P, "f64"]
    parts = tm.parts
    loaded = GreenGaussModel(parts, NVAR, dtype=torch.float64, device="cpu",
                             arrays=sweeps_from_jax(jm))
    for s in ("bulk", "early"):
        assert torch.equal(loaded.step(ts, s, exact=True),
                           tm.step(ts, s, exact=True))


def test_iterate_fn_chains_steps(models):
    _, _, tm, ts = models[4, "f64"]
    got = tm.iterate_fn("early", 2)(*tm.iter_args(ts))
    v = ts
    for _ in range(2):
        v = v + 1e-30 * tm.step(v, "early")[..., :NVAR]
    assert torch.equal(got, v)
    with pytest.raises(CheckError, match="requires the pallas backend"):
        tm.iterate_fn("bulk", 1, solver_mode=True)


def test_model_refuses_peer_and_bad_dtype(mesh):
    parts = partition_mesh(mesh, 2)
    with pytest.raises(CheckError, match="loopback or dist"):
        GreenGaussModel(parts, NVAR, device="cpu", transport="peer")
    with pytest.raises(CheckError, match="float32 or float64"):
        GreenGaussModel(parts, NVAR, device="cpu", dtype=torch.bfloat16)


# ------------------------------------------------------------------- ranks

def test_two_ranks_equal_one_process_bitwise():
    """The ELL model over two gloo ranks (Dist) gives one process's bits,
    f64 exact and f32, every schedule."""
    case = workers.ModelCase(nx=9, ny=8, nz=7, parts=4, nvar=NVAR,
                             device="cpu", backend="gloo",
                             schedules=("bulk", "early", "overlap"))
    jobs = [("ell_outputs", (case, "float64", True)),
            ("ell_outputs", (case, "float32", False))]
    res = launch.spawn(2, workers.batch, (jobs,), timeout_s=120)
    one = workers.batch(jobs)
    for r in res:
        for got, want in zip(r, one):
            assert got["transport"] == "dist/gloo"
            assert want["transport"] == "loopback"
            for s, a in want["outputs"].items():
                np.testing.assert_array_equal(got["outputs"][s], a)
