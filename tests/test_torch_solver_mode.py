"""Solver mode of the port against the JAX model, both kernel formulations.

`GreenGaussTorch` on CPU tensors (the kernels' plain versions) built from
a `GreenGaussPallas(..., interpret=True)` model's own plan data
(`convert.plans_from_jax`), so both packages compute on identical plans:

- kcompact on and off give bitwise-equal gradients under the gather
  kernel (the prefix widths only skip lanes whose weights are zero);
- `refresh_state` of an owned-only 1.5x state update: the var halo
  exchange equals the reference's bitwise, the rebuilt ext tables too,
  and the next step matches the golden of 1.5·gvar;
- `refresh_state` of a freshly distributed state reproduces its host
  ghost fill and tables bitwise;
- the solver-mode runner (`iterate_fn(..., solver_mode=True)`: table
  rebuild, sweeps + update, var exchange) equals the same chain composed
  through `step` and `refresh_state`, bitwise, and the reference's runner;
- a pseudo-time loop with a real update (v − 1e-3·g, five overlap steps,
  as `examples/pseudo_time_stepping.py` runs it) matches the reference's
  within 1e-6 relative;
- sweeps_per_step > 1 without solver mode raises, as in the reference.
"""

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.models import GreenGaussPallas
from cfd_proxy_tpu.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy_tpu_torch.utils.errors import CheckError
from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops.plan import NV

torch.set_num_threads(1)

NVAR = 5
BP = 128
PORT_TOL = 1e-6      # port vs reference, relative to max(1, max|ref|)
GOLDEN_TOL = 1e-5    # vs the f64 golden (the reference's gate)
KERNELS = ("packed", "gather")


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


def _golden(mesh, state):
    g = compute_gradients_gg(state.astype(np.float64), mesh.faces,
                             mesh.normals)
    return scale_gradients(g, mesh.volume, mesh.npoint).reshape(
        mesh.npoint, -1)


@pytest.fixture(scope="module")
def models(mesh):
    """(P, kernel) → (JAX model, port model on its plan data), built on
    first use."""
    cache = {}

    def get(npart, kernel):
        if (npart, kernel) not in cache:
            parts = partition_mesh(mesh, npart, ghost_layers=1)
            jm = GreenGaussPallas(parts, NVAR, bp=BP, interpret=True,
                                  kernel=kernel)
            tm = GreenGaussTorch.from_arrays(jm.parts, NVAR,
                                             plans_from_jax(jm), device="cpu")
            assert tm.kernel == kernel
            cache[(npart, kernel)] = jm, tm
        return cache[(npart, kernel)]

    return get


def _owned_mask(model) -> np.ndarray:
    """(P, 1, ndev) bool: each shard's owned columns [0, nowned)."""
    mask = np.zeros((len(model.parts), 1, model.ndev), bool)
    for i, p in enumerate(model.parts):
        mask[i, 0, : p.nowned] = True
    return mask


def test_kcompact_gather_matches_uncompacted(mesh, gvar):
    """Under the gather kernel kcompact only skips (lane, slot) pairs whose
    weights are zero: every schedule's gathered gradients equal the
    uncompacted model's bitwise, and the reference's within 1e-6."""
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    off = GreenGaussTorch(parts, NVAR, bp=256, kcompact=False,
                          kernel="gather", device="cpu")
    on = GreenGaussTorch(parts, NVAR, bp=256, kcompact=True,
                         kernel="gather", device="cpu")
    # the degree sort must genuinely narrow at least one class's slots
    assert any(sum(w) < len(w) * on.bp for w in on.wks.values())
    assert all(sum(w) == len(w) * off.bp for w in off.wks.values())
    jm = GreenGaussPallas(parts, NVAR, bp=256, interpret=True,
                          kernel="gather", kcompact=True)
    js = jm.distribute_state(gvar)
    s_off, s_on = off.distribute_state(gvar), on.distribute_state(gvar)
    for s in ("bulk", "early", "overlap", "nocomm"):
        g_on = on.gather_global(on.step(s_on, s))
        np.testing.assert_array_equal(
            g_on, off.gather_global(off.step(s_off, s)), err_msg=s)
        want = jm.gather_global(np.asarray(jm.step(js, s)))
        scale = max(1.0, np.abs(want).max())
        assert np.abs(g_on - want).max() / scale < PORT_TOL, s


@pytest.mark.parametrize("kernel", KERNELS)
def test_refresh_state_owned_update_matches_reference(mesh, gvar, models,
                                                      kernel):
    """Owned columns scaled by 1.5 with stale ghosts: refresh_state's var
    exchange equals the reference's bitwise (ghosts refreshed from their
    owners), the gather kernel's ext tables equal the reference's, and the
    next overlap step matches the golden of 1.5·gvar."""
    import jax.numpy as jnp

    jm, tm = models(4, kernel)
    js = jm.distribute_state(gvar)
    var = state_from_jax(js)
    mixed = np.where(_owned_mask(tm), var * np.float32(1.5), var)
    assert not np.array_equal(mixed, var * np.float32(1.5))  # stale ghosts
    js2 = jm.refresh_state(jnp.asarray(mixed))
    ts2 = tm.refresh_state(torch.from_numpy(mixed.copy()))
    assert sorted(ts2["tables"]) == ["boundary", "bulk", "interior"]
    np.testing.assert_array_equal(ts2["var_T"].numpy(), state_from_jax(js2))
    scaled = gvar.astype(np.float32) * np.float32(1.5)   # as on the device
    np.testing.assert_array_equal(ts2["var_T"].numpy(),
                                  state_from_jax(jm.distribute_state(
                                      scaled, schedules=["bulk"])))
    if kernel == "gather":
        for c, t in ts2["tables"].items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(js2[f"tbl_{c}"]))
    got = tm.step(ts2, "overlap")
    want = np.asarray(jm.step(js2, "overlap"))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() / scale < PORT_TOL
    gref = _golden(mesh, 1.5 * gvar)
    err = np.abs(tm.gather_global(got) - gref).max()
    assert err / max(1.0, np.abs(gref).max()) < GOLDEN_TOL


@pytest.mark.parametrize("npart", [4, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_refresh_state_reproduces_host_ghost_fill(mesh, gvar, models, npart,
                                                  kernel):
    """refresh_state of a freshly distributed state changes nothing: the
    exchanged ghost columns equal the host fill (and the reference's
    distributed state) bitwise, and so do the rebuilt tables."""
    jm, tm = models(npart, kernel)
    st = tm.distribute_state(gvar)
    host = st["var_T"].clone()
    assert tm.moves
    st2 = tm.refresh_state(st["var_T"].clone(), schedules=["overlap"])
    assert sorted(st2["tables"]) == ["boundary", "interior"]
    assert torch.equal(st2["var_T"], host)
    np.testing.assert_array_equal(
        host.numpy(), state_from_jax(jm.distribute_state(
            gvar, schedules=["bulk"])))
    for c in st2["tables"]:
        assert torch.equal(st2["tables"][c], st["tables"][c]), c


def _manual(tm, state, schedule, n, sweeps):
    """The solver loop composed through the public API: per step, sweeps x
    (step + toy update) against the step's tables, then refresh_state."""
    v = state["var_T"]
    tables = state["tables"]
    for _ in range(n):
        for _ in range(sweeps):
            g = tm.step({"var_T": v, "tables": tables}, schedule)
            v = v + 1e-30 * g[:, :NV]
        st = tm.refresh_state(v)
        v, tables = st["var_T"], st["tables"]
    return v


@pytest.mark.parametrize("kernel,schedule,sweeps", [
    ("packed", "bulk", 1),
    ("gather", "bulk", 1),
    ("packed", "overlap", 1),
    ("gather", "overlap", 1),
    ("gather", "bulk", 2),
    ("packed", "early", 2),
])
def test_solver_iterate_matches_manual_composition(gvar, models, kernel,
                                                   schedule, sweeps):
    """The solver-mode runner equals the manual step/update/refresh chain
    bitwise over two steps, and the reference's runner within 1e-6."""
    jm, tm = models(4, kernel)
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    got = tm.iterate_fn(schedule, 2, solver_mode=True,
                        sweeps_per_step=sweeps)(*tm.iter_args(st))
    assert torch.equal(st["var_T"], var0)         # the caller's state stays
    assert torch.equal(got, _manual(tm, st, schedule, 2, sweeps))
    js = jm.distribute_state(gvar)
    want = np.asarray(jm.iterate_fn(schedule, 2, solver_mode=True,
                                    sweeps_per_step=sweeps)(
        *jm.iter_args(js)))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() / scale < PORT_TOL


@pytest.mark.parametrize("kernel", KERNELS)
def test_pseudo_time_loop_matches_reference(gvar, models, kernel):
    """Five overlap steps of v ← v − 1e-3·g[:, :NV] with refresh_state
    between them (examples/pseudo_time_stepping.py), port against
    reference; the update moves the state well past f32 rounding, so the
    update path and the per-step rebuild are really exercised."""
    import jax.numpy as jnp

    jm, tm = models(4, kernel)
    js = jm.distribute_state(gvar, schedules=["overlap"])
    ts = tm.distribute_state(gvar, schedules=["overlap"])
    dt = jnp.float32(1e-3)
    for _ in range(5):
        js = jm.refresh_state(
            js["var_T"] - dt * jm.step(js, "overlap")[:, :NV, :],
            schedules=["overlap"])
        ts = tm.refresh_state(ts["var_T"] - 1e-3 * tm.step(ts, "overlap")
                              [:, :NV], schedules=["overlap"])
    want = state_from_jax(js)
    got = ts["var_T"].numpy()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < PORT_TOL
    moved = np.abs(got - state_from_jax(jm.distribute_state(
        gvar, schedules=["bulk"]))).max()
    assert moved > 1e-3 * scale


def test_sweeps_per_step_requires_solver_mode(gvar, models):
    _, tm = models(4, "gather")
    st = tm.distribute_state(gvar, schedules=["bulk"])
    with pytest.raises(CheckError, match="solver_mode"):
        tm.iterate_fn("bulk", 1, sweeps_per_step=2)
    with pytest.raises(CheckError, match=">= 1"):
        tm.iterate_fn("bulk", 1, solver_mode=True, sweeps_per_step=0)
    with pytest.raises(CheckError, match="unknown schedule"):
        tm.iterate_fn("eager", 1, solver_mode=True)
    # solver mode rebuilds its own tables: a bulk-only state runs overlap
    v = tm.iterate_fn("overlap", 1, solver_mode=True)(*tm.iter_args(st))
    assert v.shape == st["var_T"].shape
    with pytest.raises(CheckError, match="must be"):
        tm.refresh_state(st["var_T"][:, :5].contiguous())
