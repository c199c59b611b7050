"""The port's PSD upwind flux model against the JAX reference.

`PSDFluxModel` of the port (op "flux" of the block sweeps: NV output rows,
the directed-slot form of ops/flux.py) on CPU tensors, i.e. the kernels'
plain versions, against `cfd_proxy_tpu.models.PSDFluxModel` in interpret
mode and the f64 golden `compute_psd_flux`:

- the golden copy: conservation and the upwind limit (the reference's
  tests/test_flux.py cases, on the port's copy);
- the model at P ∈ {1, 3, 4} × {packed, gather} × {bulk, early, overlap}:
  port vs reference within 1e-6 of max(1, max|ref|) per shard (FMA
  contraction and summation grouping of two frameworks), each vs the
  golden within 1e-5 (the reference's gate), early vs bulk and overlap vs
  early within 1e-6 (the reference's cross-schedule gate);
- each plain flux kernel against the JAX sweep kernels (`sweep_blocks(...,
  op="flux")`, `sweep_blocks_overlap(..., op="flux")`) on plans carried
  across by `plans_from_jax`, which carries a flux model's plans unchanged;
- solver mode (`iterate_fn(..., solver_mode=True, sweeps_per_step=2)`)
  against the reference's flux solver runner at P=4;
- a hub mesh (high-valence points) and two random topologies in the manner
  of tests/test_topology_fuzz.py;
- the CLI with `--model flux`.

The card-only flux cases are in tests/test_torch_kernels.py (`-m cuda`).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.models import GreenGaussPallas
from cfd_proxy_tpu.models import PSDFluxModel as JaxFlux
from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch, PSDFluxModel
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops.flux import compute_psd_flux, flux_residual_scale
from cfd_proxy_tpu_torch.ops.plan import NV
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVAR = 5
BP = 128
PORT_TOL = 1e-6      # port vs reference, relative to max(1, max|ref|)
GOLDEN_TOL = 1e-5    # vs the f64 golden (the reference's gate)
SCHED_TOL = 1e-6     # early vs bulk, overlap vs early (the reference's gate)
SWEEP_TOL = 1e-6     # plain kernel vs JAX kernel, relative to max|ref|
SCHEDULES = ("bulk", "early", "overlap")
CASES = [(p, k) for p in (1, 3, 4) for k in ("packed", "gather")]


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(8, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=51)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=7)


def _golden(mesh, state):
    return flux_residual_scale(
        compute_psd_flux(state.astype(np.float64), mesh.faces, mesh.normals),
        mesh.volume, mesh.npoint)


@pytest.fixture(scope="module")
def gref(mesh, gvar):
    return _golden(mesh, gvar)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))     # writable copy


# ------------------------------------------------------------ the golden

def test_flux_golden_copy_conserves(mesh):
    var = make_state(mesh.npoint, NVAR, seed=3)
    res = compute_psd_flux(var, mesh.faces, mesh.normals)
    # conservative: contributions cancel in the global sum
    np.testing.assert_allclose(res.sum(axis=0), np.zeros(NVAR), atol=1e-10)


def test_flux_golden_copy_upwind_limit(mesh):
    """Constant q: the dissipation term vanishes, the central term
    0.5·(uLn + uRn)·q survives."""
    var = np.ones((mesh.npoint, NVAR))
    res = compute_psd_flux(var, mesh.faces, mesh.normals)
    p0, p1 = mesh.faces[:, 0], mesh.faces[:, 1]
    uLn = np.einsum("fd,fd->f", var[p0][:, :3], mesh.normals)
    uRn = np.einsum("fd,fd->f", var[p1][:, :3], mesh.normals)
    F = 0.5 * (uLn + uRn)[:, None] * np.ones((1, NVAR))
    want = np.zeros_like(res)
    np.add.at(want, p0, F)
    np.subtract.at(want, p1, F)
    np.testing.assert_allclose(res, want, rtol=1e-9, atol=1e-10)


# ------------------------------------------- the model vs the reference

@pytest.fixture(scope="module")
def runs(mesh, gvar):
    """(P, kernel) → both flux models and every schedule's output, built on
    first use."""
    cache = {}

    def get(npart, kernel):
        if (npart, kernel) not in cache:
            parts = partition_mesh(mesh, npart)
            jm = JaxFlux(parts, NVAR, bp=BP, interpret=True, kernel=kernel)
            js = jm.distribute_state(gvar)
            tm = PSDFluxModel(parts, NVAR, bp=BP, kernel=kernel, device="cpu")
            ts = tm.distribute_state(gvar)
            cache[(npart, kernel)] = {
                "jm": jm, "tm": tm,
                "jax": {s: np.asarray(jm.step(js, s)) for s in SCHEDULES},
                "port": {s: tm.step(ts, s).numpy() for s in SCHEDULES},
            }
        return cache[(npart, kernel)]

    return get


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("npart,kernel", CASES)
def test_flux_model_matches_reference_and_golden(runs, gref, npart, kernel,
                                                 schedule):
    r = runs(npart, kernel)
    tm, jm = r["tm"], r["jm"]
    assert tm.op == jm.op == "flux" and tm.kernel == kernel
    got, want = r["port"][schedule], r["jax"][schedule]
    assert got.shape == want.shape == (npart, NV, tm.ndev)
    for d in range(npart):        # shard by shard
        scale = max(1.0, np.abs(want[d]).max())
        assert np.abs(got[d] - want[d]).max() / scale < PORT_TOL, d
    denom = max(1.0, np.abs(gref).max())
    for name, g in (("port", tm.gather_global(torch.from_numpy(got))),
                    ("jax", jm.gather_global(want))):
        assert g.shape == gref.shape == (sum(p.nowned for p in tm.parts),
                                         NVAR)
        assert np.abs(g - gref).max() / denom < GOLDEN_TOL, name
    prev = {"early": "bulk", "overlap": "early"}.get(schedule)
    if prev is not None:
        scale = max(1.0, np.abs(r["port"]["bulk"]).max())
        assert np.abs(got - r["port"][prev]).max() / scale < SCHED_TOL


def test_flux_ghosts_match_owner(runs):
    """After each schedule's exchange, every ghost column of the flux
    equals its owner's column, bitwise."""
    r = runs(4, "packed")
    tm = r["tm"]
    for s in SCHEDULES:
        g = r["port"][s]
        checked = 0
        for i, p in enumerate(tm.parts):
            for e in p.comm:
                q = tm.parts[e.partner]
                back = [x for x in q.comm
                        if x.partner == p.part_id and x.round == e.round]
                send_cols = tm.locmap[e.partner][back[0].sendidx]
                recv_cols = tm.locmap[i][e.recvidx]
                np.testing.assert_array_equal(g[i][:, recv_cols],
                                              g[e.partner][:, send_cols])
                checked += len(send_cols)
        assert checked > 0, s


def test_flux_model_refuses_too_few_vars(mesh):
    with pytest.raises(CheckError, match="nvar >= 3"):
        PSDFluxModel(partition_mesh(mesh, 1), 2, bp=BP, device="cpu")
    with pytest.raises(CheckError, match="op"):
        GreenGaussTorch(partition_mesh(mesh, 1), 3, bp=BP, op="ell",
                        device="cpu")


# ------------------------------------------------ plain flux kernels

@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_plans_from_jax_carries_flux_plans_unchanged(mesh, kernel):
    """The plans do not depend on the op: a flux model's converted arrays
    equal the Green-Gauss model's on the same parts, and the port's flux
    model built from them equals the one built from its own host layer."""
    parts = partition_mesh(mesh, 4)
    jf = JaxFlux(parts, NVAR, bp=BP, interpret=True, kernel=kernel)
    jg = GreenGaussPallas(parts, NVAR, bp=BP, interpret=True, kernel=kernel)
    af, ag = plans_from_jax(jf), plans_from_jax(jg)
    assert sorted(af) == sorted(ag)
    for k in af:
        if k == "classes":
            for c in af[k]:
                for n in af[k][c]:
                    np.testing.assert_array_equal(af[k][c][n], ag[k][c][n],
                                                  err_msg=f"{c}.{n}")
        elif k in ("locmap", "perms"):
            for x, y in zip(af[k], ag[k]):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(af[k], ag[k], err_msg=k)
    conv = PSDFluxModel.from_arrays(jf.parts, NVAR, af, device="cpu")
    own = PSDFluxModel(parts, NVAR, bp=BP, kernel=kernel, device="cpu")
    assert conv.op == "flux" and conv.rows == NV
    g = make_state(mesh.npoint, NVAR, seed=4)
    for s in SCHEDULES:
        assert torch.equal(conv.step(conv.distribute_state(g), s),
                           own.step(own.distribute_state(g), s)), s


@pytest.fixture(scope="module")
def jax_p4(mesh, gvar):
    """Four-shard JAX flux models (packed, gather) with every table class,
    their plans in the port's arrays and their states."""
    out = {}
    for kernel in ("packed", "gather"):
        jm = JaxFlux(partition_mesh(mesh, 4), NVAR, bp=BP, interpret=True,
                     kernel=kernel)
        js = jm.distribute_state(gvar)
        out[kernel] = (jm, js, plans_from_jax(jm), state_from_jax(js))
    return out


def _jax_table(js, cls, packed):
    """The JAX table of a class in the port's layout (packed: compact
    (P, nb, NV, L); gather: the ext table as it is)."""
    tbl = np.asarray(js[f"tbl_{cls}"])
    if packed and tbl.ndim == 5:
        tbl = np.concatenate([tbl[:, :, k] for k in range(tbl.shape[2])], -1)
    return tbl


def _port_operands(arrays, cls, kernel):
    a = arrays["classes"][cls]
    head = (_t(a["slot_idx"]),) if kernel == "gather" else ()
    return (*head, _t(a["slot_w"]), _t(a["scale"]), _t(a["block_ids"]),
            _t(bs.slot_table(a["wks"])))


@pytest.mark.parametrize("kernel,cls,with_init", [
    ("packed", "bulk", False), ("packed", "boundary", True),
    ("packed", "interior", True), ("gather", "bulk", False),
    ("gather", "boundary", True), ("gather", "interior", True)])
def test_flux_sweep_ref_matches_jax_sweep(jax_p4, kernel, cls, with_init):
    """K1-flux / K2-flux plain versions, without init (bulk) and with a
    random init (the early schedule's plans), shard by shard against the
    reference's sweep_blocks(op="flux")."""
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep

    jm, js, arrays, var_T = jax_p4[kernel]
    packed = kernel == "packed"
    ep, ks, nb = jm._dims[cls]
    P, ndev = var_T.shape[0], var_T.shape[2]
    init = (np.random.default_rng(9).standard_normal((P, NV, ndev))
            .astype(np.float32) if with_init else None)
    tbl = _jax_table(js, cls, packed)
    ref = []
    for d in range(P):
        pa = {k: jnp.asarray(np.asarray(v)[d])
              for k, v in jm._plans_dev[cls].items()}
        pa["srcs" if packed else "exts"] = jnp.asarray(
            np.asarray(js[f"tbl_{cls}"])[d])
        ref.append(np.asarray(jax_sweep(
            jnp.asarray(var_T[d]), pa, bp=jm.bp, ep=ep, kslots=ks,
            nblocks=nb, interpret=True, op="flux", packed=packed,
            wks=jm._wks[cls],
            init=None if init is None else jnp.asarray(init[d]))))
    ref = np.stack(ref)
    sweep = bs.sweep_blocks if packed else bs.sweep_blocks_gather
    before = (getattr(sweep, "flux_launches"),
              getattr(sweep, "flux_init_launches"))
    got = sweep(_t(var_T), _t(tbl), *_port_operands(arrays, cls, kernel),
                init=None if init is None else _t(init), op="flux").numpy()
    assert got.shape == ref.shape == (P, NV, ndev)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= SWEEP_TOL * scale
    # the wrapper on CPU tensors is the plain version and launches nothing
    assert before == (sweep.flux_launches, sweep.flux_init_launches)


@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_flux_overlap_ref_matches_jax_kernel(mesh, gvar, kernel):
    """K3-flux's plain version (both bodies) against the reference's fused
    kernel with op="flux", at one shard with two self-send phases of
    random payloads, under shard_map on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec
    from cfd_proxy_tpu.models.gradients_pallas import AXIS, _shard_map
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks_overlap

    packed = kernel == "packed"
    jm = JaxFlux(partition_mesh(mesh, 1), NVAR, bp=BP, interpret=True,
                 force_rdma=True, kernel=kernel)
    js = jm.distribute_state(gvar, schedules=["overlap"])
    ep, ks, nb = jm._dims["interior"]
    rng = np.random.default_rng(5)
    init = rng.standard_normal((1, NV, jm.layout.ndev)).astype(np.float32)
    send = rng.standard_normal((1, 2, NV, jm.layout.s_max)).astype(
        np.float32)
    dsts = np.zeros((1, 2), np.int32)
    keys = list(jm._plans_dev["interior"])

    def body(v, tbl, ini, sb, d, s, *plans):
        pa = {k: x[0] for k, x in zip(keys, plans)}
        pa["srcs" if packed else "exts"] = tbl[0]
        g, r = sweep_blocks_overlap(
            v[0], pa, bp=jm.bp, ep=ep, kslots=ks, nblocks=nb, init=ini[0],
            sendbufs=sb[0], dsts=d[0], srcs=s[0], interpret=True, op="flux",
            packed=packed, wks=jm._wks["interior"])
        return g[None], r[None]

    one = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    spec = PartitionSpec(AXIS)
    fn = jax.jit(_shard_map(body, one, in_specs=(spec,) * (6 + len(keys)),
                            out_specs=(spec, spec)))
    g_ref, r_ref = (np.asarray(x) for x in fn(
        js["var_T"], js["tbl_interior"], jnp.asarray(init),
        jnp.asarray(send), jnp.asarray(dsts), jnp.asarray(dsts),
        *jm._plans_dev["interior"].values()))
    arrays = plans_from_jax(jm)
    fused = bs.sweep_blocks_overlap if packed else \
        bs.sweep_blocks_overlap_gather
    g, r = fused(_t(state_from_jax(js)),
                 _t(_jax_table(js, "interior", packed)),
                 *_port_operands(arrays, "interior", kernel), _t(init),
                 _t(send), _t(dsts), _t(dsts), op="flux")
    scale = np.abs(g_ref).max()
    assert g.shape == (1, NV, jm.layout.ndev) and scale > 0
    assert np.abs(g.numpy() - g_ref).max() <= SWEEP_TOL * scale
    np.testing.assert_array_equal(r.numpy(), r_ref)


def test_flux_body_matches_directed_slot_form():
    """The plain flux body on one block against the formula written out
    lane by lane in f64: per live slot, udw = own[:3]·w, uow = src[:3]·w,
    a = max(|udw|, |uow|), acc += 0.5(udw·own + uow·src) − 0.5·a·(src −
    own); a narrow slot sums over its own prefix only, a zero-width slot
    adds nothing, unlisted blocks stay zero."""
    rng = np.random.default_rng(0)
    bp, wks, ndev = 128, (128, 0, 64, 128), 3 * 128
    L = sum(wks)
    var_T = rng.standard_normal((1, NV, ndev)).astype(np.float32)
    srcs = rng.standard_normal((1, 1, NV, L)).astype(np.float32)
    slot_w = rng.standard_normal((1, 1, 3, L)).astype(np.float32)
    scale = rng.random((1, 1, 1, bp)).astype(np.float32)
    got = bs.sweep_blocks(_t(var_T), _t(srcs), _t(slot_w), _t(scale),
                          _t(np.array([[1]], np.int32)),
                          _t(bs.slot_table(wks)), op="flux").numpy()[0]
    own = var_T[0, :, bp:2 * bp].astype(np.float64)
    acc = np.zeros((NV, bp))
    off = 0
    for w in wks:
        for lane in range(w):
            o, s = own[:, lane], srcs[0, 0, :, off + lane].astype(np.float64)
            wk = slot_w[0, 0, :, off + lane]
            udw, uow = o[:3] @ wk, s[:3] @ wk
            a = max(abs(udw), abs(uow))
            acc[:, lane] += 0.5 * (udw * o + uow * s) - 0.5 * a * (s - o)
        off += w
    want = acc * scale[0, 0]
    np.testing.assert_allclose(got[:, bp:2 * bp], want, rtol=1e-5, atol=1e-5)
    assert not got[:, :bp].any() and not got[:, 2 * bp:].any()


def test_flux_wrappers_check_rows():
    """Under op "flux" init, sendbufs and the output have NV rows: gg-sized
    buffers raise, and so does an unknown op."""
    rng = np.random.default_rng(1)
    P, bp, nb, L, s_max = 2, 128, 2, 256, 128

    def f32(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32))

    sweep = (f32(P, NV, nb * bp), f32(P, nb, NV, L), f32(P, nb, 3, L),
             _t(rng.random((P, nb, 1, bp)).astype(np.float32)),
             _t(np.tile(np.arange(nb, dtype=np.int32), (P, 1))),
             _t(bs.slot_table((128, 128))))
    push = (_t(np.array([[1], [0]], np.int32)),) * 2
    out = bs.sweep_blocks(*sweep, op="flux")
    assert out.shape == (P, NV, nb * bp)
    init = f32(P, NV, nb * bp)
    assert bs.sweep_blocks(*sweep, init=init, op="flux") is init
    g, r = bs.sweep_blocks_overlap(*sweep, init, f32(P, 1, NV, s_max), *push,
                                   op="flux")
    assert g is init and r.shape == (P, 1, NV, s_max)
    with pytest.raises(CheckError):
        bs.sweep_blocks(*sweep, init=f32(P, 3 * NV, nb * bp), op="flux")
    with pytest.raises(CheckError):
        bs.sweep_blocks_overlap(*sweep, init, f32(P, 1, 3 * NV, s_max),
                                *push, op="flux")
    with pytest.raises(CheckError, match="unknown sweep op"):
        bs.sweep_blocks(*sweep, op="grad")


# ---------------------------------------------------------- solver mode

@pytest.mark.parametrize("kernel,schedule", [("packed", "bulk"),
                                             ("gather", "overlap")])
def test_flux_solver_mode_matches_reference(mesh, gvar, kernel, schedule):
    """The solver-mode runner (table rebuild, two sweeps + updates, var
    exchange) over two steps at P=4 against the reference's flux runner;
    refresh_state of an owned-only update matches the reference's and the
    golden of the updated state (the flux is not linear in the state: the
    golden is computed anew)."""
    import jax.numpy as jnp

    jm = JaxFlux(partition_mesh(mesh, 4), NVAR, bp=BP, interpret=True,
                 kernel=kernel)
    tm = PSDFluxModel.from_arrays(jm.parts, NVAR, plans_from_jax(jm),
                                  device="cpu")
    js = jm.distribute_state(gvar)
    ts = tm.distribute_state(gvar)
    got = tm.iterate_fn(schedule, 2, solver_mode=True, sweeps_per_step=2)(
        *tm.iter_args(ts))
    want = np.asarray(jm.iterate_fn(schedule, 2, solver_mode=True,
                                    sweeps_per_step=2)(*jm.iter_args(js)))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() / scale < PORT_TOL
    # owned columns x1.5, ghosts stale: the var exchange refreshes them
    var = state_from_jax(js)
    owned = np.zeros((4, 1, tm.ndev), bool)
    for i, p in enumerate(tm.parts):
        owned[i, 0, : p.nowned] = True
    mixed = np.where(owned, var * np.float32(1.5), var)
    ts2 = tm.refresh_state(torch.from_numpy(mixed.copy()))
    js2 = jm.refresh_state(jnp.asarray(mixed))
    np.testing.assert_array_equal(ts2["var_T"].numpy(), state_from_jax(js2))
    g = tm.step(ts2, schedule)
    gref = _golden(mesh, gvar.astype(np.float32) * np.float32(1.5))
    err = np.abs(tm.gather_global(g) - gref).max()
    assert err / max(1.0, np.abs(gref).max()) < GOLDEN_TOL
    # the golden of gvar scaled by 1.5 is not 1.5x its golden
    assert np.abs(1.5 * _golden(mesh, gvar) - gref).max() > 1e-3


# ---------------------------------------- hub mesh, random topologies

def _check_all(tm, gv, gold):
    """Every schedule against the golden, the schedules against each other
    and every ghost column against its owner's."""
    st = tm.distribute_state(gv)
    outs = {s: tm.step(st, s).numpy() for s in SCHEDULES}
    denom = max(1.0, np.abs(gold).max())
    for s, g in outs.items():
        err = np.abs(tm.gather_global(torch.from_numpy(g)) - gold).max()
        assert err / denom < GOLDEN_TOL, s
    scale = max(1.0, np.abs(outs["bulk"]).max())
    assert np.abs(outs["early"] - outs["bulk"]).max() / scale < SCHED_TOL
    assert np.abs(outs["overlap"] - outs["early"]).max() / scale < SCHED_TOL
    g = outs["early"]
    for i, p in enumerate(tm.parts):
        for e in p.comm:
            back = [x for x in tm.parts[e.partner].comm
                    if x.partner == p.part_id and x.round == e.round]
            np.testing.assert_array_equal(
                g[i][:, tm.locmap[i][e.recvidx]],
                g[e.partner][:, tm.locmap[e.partner][back[0].sendidx]])
    return outs


@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_flux_hub_mesh(kernel):
    """High-valence hubs raise the slot count; it stays inside the sweep's
    slot table (MAX_SLOTS), and the flux matches the golden and the
    reference's bulk step."""
    m = generate_mesh(8, 7, 6, jitter=0.05, diag_frac=0.2, hub_frac=0.05,
                      hub_extra=8, seed=3)
    gv = make_state(m.npoint, NVAR, seed=11)
    parts = partition_mesh(m, 3, ghost_layers=2)
    tm = PSDFluxModel(parts, NVAR, bp=BP, kernel=kernel, device="cpu")
    ks = max(len(w) for w in tm.wks.values())
    base = PSDFluxModel(partition_mesh(generate_mesh(
        8, 7, 6, jitter=0.05, diag_frac=0.2, seed=3), 3, ghost_layers=2),
        NVAR, bp=BP, kernel=kernel, device="cpu")
    assert max(len(w) for w in base.wks.values()) < ks <= bs.MAX_SLOTS
    outs = _check_all(tm, gv, _golden(m, gv))
    jm = JaxFlux(parts, NVAR, bp=BP, interpret=True, kernel=kernel)
    want = np.asarray(jm.step(jm.distribute_state(gv, schedules=["bulk"]),
                              "bulk"))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(outs["bulk"] - want).max() / scale < PORT_TOL


def test_flux_slot_table_limit_raises_by_name():
    """A plan with more slots than the sweep's table holds is refused by
    name before any launch."""
    rng = np.random.default_rng(2)
    K = bs.MAX_SLOTS + 1
    var_T = _t(rng.standard_normal((1, NV, 128)).astype(np.float32))
    with pytest.raises(CheckError, match="1 <= K <= 64"):
        bs.sweep_blocks(var_T, _t(np.zeros((1, 1, NV, 128 * K), np.float32)),
                        _t(np.zeros((1, 1, 3, 128 * K), np.float32)),
                        _t(np.ones((1, 1, 1, 128), np.float32)),
                        _t(np.zeros((1, 1), np.int32)),
                        _t(bs.slot_table((128,) * K)), op="flux")


@pytest.mark.parametrize("seed", [0, 1])
def test_flux_fuzz_topology(seed):
    """Random meshes (with or without hubs), adversarial owner maps
    (scattered at random, striped by global id), P in 2..8, 1-3 ghost layers, nvar 3..7:
    the port's flux model against the golden, across schedules, ghosts
    against owners, and the reference's bulk step."""
    rng = np.random.default_rng(100 + seed)
    nx, ny, nz = (int(x) for x in rng.integers(4, 8, size=3))
    m = generate_mesh(nx, ny, nz, jitter=0.05,
                      diag_frac=float(rng.uniform(0, 0.4)),
                      hub_frac=float(rng.choice([0.0, 0.05])), hub_extra=8,
                      seed=int(seed))
    P = int(rng.integers(2, 9))
    style = ("random", "striped")[seed]
    if style == "random":
        owner = rng.integers(0, P, size=m.npoint).astype(np.int32)
    else:
        owner = (np.arange(m.npoint) * P // m.npoint).astype(np.int32)
    owner[:P] = np.arange(P, dtype=np.int32)   # every part owns a point
    nvar = int(rng.integers(3, 8))
    kernel = ("packed", "gather")[seed % 2]
    parts = partition_mesh(m, P, ghost_layers=int(rng.integers(1, 4)),
                           owner=owner)
    gv = make_state(m.npoint, nvar, seed=seed)
    tm = PSDFluxModel(parts, nvar, bp=BP, kernel=kernel, device="cpu")
    outs = _check_all(tm, gv, _golden(m, gv))
    jm = JaxFlux(parts, nvar, bp=BP, interpret=True, kernel=kernel)
    want = np.asarray(jm.step(jm.distribute_state(gv, schedules=["bulk"]),
                              "bulk"))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(outs["bulk"] - want).max() / scale < PORT_TOL


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("extra", [[], ["--kernel", "gather",
                                        "--solver-mode"]])
def test_solver_cli_flux(extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--model",
         "flux", "--nx", "8", "--ny", "8", "--nz", "8", "--parts", "4",
         "--device", "cpu", "--iters", "2", "--json", *extra],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr
    d = json.loads(res.stdout.strip().splitlines()[-1])
    assert d["model"] == "flux" and d["npart"] == 4
    assert d["solver_mode"] == bool(extra)
    v = d["verification"]
    assert v["bulk_vs_golden_relmax"] <= 1e-5
    assert v["early_vs_bulk_maxabs"] == 0 and v["overlap_vs_bulk_maxabs"] == 0
