"""The main path's step without its torch glue, on the CPU.

- `ops.update`: the chained update's plain version, `chain_update_ref`, is
  the models' two-op update `torch.add(v, c * g[:, :NV])` bit for bit (f32
  and bf16 g, gradient (24 rows) and flux (8 rows) outputs, with and
  without `out`), its wrapper on CPU tensors runs it and counts nothing,
  and neither writes v; against the reference's `v + c * g[:, :NV, :]` in
  `jax.numpy` on the same numpy inputs: bit for bit for f32 g; for bf16 g
  the products within one bf16 ulp (JAX rounds the weak-typed scalar to
  bf16 before the product, torch takes it in f32) and the sums within that
  ulp plus one f32 ulp of the sum;
- the models' chained state after n steps at coupling C (9×8×7 mesh, bp
  128, P ∈ {1, 3}, every schedule, packed and gather, gg and flux, f32 and
  bf16 gradients, solver mode) bit for bit what the step gave before the
  boundary fill (the packed model's; the gather model keeps its fill) and
  the two-op update were taken out, rebuilt here: the boundary class swept
  with init on a `torch.zeros`, and the update as two torch operations;
- the zero-filled sweeps (`sweep_blocks`, `sweep_blocks_gather` without
  init) bit for bit their init form on a zero output, for every class of
  the plans at P ∈ {1, 3, 8} (the boundary class at P=1 lists one block,
  at P=8 it leaves long gaps), f32 and bf16 outputs: bit patterns, so a
  −0.0 against a +0.0 would show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import (CLASSES, GreenGaussTorch,
                                                  PSDFluxModel)
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops import update
from cfd_proxy_tpu_torch.ops.plan import NV

torch.set_num_threads(1)

NVAR = 5
BP = 128
C = 0.1              # a coupling that makes the state carry the gradients
STEPS = 3
SCHEDULES = ("bulk", "early", "overlap", "nocomm")
BF = "bfloat16"


def bits(t: torch.Tensor) -> np.ndarray:
    """The bit patterns of an f32 or bf16 tensor."""
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


def _inputs(rows, g_dtype, seed=3, P=2, ndev=96):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((P, NV, ndev)).astype(np.float32)
    g = (rng.standard_normal((P, rows, ndev)) * 3).astype(np.float32)
    g_t = torch.from_numpy(g).to(g_dtype)
    return torch.from_numpy(v), g_t


UPDATE_CASES = [pytest.param(rows, dt, with_out,
                             id=f"rows{rows}-{str(dt)[6:]}-"
                                f"{'out' if with_out else 'new'}")
                for rows in (3 * NV, NV)
                for dt in (torch.float32, torch.bfloat16)
                for with_out in (False, True)]


@pytest.mark.parametrize("rows,g_dtype,with_out", UPDATE_CASES)
def test_chain_update_is_the_two_op_update(rows, g_dtype, with_out):
    v, g = _inputs(rows, g_dtype)
    v0, g0 = v.clone(), g.clone()
    want = torch.add(v, C * g[:, :NV])
    before = (update.chain_update.launches, update.chain_update.g16_launches)
    for fn in (update.chain_update_ref, update.chain_update):
        out = torch.full_like(v, float("nan")) if with_out else None
        got = fn(v, g, C, out=out)
        assert got.dtype == torch.float32 and got.shape == v.shape
        assert np.array_equal(bits(got), bits(want))
        if with_out:
            assert got is out
        assert torch.equal(v, v0) and torch.equal(g, g0)   # v not written
    # on CPU tensors the wrapper is the plain version and launches nothing
    assert before == (update.chain_update.launches,
                      update.chain_update.g16_launches)


@pytest.mark.parametrize("rows,g_dtype", [
    pytest.param(r, d, id=f"rows{r}-{str(d)[6:]}")
    for r in (3 * NV, NV) for d in (torch.float32, torch.bfloat16)])
def test_chain_update_matches_jax(rows, g_dtype):
    v, g = _inputs(rows, g_dtype, seed=11)
    got = update.chain_update(v, g, C)
    if g_dtype == torch.float32:
        jv = jnp.asarray(v.numpy())
        jg = jnp.asarray(g.numpy())
        want = np.asarray(jv + C * jg[:, :NV, :])
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32))
        return
    # bf16 g: numpy has no bf16, so g travels as its bit patterns
    g16 = g.view(torch.int16).numpy().view(np.uint16)
    jg = jnp.asarray(g16).view(jnp.bfloat16)
    jprod = C * jg[:, :NV, :]
    assert jprod.dtype == jnp.bfloat16          # the weak scalar's type
    want = np.asarray(jnp.asarray(v.numpy()) + jprod)
    prod_j = np.asarray(jprod.astype(jnp.float32))
    prod_t = (C * g[:, :NV]).float().numpy()
    ulp16 = bs.bf16_ulp(torch.from_numpy(np.abs(prod_t))).numpy()
    assert (np.abs(prod_t - prod_j) <= ulp16).all()
    tol = ulp16 + np.spacing(np.abs(want))
    assert (np.abs(got.numpy() - want) <= tol).all()
    # and it does differ somewhere: the two roundings are not the same
    assert not np.array_equal(prod_t, prod_j)


def test_chain_update_refuses_bad_operands():
    v, g = _inputs(3 * NV, torch.float32)
    from cfd_proxy_tpu_torch.utils.errors import CheckError

    with pytest.raises(CheckError, match="v must be"):
        update.chain_update(v[:, :4], g, C)
    with pytest.raises(CheckError, match="g must be"):
        update.chain_update(v, g[:, :4], C)
    with pytest.raises(CheckError, match="g must be"):
        update.chain_update(v, g.transpose(0, 1).contiguous(), C)
    with pytest.raises(CheckError, match="out must be"):
        update.chain_update(v, g, C, out=torch.empty_like(v).double())


# ------------------------------------------- the step before the change

@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def models(mesh):
    cache = {}

    def get(op, npart, kernel, grad=None):
        key = (op, npart, kernel, grad)
        if key not in cache:
            cls = GreenGaussTorch if op == "gg" else PSDFluxModel
            opts = {"grad_dtype": grad} if grad else {}
            cache[key] = cls(partition_mesh(mesh, npart), NVAR, bp=BP,
                             kernel=kernel, device="cpu", **opts)
        return cache[key]

    return get


class _Filled:
    """The model's step as it was before the fill went: the boundary class
    swept with init on a zero-filled output, every other sweep as it is."""

    def __init__(self, model):
        self.model, self.sweep = model, model._sweep

    def __enter__(self):
        m = self.model

        def sweep(cls, var_T, tables, init=None):
            if cls == "boundary" and init is None:
                init = torch.zeros((m.nlocal, m.rows, m.ndev),
                                   dtype=m.grad_t, device=m.device)
            return self.sweep(cls, var_T, tables, init=init)

        m._sweep = sweep
        return m

    def __exit__(self, *exc):
        del self.model._sweep        # back to the class's method


def _old_chain(model, var_T, tables, schedule, n, c):
    """The chained loop before the change: the filled boundary and the
    two-op update."""
    v = var_T
    with _Filled(model) as m:
        for _ in range(n):
            v = torch.add(v, c * m(v, tables, schedule)[:, :NV])
    return v


def _old_solver(model, var_T, schedule, n, sweeps, c):
    from cfd_proxy_tpu_torch.models.gradients import SCHEDULE_CLASSES

    v = var_T
    with _Filled(model) as m:
        for _ in range(n):
            tb = m._build_tables(v, SCHEDULE_CLASSES[schedule])
            for _ in range(sweeps):
                v = torch.add(v, c * m(v, tb, schedule)[:, :NV])
            v = m._var_exchange(v)
    return v


CHAIN = [pytest.param("gg", p, k, s, None, id=f"gg-P{p}-{k}-{s}")
         for p in (1, 3) for k in ("packed", "gather") for s in SCHEDULES]
CHAIN += [pytest.param("flux", p, k, s, None, id=f"flux-P{p}-{k}-{s}")
          for p, k, s in ((1, "packed", "overlap"), (3, "packed", "early"),
                          (3, "gather", "overlap"))]
CHAIN += [pytest.param("gg", p, "packed", s, BF, id=f"gg-P{p}-o16-{s}")
          for p, s in ((1, "overlap"), (3, "early"), (3, "overlap"))]


@pytest.mark.parametrize("op,npart,kernel,schedule,grad", CHAIN)
def test_chain_equals_the_step_before_the_change(models, gvar, op, npart,
                                                 kernel, schedule, grad):
    tm = models(op, npart, kernel, grad)
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    got = tm.iterate_fn(schedule, STEPS, coupling=C)(*tm.iter_args(st))
    assert torch.equal(st["var_T"], var0)
    assert (got - var0).abs().max() > 1e-3       # the gradients moved it
    want = _old_chain(tm, var0, st["tables"], schedule, STEPS, C)
    assert np.array_equal(bits(got), bits(want))


@pytest.mark.parametrize("npart,kernel,schedule,sweeps", [
    pytest.param(1, "packed", "overlap", 2, id="P1-packed-overlap-N2"),
    pytest.param(3, "gather", "early", 2, id="P3-gather-early-N2"),
    pytest.param(3, "packed", "bulk", 1, id="P3-packed-bulk-N1")])
def test_solver_equals_the_step_before_the_change(models, gvar, npart, kernel,
                                                  schedule, sweeps):
    tm = models("gg", npart, kernel)
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    got = tm.iterate_fn(schedule, STEPS, solver_mode=True,
                        sweeps_per_step=sweeps, coupling=C)(
        *tm.iter_args(st))
    want = _old_solver(tm, var0, schedule, STEPS, sweeps, C)
    assert np.array_equal(bits(got), bits(want))


# ----------------------------------- zero-filled = init form on zeros

@pytest.mark.parametrize("npart,kernel,grad", [
    pytest.param(p, k, g, id=f"P{p}-{k}-{g or 'f32'}")
    for p in (1, 3, 8) for k in ("packed", "gather") for g in (None, BF)])
def test_zero_filled_sweep_equals_init_on_zeros(models, gvar, npart, kernel,
                                                grad):
    tm = models("gg", npart, kernel, grad)
    st = tm.distribute_state(gvar)
    for cls in CLASSES:
        got = tm._sweep(cls, st["var_T"], st["tables"])
        zeros = torch.zeros((tm.nlocal, tm.rows, tm.ndev), dtype=tm.grad_t)
        want = tm._sweep(cls, st["var_T"], st["tables"], init=zeros)
        assert got.dtype == tm.grad_t
        assert np.array_equal(bits(got), bits(want)), cls
    # the boundary class leaves blocks out: the zeros are the sweep's own
    ids = tm.plans["boundary"]["block_ids"]
    assert len(set(ids[0].tolist())) < tm.ndev // tm.bp


def test_boundary_step_has_no_fill(models, gvar, monkeypatch):
    """The packed model's early step sweeps the boundary class without
    init: K1 zeroes the blocks the class leaves out, and no fill runs
    before it (the gather model keeps its fill: models/gradients.py)."""
    tm = models("gg", 3, "packed")
    st = tm.distribute_state(gvar)
    seen = []
    sweep = tm._sweep

    def spy(cls, var_T, tables, init=None):
        seen.append((cls, init is None))
        return sweep(cls, var_T, tables, init=init)

    monkeypatch.setattr(tm, "_sweep", spy)
    tm.step(st, "early")
    assert seen == [("boundary", True), ("interior", False)]
