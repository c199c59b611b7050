"""The port's model at one shard against the JAX reference model.

`GreenGaussTorch` on CPU tensors (the kernels' plain versions) against
`GreenGaussPallas` in interpret mode, column for column, and both against
the f64 golden; the same model built from the reference's plan arrays; the
chained loop; the options outside the slice; and the import guard: the port
runs with JAX made unimportable.  The schedules at P shards are in
tests/test_torch_schedules.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.mesh.reader import read_partition
from cfd_proxy_tpu.models import GreenGaussPallas
from cfd_proxy_tpu.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy_tpu_torch.utils.errors import CheckError
from cfd_proxy_tpu_torch.convert import plans_from_jax
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.solver import SolverConfig, check_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVAR = 5
PORT_TOL = 1e-6      # port vs reference, relative (FMA-contraction bound)
GOLDEN_TOL = 1e-5    # either vs the f64 golden (the reference's gate)


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


def _both(parts, gvar, bp, kcompact):
    jm = GreenGaussPallas(parts, NVAR, bp=bp, interpret=True,
                          kcompact=kcompact)
    js = jm.distribute_state(gvar, schedules=["bulk"])
    jax_out = np.asarray(jm.step(js, "bulk"))
    tm = GreenGaussTorch(parts, NVAR, bp=bp, kcompact=kcompact, device="cpu")
    ts = tm.distribute_state(gvar)
    port_out = tm.step(ts, "bulk")
    return jm, jax_out, tm, ts, port_out


@pytest.mark.parametrize("kcompact", [True, False])
def test_bulk_matches_reference_and_golden(mesh, gvar, gref, kcompact):
    parts = partition_mesh(mesh, 1, ghost_layers=1)
    jm, jax_out, tm, ts, port_out = _both(parts, gvar, 128, kcompact)
    assert tm.bp == jm.bp and tm.ndev == jm.layout.ndev
    np.testing.assert_array_equal(tm.locmap[0], jm.layout.locmap[0])
    np.testing.assert_array_equal(ts["var_T"].numpy(),
                                  np.asarray(jm.distribute_state(
                                      gvar, schedules=["bulk"])["var_T"]))
    got = port_out.numpy()
    assert got.shape == jax_out.shape == (1, 24, tm.ndev)
    scale = max(1.0, np.abs(jax_out).max())
    assert np.abs(got - jax_out).max() / scale < PORT_TOL
    denom = max(1.0, np.abs(gref).max())
    for name, g in (("port", tm.gather_global(port_out)),
                    ("jax", jm.gather_global(jax_out))):
        assert g.shape == gref.shape
        assert np.abs(g - gref).max() / denom < GOLDEN_TOL, name


def test_shipped_mesh_matches_reference(gvar):
    """The shipped one-part netCDF partition, port against reference."""
    p = read_partition(os.path.join(REPO, "data", "small.1p.0.nc"))
    state = make_state(p.npoint, NVAR, seed=5)
    jm, jax_out, tm, _, port_out = _both([p], state, 128, True)
    scale = max(1.0, np.abs(jax_out).max())
    assert np.abs(port_out.numpy() - jax_out).max() / scale < PORT_TOL
    np.testing.assert_allclose(tm.gather_global(port_out),
                               jm.gather_global(jax_out),
                               rtol=0, atol=PORT_TOL * scale)


@pytest.mark.parametrize("kcompact", [True, False])
def test_from_arrays_equals_own_host_layer(mesh, gvar, kcompact):
    """Built from the reference's plan arrays, the model computes exactly
    what it computes from its own host layer."""
    parts = partition_mesh(mesh, 1, ghost_layers=1)
    jm = GreenGaussPallas(parts, NVAR, bp=256, interpret=True,
                          kcompact=kcompact)
    conv = GreenGaussTorch.from_arrays(jm.parts, NVAR, plans_from_jax(jm),
                                       device="cpu")
    own = GreenGaussTorch(parts, NVAR, bp=256, kcompact=kcompact,
                          device="cpu")
    assert conv.wks == own.wks and conv.ndev == own.ndev
    # at bp=256 the degree-sorted layout drops whole 128-lane chunks
    wks = own.wks["bulk"]
    assert (sum(wks) < len(wks) * own.bp) == kcompact
    for c, pl in own.plans.items():
        for name, t in pl.items():
            assert torch.equal(conv.plans[c][name], t), (c, name)
    a = conv.step(conv.distribute_state(gvar), "bulk")
    b = own.step(own.distribute_state(gvar), "bulk")
    assert torch.equal(a, b)
    np.testing.assert_array_equal(conv.gather_global(a), own.gather_global(b))


def test_iterate_fn_chains_steps(mesh, gvar):
    """The chained loop feeds each step's gradients into the next state."""
    parts = partition_mesh(mesh, 1, ghost_layers=1)
    tm = GreenGaussTorch(parts, NVAR, bp=128, device="cpu")
    st = tm.distribute_state(gvar)
    v2 = tm.iterate_fn("bulk", 2)(*tm.iter_args(st))
    v = st["var_T"]
    for _ in range(2):
        v = v + 1e-30 * tm(v, st["tables"], "bulk")[:, :8]
    assert torch.equal(v2, v)


@pytest.mark.parametrize("field,value", [
    ("slice_size", 2),
])
def test_options_outside_slice_raise(field, value):
    cfg = SolverConfig(device="cpu", **{field: value})
    with pytest.raises(CheckError, match="ROADMAP"):
        check_config(cfg)


@pytest.mark.parametrize("fields", [
    {"kernel": "gather"},
    {"solver_mode": True},
    {"solver_mode": True, "sweeps_per_step": 4, "kernel": "gather"},
    {"model": "flux"},
    {"model": "flux", "solver_mode": True, "kernel": "gather"},
    {"meta_dtype": "bfloat16"},
    {"src_dtype": "bfloat16"},
    {"halo_dtype": "bfloat16"},
    {"grad_dtype": "bfloat16"},
])
def test_ported_options_accepted(fields):
    """The gather kernel, solver mode, the flux model and the
    reduced-precision options are in the slice: the config check passes
    them."""
    check_config(SolverConfig(device="cpu", **fields))


@pytest.mark.parametrize("fields,match", [
    ({"kernel": "ell"}, "kernel"),
    ({"sweeps_per_step": 2}, "requires --solver-mode"),
    ({"solver_mode": True, "sweeps_per_step": 0}, "at least one"),
    ({"model": "ell"}, "--model"),
    ({"grad_dtype": "float16"}, "--grad-dtype"),
])
def test_bad_solver_options_raise(fields, match):
    with pytest.raises(CheckError, match=match):
        check_config(SolverConfig(device="cpu", **fields))


@pytest.mark.parametrize("kernel,key,hi", [
    ("packed", "src_cols", "ndev"),
    ("gather", "slot_idx", "bp+ep"),
    ("gather", "ext_idx", "ndev"),
])
def test_from_arrays_rejects_out_of_range_indices(mesh, kernel, key, hi):
    """Plan arrays from outside the model: an index the kernels would load
    through out of bounds raises when the arrays are loaded."""
    from cfd_proxy_tpu_torch.models.gradients import host_plan_arrays

    own = GreenGaussTorch(partition_mesh(mesh, 2), NVAR, bp=128,
                          kernel=kernel, device="cpu")
    arrays = host_plan_arrays(own.parts, bp=128, kcompact=True,
                              kernel=kernel)
    GreenGaussTorch.from_arrays(own.parts, NVAR, arrays, device="cpu")
    ca = arrays["classes"]["interior"]
    bound = own.ndev if hi == "ndev" else 128 + ca["ep"]
    ca[key] = ca[key].copy()
    ca[key].flat[-1] = bound
    with pytest.raises(CheckError, match=f"{key} outside"):
        GreenGaussTorch.from_arrays(own.parts, NVAR, arrays, device="cpu")


def test_model_refuses_unknown_kernel(mesh):
    with pytest.raises(CheckError, match="unknown kernel"):
        GreenGaussTorch(partition_mesh(mesh, 1), NVAR, bp=128,
                        kernel="ell", device="cpu")


def test_model_refuses_other_schedules_and_shards(mesh, gvar):
    """An unknown schedule raises; so does a schedule whose table classes
    the state was not built with (distribute_state(schedules=...))."""
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    tm = GreenGaussTorch(parts, NVAR, bp=128, device="cpu")
    st = tm.distribute_state(gvar, schedules=["bulk"])
    assert sorted(st["tables"]) == ["bulk"]
    tm.step(st, "nocomm")
    for s in ("early", "overlap"):
        with pytest.raises(CheckError, match="needs"):
            tm.step(st, s)
        with pytest.raises(CheckError, match="needs"):
            tm.iterate_fn(s, 1)(*tm.iter_args(st))
    with pytest.raises(CheckError, match="unknown schedule"):
        tm.step(st, "all")
    with pytest.raises(CheckError, match="unknown schedule"):
        tm.distribute_state(gvar, schedules=["eager"])
    st = tm.distribute_state(gvar, schedules=["overlap"])
    assert sorted(st["tables"]) == ["boundary", "interior"]
    with pytest.raises(CheckError, match="needs"):
        tm.step(st, "bulk")


JAX_BLOCKED = """
import sys
sys.modules["jax"] = None            # any import of jax now raises
sys.modules["cfd_proxy_tpu"] = None  # and so does any of the JAX package
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import chip_smoke
import cfd_proxy_tpu_torch
import cfd_proxy_tpu_torch.solver
import cfd_proxy_tpu_torch.convert
from cfd_proxy_tpu_torch import native
from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops import _cuda, blocksweep
from cfd_proxy_tpu_torch.solver import golden
from cfd_proxy_tpu_torch.tools import kbench, mbench
torch.set_num_threads(1)
m = generate_mesh(6, 5, 4, jitter=0.05, diag_frac=0.2, seed=0)
g = make_state(m.npoint, 3, seed=1)
for op in ("gg", "flux"):
    ref = golden(op, m, g)
    for kernel in ("packed", "gather"):
        for nparts, s in ((1, "bulk"), (2, "early"), (2, "overlap")):
            model = GreenGaussTorch(partition_mesh(m, nparts), 3,
                                    kernel=kernel, op=op, device="cpu")
            st = model.distribute_state(g)
            got = model.gather_global(model.step(st, s))
            err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
            assert err < 1e-5, (op, kernel, nparts, s, err)
            # solver mode: table rebuild, sweeps + update, var exchange
            v = model.iterate_fn(s, 2, solver_mode=True, sweeps_per_step=2)(
                *model.iter_args(st))
            assert v.shape == st["var_T"].shape
            assert bool(torch.isfinite(v).all())
            st = model.refresh_state(v)
# the reduced-precision options, all four at once
full = dict(src_dtype="bfloat16", meta_dtype="bfloat16",
            grad_dtype="bfloat16", halo_dtype="bfloat16")
model = GreenGaussTorch(partition_mesh(m, 2), 3, device="cpu", **full)
st = model.distribute_state(g)
got = model.gather_global(model.step(st, "overlap"))
ref = golden("gg", m, g)
err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
assert 1e-5 < err < 2e-2, err
assert native.lib() is not None or native.build() is None
# the kernel bench and the paired harness, on the plain versions
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    assert kbench.main(["--nx", "5", "--bp", "128", "--iters", "1",
                        "--variants", "compact_bso,nv7,cstream_bso",
                        "--check", "--device", "cpu"]) == 0
    assert mbench.main(["--nx", "6", "--iters", "4", "--repeats", "1",
                        "--warmup", "0", "--null", "0", "--device", "cpu",
                        "--b", "schedule=early", "--json"]) in (0, 1)
assert not any(k == "jax" or k.startswith("jax.") or k == "cfd_proxy_tpu"
               or k.startswith("cfd_proxy_tpu.")
               for k, v in sys.modules.items() if v is not None)
print("ok", err)
"""


def test_port_runs_with_jax_unimportable():
    res = subprocess.run([sys.executable, "-c", JAX_BLOCKED.format(repo=REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
