"""The port's own host layer equals its originals in `cfd_proxy_tpu`.

The port imports nothing of the JAX package, so it carries copies of the
JAX package's NumPy host modules: `mesh/` (model, netCDF3, reader,
generator, partitioner), `utils/` (errors, timing, `round_up`),
`ops/flux.py` (the flux golden), `ops/prep.py` (the ELL sweep plans;
its outputs are held in tests/test_torch_ell.py) and `native.py` (the
ctypes loader of the native host library, which builds that library
itself instead of running `native/Makefile`).  These tests hold each copy to its original:

- the same code: the AST of every module with docstrings dropped and the
  port's package name in imports read as the original's (`native.py`:
  every function but the build and load path, which differ by design);
- the same outputs: generated meshes, partitions (RCB and given owner
  maps, one and two ghost layers), netCDF round trips across the two
  packages, the flux golden, the native golden sweep, RCB and ghost
  closure;
- the native build of a fresh checkout writes nothing under
  `cfd_proxy_tpu/`.
"""

import ast
import os

import numpy as np
import pytest

from cfd_proxy_tpu import native as r_native
from cfd_proxy_tpu.mesh import generator as r_gen
from cfd_proxy_tpu.mesh import partition as r_part
from cfd_proxy_tpu.mesh import reader as r_reader
from cfd_proxy_tpu.ops import flux as r_flux
from cfd_proxy_tpu.ops import golden as r_golden
from cfd_proxy_tpu_torch import native as t_native
from cfd_proxy_tpu_torch.mesh import generator as t_gen
from cfd_proxy_tpu_torch.mesh import partition as t_part
from cfd_proxy_tpu_torch.mesh import reader as t_reader
from cfd_proxy_tpu_torch.ops import flux as t_flux
from cfd_proxy_tpu_torch.utils import round_up
from cfd_proxy_tpu_torch.utils.errors import CheckError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["mesh/__init__.py", "mesh/model.py", "mesh/netcdf3.py",
          "mesh/reader.py", "mesh/generator.py", "mesh/partition.py",
          "utils/__init__.py", "utils/errors.py", "utils/timing.py",
          "ops/flux.py", "ops/prep.py"]


def _tree(path):
    """A module's AST with docstrings dropped and cfd_proxy_tpu_torch read
    as cfd_proxy_tpu in imports."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("cfd_proxy_tpu_torch",
                                              "cfd_proxy_tpu")
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_original_code(rel):
    got = ast.dump(_tree(f"cfd_proxy_tpu_torch/{rel}"))
    assert got == ast.dump(_tree(f"cfd_proxy_tpu/{rel}")), rel


def test_native_loader_keeps_original_bindings():
    """Every function of the original loader but its build and load path
    (`lib`, `_make`, `_quiet_unlink`) is the original's code; the ABI
    version is the same."""
    def funcs(path):
        return {n.name: ast.dump(n) for n in _tree(path).body
                if isinstance(n, ast.FunctionDef)}

    ref = funcs("cfd_proxy_tpu/native/__init__.py")
    got = funcs("cfd_proxy_tpu_torch/native.py")
    shared = set(ref) - {"lib", "_make", "_quiet_unlink"}
    assert shared == {"_bind", "_declare", "rcb_assign_c", "ghost_closure_c",
                      "golden_gg_c", "ptr"}
    for name in sorted(shared):
        assert got[name] == ref[name], name
    assert t_native._ABI_VERSION == r_native._ABI_VERSION


def _equal(a, b, what):
    """Deep equality of dataclasses / lists / arrays / scalars, by field."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, what
        for f in a.__dataclass_fields__:
            _equal(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("kw", [
    dict(nx=6, ny=5, nz=4, seed=0),
    dict(nx=7, ny=6, nz=5, jitter=0.05, diag_frac=0.3, shuffle=True,
         seed=3),
    dict(nx=8, ny=7, nz=6, jitter=0.05, diag_frac=0.2, hub_frac=0.05,
         hub_extra=8, seed=4),
])
def test_generate_mesh_and_state_equal(kw):
    _equal(t_gen.generate_mesh(**kw), r_gen.generate_mesh(**kw), "mesh")
    np.testing.assert_array_equal(t_gen.make_state(50, 3, seed=kw["seed"]),
                                  r_gen.make_state(50, 3, seed=kw["seed"]))


@pytest.mark.parametrize("npart,ghost_layers,owner", [
    (1, 1, None), (4, 1, None), (4, 2, None), (3, 2, "striped")])
def test_partition_mesh_equal(npart, ghost_layers, owner):
    m = r_gen.generate_mesh(7, 6, 5, jitter=0.05, diag_frac=0.25,
                            shuffle=True, seed=9)
    own = None
    if owner == "striped":
        own = (np.arange(m.npoint) * npart // m.npoint).astype(np.int32)
    got = t_part.partition_mesh(m, npart, ghost_layers=ghost_layers,
                                owner=own)
    ref = r_part.partition_mesh(m, npart, ghost_layers=ghost_layers,
                                owner=own)
    _equal(got, ref, "parts")
    for p, q in zip(got, ref):
        order = t_part.rcb_owned_order(p, block=128, degree_sort=True)
        np.testing.assert_array_equal(
            order, r_part.rcb_owned_order(q, block=128, degree_sort=True))
        _equal(t_part.relabel_owned(p, order), r_part.relabel_owned(q, order),
               "relabel")
        np.testing.assert_array_equal(t_part.send_point_set(p),
                                      r_part.send_point_set(q))


def test_netcdf_round_trip_across_packages(tmp_path):
    """A partition written by either package reads back equal through the
    other."""
    m = r_gen.generate_mesh(6, 6, 5, jitter=0.05, diag_frac=0.2, seed=2)
    parts = r_part.partition_mesh(m, 2, ghost_layers=2)
    for i, p in enumerate(parts):
        a, b = tmp_path / f"t{i}.nc", tmp_path / f"r{i}.nc"
        t_reader.write_partition(str(a), p)
        r_reader.write_partition(str(b), p)
        assert a.read_bytes() == b.read_bytes()
        _equal(r_reader.read_partition(str(a)), p, "port write, ref read")
        _equal(t_reader.read_partition(str(b)), p, "ref write, port read")
    assert t_reader.partition_path("x", 1, 4) == \
        r_reader.partition_path("x", 1, 4)
    with pytest.raises(CheckError):
        bad = tmp_path / "bad.nc"
        bad.write_bytes(b"not a netcdf file")
        t_reader.read_partition(str(bad))


def test_flux_golden_equal():
    m = r_gen.generate_mesh(6, 5, 5, jitter=0.05, diag_frac=0.2, seed=1)
    var = r_gen.make_state(m.npoint, 5, seed=2)
    got = t_flux.compute_psd_flux(var, m.faces, m.normals)
    np.testing.assert_array_equal(
        got, r_flux.compute_psd_flux(var, m.faces, m.normals))
    np.testing.assert_array_equal(
        t_flux.flux_residual_scale(got, m.volume, m.npoint - 3),
        r_flux.flux_residual_scale(got, m.volume, m.npoint - 3))


def test_native_library_outputs_equal(monkeypatch):
    """The port's library (built by its own loader) gives the NumPy golden
    bitwise, and the same RCB and ghost closure as the partitioner's NumPy
    paths."""
    if t_native.lib() is None:
        pytest.skip("no C++ compiler: the port keeps its NumPy paths")
    m = r_gen.generate_mesh(7, 6, 5, jitter=0.05, diag_frac=0.25,
                            shuffle=True, seed=5)
    var = r_gen.make_state(m.npoint, 4, seed=6)
    np.testing.assert_array_equal(
        t_native.golden_gg_c(var, m.faces, m.normals),
        r_golden.compute_gradients_gg(var, m.faces, m.normals))
    owner = t_native.rcb_assign_c(m.coords, 4)
    closure = t_native.ghost_closure_c(m.faces, owner, 4, 2)
    monkeypatch.setattr(t_native, "rcb_assign_c", lambda *a: None)
    np.testing.assert_array_equal(owner, t_part.rcb_assign(m.coords, 4))
    gid, depth, goff, faces, foff = closure
    ref = t_part._ghost_closure_numpy(m.faces, owner, 4, 2)
    for got, want in zip((goff, faces, foff), ref[2:]):
        np.testing.assert_array_equal(got, want)
    for p in range(4):          # ghosts in BFS order, the NumPy path's by id
        sl = slice(goff[p], goff[p + 1])
        order = np.argsort(gid[sl])
        np.testing.assert_array_equal(gid[sl][order], ref[0][sl])
        np.testing.assert_array_equal(depth[sl][order], ref[1][sl])


def test_native_build_in_fresh_checkout_writes_only_under_the_port(
        tmp_path):
    """In a fresh checkout (the loader and the native sources, nothing
    built) the loader compiles the library into the port's build directory;
    nothing appears under the JAX package, and the library passes the ABI
    handshake."""
    import importlib.util
    import shutil

    if t_native._cxx() is None:
        pytest.skip("no C++ compiler")
    root = tmp_path / "checkout"
    (root / "cfd_proxy_tpu_torch").mkdir(parents=True)
    (root / "cfd_proxy_tpu").mkdir()
    shutil.copy(os.path.join(REPO, "cfd_proxy_tpu_torch", "native.py"),
                root / "cfd_proxy_tpu_torch" / "native.py")
    shutil.copytree(os.path.join(REPO, "native"), root / "native",
                    ignore=shutil.ignore_patterns("*.o", "*.so"))
    spec = importlib.util.spec_from_file_location(
        "fresh_native", root / "cfd_proxy_tpu_torch" / "native.py")
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    path = fresh.build()
    assert path is not None
    assert os.path.dirname(path) == str(root / "cfd_proxy_tpu_torch" /
                                        "build")
    assert not any((root / "cfd_proxy_tpu").rglob("*"))
    assert fresh._bind(path) is not None
    assert fresh.build() == path            # built once, then reused


def test_native_library_name_follows_the_host_target(monkeypatch):
    """The library's name hashes what `-march=native` resolves to, so a
    build directory copied to a host with another instruction set builds
    anew instead of loading the other host's library."""
    cxx = t_native._cxx()
    if cxx is None:
        pytest.skip("no C++ compiler")
    here = t_native._so_path(cxx)
    assert here == t_native._so_path(cxx)
    assert b"-march=" in t_native._target(cxx)
    monkeypatch.setattr(t_native, "_target", lambda c: b"-march=elsewhere")
    other = t_native._so_path(cxx)
    assert other != here
    assert os.path.dirname(other) == os.path.dirname(here)


def test_round_up():
    assert [round_up(x, 128) for x in (0, 1, 128, 129)] == [0, 128, 128, 256]
