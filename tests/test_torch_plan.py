"""The port's NumPy host copies equal their originals in `cfd_proxy_tpu`.

`cfd_proxy_tpu_torch.parallel.{topology,tlayout}`, `ops.plan` and
`ops.golden` are copies (the reference packages' `__init__` import JAX);
`ops.plan` also carries the plan-padding helpers of the reference model.
These tests hold each copy to its original: the same code (AST with
docstrings dropped) and the same outputs on a small shuffled mesh, at one
and four shards, one and two ghost layers.
"""

import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import (partition_mesh, rcb_owned_order,
                                          relabel_owned, send_point_set)
from cfd_proxy_tpu.ops import blocksweep as r_bs
from cfd_proxy_tpu.ops import golden as r_golden
from cfd_proxy_tpu.parallel import tlayout as r_tlayout
from cfd_proxy_tpu.parallel import topology as r_topology
from cfd_proxy_tpu_torch.ops import golden as t_golden
from cfd_proxy_tpu_torch.ops import plan as t_plan
from cfd_proxy_tpu_torch.ops.blocksweep import pack_srcs_ref
from cfd_proxy_tpu_torch.parallel import tlayout as t_tlayout
from cfd_proxy_tpu_torch.parallel import topology as t_topology

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = [(1, 1), (1, 2), (4, 1), (4, 2)]     # (P, ghost_layers)
BP = 128


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


def _equal(a, b, what):
    """Deep equality of dataclasses / lists / tuples / arrays / scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


def _setup(mesh, npart, ghost_layers):
    """Raw parts, both packages' pre-topologies and the relabeled parts."""
    parts = partition_mesh(mesh, npart, ghost_layers=ghost_layers)
    pad = max(p.npoint for p in parts) + 1
    ref = r_topology.build_halo_topology(parts, pad)
    got = t_topology.build_halo_topology(parts, pad)
    eph_ref = r_topology.entry_phases(parts, ref)
    eph = t_topology.entry_phases(parts, got)
    relab = [relabel_owned(p, rcb_owned_order(p, block=BP, degree_sort=True,
                                              entry_phase=eph_ref[d]))
             for d, p in enumerate(parts)]
    return parts, (ref, got), (eph_ref, eph), relab


def _module_functions(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    out = {}
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if (isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                sub.body = body[1:] or [ast.Pass()]
        out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("orig,copy", [
    ("cfd_proxy_tpu/parallel/topology.py",
     "cfd_proxy_tpu_torch/parallel/topology.py"),
    ("cfd_proxy_tpu/parallel/tlayout.py",
     "cfd_proxy_tpu_torch/parallel/tlayout.py"),
    ("cfd_proxy_tpu/ops/blocksweep.py", "cfd_proxy_tpu_torch/ops/plan.py"),
    ("cfd_proxy_tpu/ops/golden.py", "cfd_proxy_tpu_torch/ops/golden.py"),
])
def test_copy_has_original_code(orig, copy):
    """Every function and class of a copy that its original also defines is
    the original's code, statement for statement (docstrings aside)."""
    ref, got = _module_functions(orig), _module_functions(copy)
    shared = sorted(set(ref) & set(got))
    assert shared
    assert set(got) - set(ref) <= {"compact_src_cols", *PAD_HELPERS}
    for name in shared:
        assert got[name] == ref[name], f"{copy}::{name} differs from {orig}"


PAD_HELPERS = ("_pad_plan_dims", "_pad_blocks")


def test_pad_helpers_have_original_code():
    """The plan-padding helpers the port carries in ops/plan.py are the
    reference model's, statement for statement (docstrings aside)."""
    ref = _module_functions("cfd_proxy_tpu/models/gradients_pallas.py")
    got = _module_functions("cfd_proxy_tpu_torch/ops/plan.py")
    for name in PAD_HELPERS:
        assert got[name] == ref[name], name


@pytest.mark.parametrize("npart,ghost_layers", SHARDS)
def test_topology_and_entry_phases_equal(mesh, npart, ghost_layers):
    _, (ref, got), (eph_ref, eph), _ = _setup(mesh, npart, ghost_layers)
    _equal(got, ref, "HaloTopology")
    _equal(eph, eph_ref, "entry_phases")
    assert ref.nphases > 0 or npart == 1


@pytest.mark.parametrize("npart,ghost_layers", SHARDS)
def test_tlayout_equal(mesh, npart, ghost_layers):
    _, _, _, relab = _setup(mesh, npart, ghost_layers)
    pad = max(p.npoint for p in relab) + 1
    ref = r_tlayout.build_tlayout(
        relab, r_topology.build_halo_topology(relab, pad), bp=BP)
    got = t_tlayout.build_tlayout(relab, t_topology.build_halo_topology(
        relab, pad), bp=BP)
    _equal(got, ref, "TLayout")
    for p in relab:
        _equal(t_tlayout.device_faces(p, got), r_tlayout.device_faces(p, ref),
               "device_faces")
        _equal(t_tlayout.device_inv_scale(p, got),
               r_tlayout.device_inv_scale(p, ref), "device_inv_scale")
        vals = make_state(p.npoint, 5, seed=3).astype(np.float32)
        _equal(t_tlayout.device_state(vals, p, got, 8),
               r_tlayout.device_state(vals, p, ref, 8), "device_state")


def _class_plans(mod, part, lay, dst_lt):
    """bulk / boundary / interior plans of one shard, built as
    GreenGaussPallas builds them, with the given module's build_block_plan."""
    fd, nd = t_tlayout.device_faces(part, lay)
    inv = t_tlayout.device_inv_scale(part, lay)
    ones = np.ones(lay.ndev)
    is_send = np.zeros(lay.ndev, bool)
    is_send[send_point_set(part)] = True
    bsel = is_send[fd[:, 0]] | is_send[fd[:, 1]]
    order = np.concatenate([np.flatnonzero(bsel), np.flatnonzero(~bsel)])
    return {
        "bulk": mod.build_block_plan(fd[order], nd[order], lay.ndev, inv,
                                     bp=BP, all_blocks=True, dst_lt=dst_lt),
        "boundary": mod.build_block_plan(fd, nd, lay.ndev, ones, bp=BP,
                                         face_sel=bsel, dst_lt=dst_lt),
        "interior": mod.build_block_plan(fd, nd, lay.ndev, inv, bp=BP,
                                         face_sel=~bsel, all_blocks=True,
                                         dst_lt=dst_lt),
    }


@pytest.mark.parametrize("npart,ghost_layers", SHARDS)
def test_block_plans_and_compact_layout_equal(mesh, npart, ghost_layers):
    _, _, _, relab = _setup(mesh, npart, ghost_layers)
    pad = max(p.npoint for p in relab) + 1
    lay = t_tlayout.build_tlayout(
        relab, t_topology.build_halo_topology(relab, pad), bp=BP)
    for part in relab:
        for dst_lt in (None, part.nowned):
            ref = _class_plans(r_bs, part, lay, dst_lt)
            got = _class_plans(t_plan, part, lay, dst_lt)
            for c in ref:
                _equal(got[c], ref[c], f"{c} plan dst_lt={dst_lt}")
                sw = ref[c].slot_w[None]
                wks = r_bs.prefix_widths(sw, BP)
                assert t_plan.prefix_widths(sw, BP) == wks
                _equal(t_plan.compact_slot_w(got[c].slot_w, wks),
                       r_bs.compact_slot_w(ref[c].slot_w, wks),
                       "compact_slot_w")
                _equal(t_plan.slot_src_cols(got[c]),
                       r_bs.slot_src_cols(ref[c]), "slot_src_cols")


@pytest.mark.parametrize("npart,ghost_layers", SHARDS)
def test_compact_src_cols_gather_equals_reference(mesh, npart, ghost_layers):
    """var_T gathered through compact_src_cols equals the reference's
    compact source table, compact_srcs(gather_srcs(var_T, slot_src_cols))."""
    _, _, _, relab = _setup(mesh, npart, ghost_layers)
    pad = max(p.npoint for p in relab) + 1
    lay = t_tlayout.build_tlayout(
        relab, t_topology.build_halo_topology(relab, pad), bp=BP)
    for part in relab:
        vals = make_state(part.npoint, 5, seed=part.part_id + 7)
        var_T = t_tlayout.device_state(vals.astype(np.float32), part, lay, 8)
        for plan in _class_plans(t_plan, part, lay, part.nowned).values():
            wks = t_plan.prefix_widths(plan.slot_w[None], BP)
            cols = t_plan.compact_src_cols(plan, wks)
            assert cols.dtype == np.int32
            assert cols.shape == (plan.nblocks, t_plan.compact_len(wks))
            ref = np.asarray(r_bs.compact_srcs(r_bs.gather_srcs(
                jnp.asarray(var_T), jnp.asarray(r_bs.slot_src_cols(plan))),
                wks))
            got = pack_srcs_ref(torch.from_numpy(var_T[None]),
                                torch.from_numpy(cols[None])).numpy()[0]
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("nvar", [1, 5])
def test_golden_bitwise_f64(mesh, nvar):
    var = make_state(mesh.npoint, nvar, seed=nvar)
    ref = r_golden.compute_gradients_gg(var, mesh.faces, mesh.normals)
    got = t_golden.compute_gradients_gg(var, mesh.faces, mesh.normals)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        t_golden.scale_gradients(got, mesh.volume, mesh.npoint - 5),
        r_golden.scale_gradients(ref, mesh.volume, mesh.npoint - 5))
