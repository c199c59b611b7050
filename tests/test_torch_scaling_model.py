"""The port's scaling model (`cfd_proxy_tpu_torch.tools.scaling_model`)
against the reference's (`cfd_proxy_tpu.tools.scaling_model`), on the CPU.

- `rate_ns_per_face`, `scale_rate_table`, `eval_geometry` and
  `model_partitioning` are the reference's code (AST, docstrings dropped);
- `shard_geometry` on the port's host copies gives the reference's face
  totals, phase width and first four shard entries (faces, boundary faces,
  ICI and DCN sends); its pack pair is the port's: the columns
  `GreenGaussTorch._pack` gathers (nphases x s_max, self-phases included)
  and no tail phase;
- the port's `eval_geometry` on that geometry gives the reference's floats;
- the reference's scaling tests (tests/test_tools.py), on the port's
  tables and geometry; the CLI takes the reference's options;
- `tools/scaling_inputs.py` runs its two measurements (plain versions).

Every mesh is generated from a seed.
"""

import argparse
import ast
import inspect
import re
import textwrap

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh as r_generate_mesh
from cfd_proxy_tpu.tools import scaling_model as r_sm
from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.tools import scaling_inputs
from cfd_proxy_tpu_torch.tools import scaling_model as sm

torch.set_num_threads(1)

VERBATIM = ("rate_ns_per_face", "scale_rate_table", "eval_geometry",
            "model_partitioning")
MESH = dict(jitter=0.05, diag_frac=0.2, seed=0)


def _code(fn) -> str:
    """A function's AST with its docstring dropped."""
    node = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    body = node.body
    if (isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                     ast.Constant)
            and isinstance(body[0].value.value, str)):
        node.body = body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("name", VERBATIM)
def test_copy_is_reference_code(name):
    assert _code(getattr(sm, name)) == _code(getattr(r_sm, name))


def _meshes(nx):
    return (generate_mesh(nx, nx, nx, **MESH),
            r_generate_mesh(nx, nx, nx, **MESH))


@pytest.mark.parametrize("nx,P,slice_size",
                         [(nx, P, None) for nx in (10, 11, 12)
                          for P in (1, 2, 4, 8)]
                         + [(10, 4, 2), (12, 8, 2), (11, 8, 4)])
def test_geometry_matches_reference(nx, P, slice_size):
    m, rm = _meshes(nx)
    got = sm.shard_geometry(m, P, slice_size=slice_size)
    ref = r_sm.shard_geometry(rm, P, slice_size=slice_size)
    assert got["nface_total"] == ref["nface_total"]
    assert got["s_max"] == ref["s_max"]
    assert [s[:4] for s in got["shards"]] == [s[:4] for s in ref["shards"]]
    if slice_size:
        assert any(s[3] for s in got["shards"])     # DCN phases present
    assert all(len(s) == 6 and s[5] == 0 for s in got["shards"])


@pytest.mark.parametrize("P", [4, 8])
def test_pack_pair_is_the_ports_gather(P):
    """The pack entry counts the columns the port's pack gathers for each
    shard: `_pack` turns (P, rows, ndev) into (P, nphases, rows, s_max)
    send buffers in one index gather over every phase, a shard's
    self-phases (dsts[d, k] == d) included."""
    m = generate_mesh(10, 10, 10, **MESH)
    geo = sm.shard_geometry(m, P)
    model = GreenGaussTorch(partition_mesh(m, P), 3, device="cpu")
    assert model.moves
    buf = model._pack(torch.zeros(P, 24, model.ndev), model.send_mask)
    assert buf.shape == (P, model.nphases, 24, model.s_max)
    assert model.s_max == geo["s_max"]
    assert [s[4] for s in geo["shards"]] == \
        [model.nphases * model.s_max] * P
    self_phases = int((model.dsts == torch.arange(P)[:, None]).sum())
    assert (self_phases > 0) == (P == 8)      # this mesh: pads at P=8 only


def test_pack_pair_zero_without_exchange():
    """One shard moves nothing: the port skips the pack (`moves` false)."""
    m = generate_mesh(10, 10, 10, **MESH)
    geo = sm.shard_geometry(m, 1)
    assert not GreenGaussTorch(partition_mesh(m, 1), 3, device="cpu").moves
    assert geo["shards"][0][4:] == (0, 0)


@pytest.mark.parametrize("P,slice_size", [(2, None), (8, None), (8, 4)])
def test_eval_matches_reference_on_same_geometry(P, slice_size):
    m = generate_mesh(12, 12, 12, **MESH)
    geo = sm.shard_geometry(m, P, slice_size=slice_size)
    for table in sm.RATE_TABLES.values():
        kw = dict(overlap_fixed_us=sm.OVERLAP_FIXED_US, halo_bytes=4,
                  rate_table=table, bulk_fixed_us=sm.BULK_FIXED_US,
                  dcn_gbps=sm.IB_NDR_GBPS,
                  pack_ns_per_col=sm.PACK_NS_PER_COL)
        got = sm.eval_geometry(geo, None, sm.NVLINK_GBPS, 24, **kw)
        assert got == r_sm.eval_geometry(geo, None, sm.NVLINK_GBPS, 24,
                                         **kw)
    got = sm.eval_geometry(geo, 0.1, 45.0, 8, halo_bytes=2)
    assert got == r_sm.eval_geometry(geo, 0.1, 45.0, 8, halo_bytes=2)
    m_r = r_generate_mesh(12, 12, 12, **MESH)
    assert sm.model_partitioning(m, P, 0.1, 45.0, 24,
                                 slice_size=slice_size) == \
        r_sm.model_partitioning(m_r, P, 0.1, 45.0, 24, slice_size=slice_size)


def test_tables_and_defaults_are_measured():
    """Every rate and chain default is a positive number of the card; the
    interconnect defaults are the ASSUMED NVLink and InfiniBand rates."""
    for rows in sm.RATE_TABLES.values():
        assert rows and all(n > 0 and 0 < r < 10 for n, r in rows)
    assert set(sm.RATE_TABLES) == set(r_sm.RATE_TABLES)
    assert sm.RATE_TABLES != r_sm.RATE_TABLES
    assert sm.BULK_FIXED_US > 0 and sm.OVERLAP_FIXED_US > 0
    assert sm.PACK_NS_PER_COL > 0
    assert (sm.NVLINK_GBPS, sm.IB_NDR_GBPS) == (450.0, 50.0)
    assert not hasattr(sm, "V5E_HBM_GBPS") and not hasattr(sm, "V5P_ICI_GBPS")


# ---- the reference's scaling tests (tests/test_tools.py), on the port

def test_scaling_model_runs(capsys):
    assert sm.main(["--nx", "10", "--parts", "1", "2", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# MODEL (not measurement)")
    assert sm.CARD in out
    assert "GB/s NVLink (ASSUMED)" in out
    assert out.strip().splitlines()[-1].split()[0] == "4"


def test_scaling_model_rate_table(capsys):
    """Measured-rate interpolation: exact at anchors, clamped outside the
    measured range, between neighbours inside; --ns-per-face still
    overrides with a constant; the default is the f32 table."""
    t = sorted(sm.RATE_TABLES["f32"])
    assert sm.rate_ns_per_face(t[0][0], t) == t[0][1]
    assert sm.rate_ns_per_face(t[-1][0], t) == t[-1][1]
    assert sm.rate_ns_per_face(1, t) == t[0][1]          # clamp below
    assert sm.rate_ns_per_face(10**12, t) == t[-1][1]    # clamp above
    for (n0, r0), (n1, r1) in zip(t, t[1:]):
        mid = sm.rate_ns_per_face(int(np.sqrt(n0 * n1)), t)
        assert min(r0, r1) <= mid <= max(r0, r1)
        assert mid == pytest.approx(0.5 * (r0 + r1), rel=1e-4)  # log midpoint
    assert sm.main(["--nx", "10", "--parts", "1", "2"]) == 0
    out = capsys.readouterr().out
    assert "measured f32 rate table" in out
    assert sm.main(["--nx", "10", "--parts", "1", "2",
                    "--ns-per-face", "0.2"]) == 0
    assert "constant (override)" in capsys.readouterr().out


def test_shard_geometry_uses_production_layout():
    """shard_geometry builds the comm-first relabeled layout the model
    runs: its phases are whole interval slices (no tail, as in the
    reference's geometry), yet the port gathers every column of its send
    buffer, so the pack entry is nphases × s_max on every shard."""
    m = generate_mesh(24, 24, 24, **MESH)
    geo = sm.shard_geometry(m, 2)
    ref = r_sm.shard_geometry(r_generate_mesh(24, 24, 24, **MESH), 2)
    assert all(s[4:] == (0, 0) for s in ref["shards"])
    for s in geo["shards"]:
        assert len(s) == 6
        assert s[4] == geo["s_max"] > 0 and s[5] == 0     # one phase


def test_shard_geometry_interval_elimination_p8():
    """At P=8 the reference's layout is pure interval slices (its pack
    charge 0); the port charges its gather of all of them."""
    m = generate_mesh(24, 24, 24, **MESH)
    geo = sm.shard_geometry(m, 8)
    ref = r_sm.shard_geometry(r_generate_mesh(24, 24, 24, **MESH), 8)
    assert all(s[4] == 0 and s[5] == 0 for s in ref["shards"])
    model = GreenGaussTorch(partition_mesh(m, 8), 3, device="cpu")
    assert model.s_max == geo["s_max"]
    assert all(s[4] == model.nphases * model.s_max and s[5] == 0
               for s in geo["shards"])


def test_scaling_model_multislice(capsys):
    """--slice-size charges inter-node (DCN) phases at --dcn-gbps: with a
    slow link the modeled step times rise above the one-node prediction at
    the same P (compared unrounded: at this size the printed Gf/s of both
    round alike), and the header flags the assumption."""
    assert sm.main(["--nx", "10", "--parts", "4", "--slice-size", "2",
                    "--dcn-gbps", "1"]) == 0
    assert "DCN phases at 1.0 GB/s InfiniBand, ASSUMED" in \
        capsys.readouterr().out
    m = generate_mesh(10, 10, 10, **MESH)
    kw = dict(overlap_fixed_us=sm.OVERLAP_FIXED_US,
              bulk_fixed_us=sm.BULK_FIXED_US,
              pack_ns_per_col=sm.PACK_NS_PER_COL,
              rate_table=sm.RATE_TABLES["f32"], dcn_gbps=1.0)
    one = sm.eval_geometry(sm.shard_geometry(m, 4), None, sm.NVLINK_GBPS,
                           24, **kw)
    multi = sm.eval_geometry(sm.shard_geometry(m, 4, slice_size=2), None,
                             sm.NVLINK_GBPS, 24, **kw)
    assert multi["t_bulk"] > one["t_bulk"]
    assert multi["t_over"] > one["t_over"]


def _parser(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser `main` builds, taken at its parse_args."""
    seen = []

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main([])
    return seen[0]


def test_cli_options_equal_reference(monkeypatch):
    def options(main):
        return {s for a in _parser(main, monkeypatch)._actions
                for s in a.option_strings}

    assert options(sm.main) == options(r_sm.main)


def test_help_marks_interconnect_assumed(monkeypatch):
    helps = {a.dest: a.help for a in _parser(sm.main, monkeypatch)._actions}
    assert "ASSUMED" in helps["ici_gbps"] and "NVLink" in helps["ici_gbps"]
    assert "ASSUMED" in helps["dcn_gbps"] and \
        "InfiniBand" in helps["dcn_gbps"]
    for k in ("bulk_fixed_us", "pack_ns_per_col", "overlap_fixed_us"):
        assert "MEASURED" in helps[k], k


# ---- the measurement tool, on the plain versions

def test_scaling_inputs_rates(capsys):
    assert scaling_inputs.main(["rates", "--nx", "6", "--iters", "2",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("python -m cfd_proxy_tpu_torch.solver --nx 6 --ny 6 --nz 6 "
            "--parts 1 --schedule bulk") in out
    assert "--src-dtype bfloat16 --meta-dtype bfloat16" in out
    assert re.search(r'^"f32": \[\n    \(566, [0-9.]+\),  # nx=6', out, re.M)
    assert '"reduced": [' in out


def test_scaling_inputs_chain(capsys):
    assert scaling_inputs.main(["chain", "--nx", "10", "--sends", "128",
                                "256", "--iters", "2", "--repeats", "1",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "--min-phases 6 --fake-sends 256 --schedule all" in out
    assert re.findall(r"cols=(\d+)", out) == ["768", "1536"]
    for name in ("BULK_FIXED_US", "PACK_NS_PER_COL", "OVERLAP_FIXED_US"):
        assert re.search(rf"^{name} = -?[0-9.]+$", out, re.M), name
