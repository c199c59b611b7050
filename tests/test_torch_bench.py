"""The port's benchmark entry point (`python -m cfd_proxy_tpu_torch.bench`)
against the root `bench.py`, on the CPU at tiny sizes.

- the same stdout contract: strict JSON as the last line, the reference's
  compact key set and face count under the same environment;
- no fallback: without a card and without BENCH_DEVICE=cpu the run fails
  with a message that names BENCH_DEVICE=cpu;
- the copied pure helpers are the reference's code (AST, docstrings
  dropped);
- the multichip model block on the port's scaling model: every named row
  with its absolute companions, four crossing configurations, strong_P8
  and strong_P64 equal to direct `eval_geometry` calls on the port's
  measured constants;
- the reduced-precision, small-mesh, flux and solver-mode rows, each once,
  with the configuration each hands to `solver.run`.
"""

import ast
import json
import math
import os
import sys

import pytest
import torch

from cfd_proxy_tpu_torch import bench as tbench
from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.solver import SolverConfig
from cfd_proxy_tpu_torch.tools import scaling_model as sm
from cfd_proxy_tpu_torch.utils.errors import CheckError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"BENCH_NX": "8", "BENCH_ITERS": "3", "BENCH_SCHEDULE": "bulk",
        "BENCH_CPU_DRAM_NX": "16"}
HELPERS = ("_finite_or_none", "_sig", "_div", "_compact", "_node_estimate")

torch.set_num_threads(1)


def _env(monkeypatch, **kw):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in {**TINY, **kw}.items():
        monkeypatch.setenv(k, v)


def _full_json(err: str) -> dict:
    line = next(ln for ln in err.splitlines() if ln.startswith("FULL_JSON "))
    return json.loads(line[len("FULL_JSON "):])


def test_cpu_run_matches_reference_contract(monkeypatch, capsys):
    _env(monkeypatch, BENCH_DEVICE="cpu")
    assert tbench.main() == 0
    cap = capsys.readouterr()
    port = json.loads(cap.out.strip().splitlines()[-1])     # strict JSON
    full = _full_json(cap.err)
    assert port["metric"] == "faces_per_sec_per_chip"
    assert port["platform"] == "cpu" and full["platform"] == "cpu"
    assert port["kernel"] == "packed" and port["schedule"] == "bulk"
    assert full["kernel_launches"] == {}        # plain versions on the CPU
    sys.path.insert(0, REPO)
    import bench

    assert bench.main() == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port["nface"] == ref["nface"] > 0
    assert set(port) == set(ref)


def test_no_card_fails_without_fallback(monkeypatch, capsys):
    _env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CheckError, match="BENCH_DEVICE=cpu"):
        tbench.main()
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("BENCH_DEVICE", "tpu")
    with pytest.raises(CheckError, match="BENCH_DEVICE=tpu: cuda or cpu"):
        tbench.main()


def _funcs(path):
    """Top-level functions of a module, docstrings dropped."""
    out = {}
    for node in ast.parse(open(os.path.join(REPO, path)).read()).body:
        if isinstance(node, ast.FunctionDef):
            body = node.body
            if (isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", HELPERS)
def test_helper_is_reference_code(name):
    assert (_funcs("cfd_proxy_tpu_torch/bench.py")[name]
            == _funcs("bench.py")[name])


def test_model_block_on_the_port_model(monkeypatch, capsys):
    _env(monkeypatch, BENCH_DEVICE="cpu", BENCH_MODEL_BLOCK="force",
         BENCH_NORTHSTAR_NX="12", BENCH_CROSSING_NX="8,12")
    assert tbench.main() == 0
    cap = capsys.readouterr()
    mc = _full_json(cap.err)["multichip_model"]
    for k in ("strong_P8", "strong_P8_bf16halo", "strong_P64",
              "weak_F6class_P8"):
        assert "exposed_comm_us" in mc[k] and "ovl_x_bulk" in mc[k], k
    assert [float(k) for k in
            mc["strong_P8_eff_solverdef_vs_pack_ns_per_col"]] == [
        f * sm.PACK_NS_PER_COL for f in (0.0, 0.5, 1.0, 2.0)]
    cfgs = ("nvlink_f32", "nvlink_bf16halo", "nvlink_reduced",
            "nvlink_reduced_bf16halo")
    cross = mc["crossing_ge85_shard_faces_P8"]
    curves = mc["eff_vs_shard_faces_P8"]
    assert set(cross) == {*cfgs, "note"} and set(curves) == set(cfgs)
    for cfg in cfgs:
        assert len(curves[cfg]) == 2
        for e in curves[cfg]:
            assert set(e) == {"shard_faces", "eff_solverdef",
                              "exposed_comm_us", "ovl_x_bulk"}
    # the reduced table's rows differ from the f32 table's
    assert curves["nvlink_f32"] != curves["nvlink_reduced"]
    assert sm.CARD in mc["note"]

    gm = generate_mesh(8, 8, 8, jitter=0.05, diag_frac=0.2, seed=0)
    kw = dict(rate_table=sm.RATE_TABLES["f32"],
              overlap_fixed_us=sm.OVERLAP_FIXED_US,
              bulk_fixed_us=sm.BULK_FIXED_US,
              pack_ns_per_col=sm.PACK_NS_PER_COL, halo_bytes=4)
    for key, geo, extra in (
            ("strong_P8", sm.shard_geometry(gm, 8), {}),
            ("strong_P64", sm.shard_geometry(gm, 64, slice_size=8),
             {"dcn_gbps": sm.IB_NDR_GBPS})):
        r = sm.eval_geometry(geo, None, sm.NVLINK_GBPS, 24, **kw, **extra)
        assert mc[key]["nface"] == r["nface"]
        assert mc[key]["bulk_gfps"] == r["nface"] / r["t_bulk"] / 1e9
        assert mc[key]["overlap_gfps"] == r["nface"] / r["t_over"] / 1e9
        assert mc[key]["eff_solverdef"] == r["eff_solverdef"]
        assert mc[key]["exposed_comm_us"] == (
            (r["t_over"] - r["t_nocomm"]) * 1e6)
    c = json.loads(cap.out.strip().splitlines()[-1])
    assert ("cross85_P8_shard_faces" in c["mc_model"]
            or "mc_model" in c.get("dropped", []))


def _recorded_runs(monkeypatch):
    """Wrap the bench's `run` to record the configuration of every row."""
    seen = []
    real = tbench.run

    def rec(cfg):
        seen.append(cfg)
        return real(cfg)

    monkeypatch.setattr(tbench, "run", rec)
    return seen


def _finite_or_nan(x):
    assert isinstance(x, float) and (math.isnan(x) or x > 0), x


CFG = SolverConfig(nx=6, ny=6, nz=6, iters=3, warmup=1, schedule="all",
                   force_rdma=True, verify=False, device="cpu")


@pytest.mark.parametrize("row", ["reduced", "small", "flux", "solver_mode"])
def test_row_runs_its_configuration(monkeypatch, capsys, row):
    seen = _recorded_runs(monkeypatch)
    if row == "reduced":
        got = tbench.reduced_row(CFG, {"faces_per_sec": 2.0})
        assert [(c.src_dtype, c.meta_dtype, c.grad_dtype, c.kernel,
                 c.schedule, c.force_rdma) for c in seen] == [
            ("bfloat16", "bfloat16", "float32", "packed", "bulk", False),
            ("bfloat16", "bfloat16", "bfloat16", "packed", "bulk", False)]
        _finite_or_nan(got["speedup_vs_f32"])
        bg = got["with_bf16_grads"]
        _finite_or_nan(bg["speedup_vs_reduced"])
        assert "NVIDIA H100 80GB HBM3, 700.00 W" in bg["note"]
    elif row == "small":
        got = tbench.small_row(CFG, 5, 4)
        assert [(c.nx, c.schedule, c.force_rdma, c.iters) for c in seen] == [
            (5, "all", True, 4)]
        assert got["nface"] == generate_mesh(
            5, 5, 5, jitter=0.05, diag_frac=0.2, seed=0).nface
        assert set(got["schedules"]) == {"bulk", "early", "overlap"}
        _finite_or_nan(got["overlap_speedup_vs_bulk"])
    elif row == "flux":
        got = tbench.flux_row(CFG)
        assert [(c.model, c.kernel, c.schedule) for c in seen] == [
            ("flux", "packed", "bulk")]
        assert got["model"] == "flux"
        _finite_or_nan(got["median_ms"])
    else:
        got = tbench.solver_mode_row(CFG, [2])
        # the port's solver_mode_defaults: gather/512 at every N
        assert [(c.solver_mode, c.kernel, c.bp, c.sweeps_per_step, c.iters)
                for c in seen] == [(True, "gather", 512, 1, 50),
                                   (True, "gather", 512, 2, 50)]
        e = got["sweeps_per_step"]["2"]
        assert (e["kernel"], e["bp"]) == ("gather", 512)
        assert e["ms_per_sweep"] * 2 == pytest.approx(e["ms_per_step"])
        assert "rebuild-bound" not in got["note"]
    json.dumps(tbench._finite_or_none(got), allow_nan=False)
    assert capsys.readouterr().out == ""        # rows log to stderr only
