"""Entry points of the port: the solver CLI on the CPU (static iteration
and solver mode), and chip_smoke.py's refusal to run (or report success)
without a CUDA card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_solver_cli_cpu_json():
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--nx", "8",
         "--ny", "8", "--nz", "8", "--device", "cpu", "--iters", "2",
         "--json"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode == 0, res.stderr
    d = json.loads(res.stdout.strip().splitlines()[-1])
    assert d["device"] == "cpu" and d["npart"] == 1 and d["nface"] > 0
    assert d["verification"]["bulk_vs_golden_relmax"] < 1e-5
    assert "bulk" in d["schedules"]


@pytest.mark.parametrize("parts,extra", [("4", []), ("1", ["--force-rdma"])])
def test_solver_cli_all_schedules_json(parts, extra):
    """--schedule all times bulk, early and overlap and the nocomm floor,
    reports each schedule against bulk and the overlap efficiency (null
    with its reason when the comm cost is under the noise gate)."""
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--nx", "8",
         "--ny", "8", "--nz", "7", "--device", "cpu", "--iters", "2",
         "--parts", parts, "--schedule", "all", "--json", *extra],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode == 0, res.stderr
    d = json.loads(res.stdout.strip().splitlines()[-1])
    assert d["npart"] == int(parts) and d["force_rdma"] == bool(extra)
    assert sorted(d["schedules"]) == ["bulk", "early", "overlap"]
    assert d["nocomm_median_s"] is None or d["nocomm_median_s"] > 0
    v = d["verification"]
    assert v["bulk_vs_golden_relmax"] < 1e-5
    for s in ("early", "overlap"):
        # the gradients here are O(1-10): 1e-6 relative, the reference's gate
        assert v[f"{s}_vs_bulk_maxabs"] < 1e-5
        e = d["schedules"][s]
        eff = e["overlap_efficiency"]
        assert (eff is None and "noise" in e["overlap_efficiency_note"]) or \
            0.0 <= eff <= 1.0


def test_solver_cli_refuses_unported_option():
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--nx", "6",
         "--ny", "6", "--nz", "6", "--device", "cpu", "--src-dtype",
         "bfloat16"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode != 0
    assert "ROADMAP" in res.stderr


def test_solver_cli_solver_mode_json():
    """--solver-mode --sweeps-per-step 2 without --kernel: the decided
    default (solver_mode_defaults), announced on stderr; faces/s counts
    the swept faces, nface * 2 / median."""
    from cfd_proxy_tpu_torch.solver import solver_mode_defaults

    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--nx", "8",
         "--ny", "8", "--nz", "7", "--device", "cpu", "--iters", "2",
         "--parts", "2", "--schedule", "bulk", "--solver-mode",
         "--sweeps-per-step", "2", "--json"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode == 0, res.stderr
    d = json.loads(res.stdout.strip().splitlines()[-1])
    kernel, _ = solver_mode_defaults(2)
    assert d["solver_mode"] is True and d["sweeps_per_step"] == 2
    assert d["kernel"] == kernel
    assert f"--solver-mode defaults to --kernel {kernel}" in res.stderr
    e = d["schedules"]["bulk"]
    assert e["faces_per_sec"] == pytest.approx(d["nface"] * 2 /
                                               e["median_s"], rel=1e-12)
    assert d["verification"]["bulk_vs_golden_relmax"] < 1e-5


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=_env())
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert time.perf_counter() - t0 < 60
