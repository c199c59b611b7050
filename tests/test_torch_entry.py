"""Entry points of the port: the solver CLI on the CPU, and chip_smoke.py's
refusal to run (or report success) without a CUDA card."""

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


def test_solver_cli_refuses_unported_option():
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--nx", "6",
         "--ny", "6", "--nz", "6", "--device", "cpu", "--schedule", "overlap"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode != 0
    assert "ROADMAP" in res.stderr


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
