"""Entry points of the port: the solver CLI on the CPU (static iteration
and solver mode; the reference's mesh options, each option outside the
port refused by name, the reference's message for a missing `--mesh`
file), and chip_smoke.py's refusal to run (or report success) without a
CUDA card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from cfd_proxy_tpu_torch import solver
from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.utils.errors import CheckError

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
    """The XLA backend is an option still outside the port (the
    reduced-precision options and the multi-node phase routing are in it:
    tests/test_torch_precision.py, tests/test_torch_transport.py)."""
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--nx", "6",
         "--ny", "6", "--nz", "6", "--device", "cpu", "--backend", "xla"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode != 0
    assert "ROADMAP" in res.stderr


def test_solver_cli_ghost_layers_matches_reference(capsys):
    """--ghost-layers 2 reaches the partition: on the same 8³ mesh at 4
    shards the port's CLI counts the reference CLI's faces (more than one
    ghost layer gives) and reports its verify numbers."""
    from cfd_proxy_tpu import solver as ref_solver

    argv = ["--ghost-layers", "2", "--nx", "8", "--ny", "8", "--nz", "8",
            "--parts", "4", "--iters", "2", "--json"]
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", *argv,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode == 0, res.stderr
    port = json.loads(res.stdout.strip().splitlines()[-1])
    assert ref_solver.main([*argv, "--warmup", "0"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    m = generate_mesh(8, 8, 8, jitter=0.05, diag_frac=0.2, seed=0)
    one = sum(p.nface for p in partition_mesh(m, 4, ghost_layers=1))
    assert port["nface"] == ref["nface"] > one
    assert port["npoint"] == ref["npoint"]
    assert sorted(port["verification"]) == sorted(ref["verification"])
    for k, v in ref["verification"].items():
        assert port["verification"][k] == pytest.approx(v, rel=1e-6,
                                                        abs=1e-12), k
    assert port["verification"]["bulk_vs_golden_relmax"] <= 1e-5


def test_solver_cli_mesh_options_reach_the_generator(capsys):
    """--diag-frac, --stretch, --hub-frac and --hub-extra build the
    reference's generated mesh, and the golden is taken on it."""
    opts = dict(diag_frac=0.3, stretch=1.2, hub_frac=0.2, hub_extra=4)
    argv = ["--nx", "6", "--ny", "6", "--nz", "6", "--device", "cpu",
            "--iters", "2", "--schedule", "bulk", "--json"]
    for k, v in opts.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    assert solver.main(argv) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    m = generate_mesh(6, 6, 6, jitter=0.05, seed=0, **opts)
    plain = generate_mesh(6, 6, 6, jitter=0.05, diag_frac=0.2, seed=0)
    assert d["nface"] == m.nface != plain.nface
    assert d["verification"]["bulk_vs_golden_relmax"] < 1e-5


REFUSALS = [(["--backend", "xla"], "item 10"),
            (["--dtype", "float64"], "item 10"),
            (["--profile", "trace_dir"], "item 11b"),
            (["--min-phases", "3"], "item 11b"),
            (["--fake-sends", "256"], "item 11b"),
            (["--fake-tail-frac", "0.5"], "item 11b"),
            (["--pack-force", "gather"], "queue 2"),
            (["--platform", "cpu"], "queue 2")]


@pytest.mark.parametrize("opt,item", REFUSALS, ids=[o[0] for o, _ in REFUSALS])
def test_solver_cli_refuses_each_unported_option_by_name(opt, item):
    """The reference's options outside the port parse (argparse would exit
    2) and are refused by name, naming the ROADMAP item that brings them."""
    with pytest.raises(CheckError, match=f"{opt[0]} .*ROADMAP.*{item}"):
        solver.main(["--nx", "6", "--ny", "6", "--nz", "6", "--device",
                     "cpu", *opt])


def test_solver_cli_missing_mesh_file_gives_reference_message(tmp_path):
    prefix = str(tmp_path / "m")
    with pytest.raises(SystemExit) as e:
        solver.main(["--mesh", prefix, "--parts", "2", "--device", "cpu"])
    msg = str(e.value.code)
    assert msg.startswith(f"mesh partition file not found: {prefix}.2p.0.nc"
                          " — expected <prefix>.<parts>p.<i>.nc")
    assert f"--parts 2 --out {prefix}" in msg and "--ghost-layers" in msg


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
