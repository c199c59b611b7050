"""Entry points of the port: the solver CLI on the CPU (static iteration
and solver mode; the reference's mesh options; the xla backend in f32 and
f64, `--profile`, the fake exchange phases, each with what it reports;
the reference's refusals of option pairs, each option outside the port
refused by name, the reference's message for a missing `--mesh` file),
the port's partition tool against the reference's, and chip_smoke.py's
refusal to run (or report success) without a CUDA card."""

import json
import os
import subprocess
import sys
import time

import numpy as np
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


def test_solver_cli_xla_f64_reports_golden_at_ulp():
    """--backend xla --dtype float64 at 4 shards, every schedule: the ELL
    model's golden error at ULP level, the schedules equal to roundoff."""
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--backend",
         "xla", "--dtype", "float64", "--parts", "4", "--schedule", "all",
         "--device", "cpu", "--nx", "10", "--ny", "9", "--nz", "8",
         "--iters", "2", "--json"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode == 0, res.stderr
    d = json.loads(res.stdout.strip().splitlines()[-1])
    assert (d["backend"], d["dtype"], d["npart"]) == ("xla", "float64", 4)
    assert sorted(d["schedules"]) == ["bulk", "early", "overlap"]
    v = d["verification"]
    assert v["bulk_vs_golden_relmax"] <= 1e-15
    assert v["early_vs_bulk_maxabs"] <= 1e-12
    assert v["overlap_vs_bulk_maxabs"] <= 1e-12


def _cli_json(capsys, *argv):
    assert solver.main(["--nx", "8", "--ny", "8", "--nz", "7", "--device",
                        "cpu", "--iters", "2", "--json", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_solver_cli_xla_f32(capsys):
    """--backend xla in f32 (the default dtype): the f32 gate, the ELL
    model's keys in the report."""
    d = _cli_json(capsys, "--backend", "xla", "--parts", "3")
    assert (d["backend"], d["dtype"], d["transport"]) == \
        ("xla", "float32", "loopback")
    assert d["nphases"] >= 1 and d["reduce_bytes"] > 0
    v = d["verification"]
    assert v["bulk_vs_golden_relmax"] < 1e-5
    assert v["early_vs_bulk_maxabs"] < 1e-5


def test_solver_cli_xla_two_ranks(capsys):
    """--backend xla --ranks 2 (gloo): the buffers travel by Dist and the
    golden error is the one-process run's."""
    one = _cli_json(capsys, "--backend", "xla", "--dtype", "float64",
                    "--parts", "4", "--schedule", "early")
    two = _cli_json(capsys, "--backend", "xla", "--dtype", "float64",
                    "--parts", "4", "--schedule", "early", "--ranks", "2")
    assert two["transport"] == "dist/gloo" and two["ranks"] == 2
    assert two["verification"] == one["verification"]


def test_solver_cli_profile_writes_a_trace(capsys, tmp_path):
    """--profile DIR: a Chrome trace JSON of the timed loops, named in the
    report, with the model's ops and the port's cfd.* spans in it; the span
    recorder is off again after."""
    from cfd_proxy_tpu_torch.utils import spans

    d = _cli_json(capsys, "--schedule", "bulk", "--profile",
                  str(tmp_path / "prof"))
    path = d["profile"]
    assert path == str(tmp_path / "prof" / "trace.rank0.json")
    trace = json.load(open(path))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert {"cfd.runner", "cfd.sweep.bulk", "cfd.update"} <= names
    assert not spans.enabled()


def test_solver_cli_min_phases(capsys):
    """--min-phases pads the schedule with self-send phases (one shard:
    one natural phase); the results do not move."""
    d = _cli_json(capsys, "--min-phases", "3")
    assert (d["nphases"], d["min_phases"]) == (3, 3)
    v = d["verification"]
    assert v["bulk_vs_golden_relmax"] < 1e-5
    assert v["early_vs_bulk_maxabs"] < 1e-5


def test_solver_cli_fake_sends(capsys):
    """--fake-sends: the padded phases carry real payloads; owned columns
    agree across schedules and with the golden."""
    d = _cli_json(capsys, "--parts", "4", "--min-phases", "8",
                  "--fake-sends", "96")
    assert (d["nphases"], d["fake_sends"]) == (8, 96)
    v = d["verification"]
    assert v["bulk_vs_golden_relmax"] < 1e-5
    assert v["early_vs_bulk_maxabs"] < 1e-5
    assert v["overlap_vs_bulk_maxabs"] < 1e-5


def test_solver_cli_fake_tail_frac(capsys):
    d = _cli_json(capsys, "--fake-sends", "256", "--fake-tail-frac", "0.5",
                  "--schedule", "overlap")
    assert d["fake_tail_frac"] == 0.5 and d["nphases"] == 1
    assert d["verification"]["bulk_vs_golden_relmax"] < 1e-5


@pytest.mark.parametrize("opt,match", [
    (["--fake-tail-frac", "0.25"], "needs fake_sends"),
    (["--dtype", "float64"],
     "pallas backend is float32; use --backend xla for f64"),
    (["--backend", "xla", "--model", "flux"],
     "--model flux requires --backend pallas"),
    (["--backend", "xla", "--solver-mode"],
     "--solver-mode requires the pallas backend"),
    (["--backend", "xla", "--src-dtype", "bfloat16"], "a pallas option"),
    (["--backend", "xla", "--fake-sends", "64"], "a pallas option"),
], ids=["tail-without-fake-sends", "f64-pallas", "flux-xla",
        "solver-mode-xla", "bf16-xla", "fake-xla"])
def test_solver_cli_refuses_option_pairs(opt, match):
    """Pairs the reference refuses, with its messages, and the pairs that
    would do nothing (a tail fraction without fake lanes; the kernel
    model's options on the xla backend)."""
    with pytest.raises(CheckError, match=match):
        solver.main(["--nx", "6", "--ny", "6", "--nz", "6", "--device",
                     "cpu", *opt])


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


REFUSALS = [(["--pack-force", "gather"], "queue 2"),
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


PORT_PARTITION = """
import sys
sys.modules["jax"] = None            # any import of jax now raises
sys.modules["cfd_proxy_tpu"] = None  # and so does any of the JAX package
sys.path.insert(0, {repo!r})
from cfd_proxy_tpu_torch.tools import partition
rc = partition.main({argv!r})
assert not any(k == "jax" or k.startswith("jax.") or k == "cfd_proxy_tpu"
               or k.startswith("cfd_proxy_tpu.")
               for k, v in sys.modules.items() if v is not None)
sys.exit(rc)
"""


def test_partition_tool_writes_the_reference_files(tmp_path):
    """The port's partition tool (run with JAX and the JAX package
    unimportable) and the reference's write the same file names for the
    same options, and the files read back equal; the port's solver reads
    them with --mesh (no golden: a read mesh has no global form)."""
    from cfd_proxy_tpu.mesh.reader import read_partition as ref_read
    from cfd_proxy_tpu.tools import partition as ref_tool
    from cfd_proxy_tpu_torch.mesh.reader import read_partition

    opts = ["--nx", "8", "--nz", "6", "--parts", "3", "--seed", "2"]
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    res = subprocess.run(
        [sys.executable, "-c", PORT_PARTITION.format(
            repo=REPO, argv=[*opts, "--out", str(port / "m")])],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("wrote ") == 3
    assert ref_tool.main([*opts, "--out", str(ref / "m")]) == 0
    names = sorted(f.name for f in port.iterdir())
    assert names == sorted(f.name for f in ref.iterdir()) == \
        [f"m.3p.{i}.nc" for i in range(3)]
    for name in names:
        a, b = read_partition(str(port / name)), ref_read(str(ref / name))
        for f in ("part_id", "npart", "nowned"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        for f in ("coords", "global_ids", "faces", "normals", "volume"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)
        assert len(a.comm) == len(b.comm) > 0
        for x, y in zip(a.comm, b.comm):
            assert (x.partner, x.round) == (y.partner, y.round)
            assert np.array_equal(x.sendidx, y.sendidx)
            assert np.array_equal(x.recvidx, y.recvidx)
    res = subprocess.run(
        [sys.executable, "-m", "cfd_proxy_tpu_torch.solver", "--mesh",
         str(port / "m"), "--parts", "3", "--device", "cpu", "--iters", "2",
         "--schedule", "bulk", "--json"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert res.returncode == 0, res.stderr
    d = json.loads(res.stdout.strip().splitlines()[-1])
    assert d["npart"] == 3 and "bulk" in d["schedules"]
    assert d["nface"] == sum(read_partition(str(port / n)).nface
                             for n in names) > 0


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
