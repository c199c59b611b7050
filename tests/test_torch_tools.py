"""The port's tools beside the solver, on the CPU: the golden tool against
the reference's (byte-identical dumps, the shipped golden file matched bit
for bit, the perturbed-config gate, the kernel model within 1e-5 and the
ELL model in f64 within 1e-12, the flux round trip), the fixture tool (a
small recipe through generate and verify, its files hashed equal to the
reference tool's, the shared manifest never written), the solver-mode
attribution (every knockout mode, both kernels) and the dry run (every leg
at 8 shards)."""

import hashlib
import json
import os

import pytest

from cfd_proxy_tpu.tools import fixture as ref_fixture
from cfd_proxy_tpu.tools.golden import main as ref_golden
from cfd_proxy_tpu_torch.tools import dryrun, fixture, solver_attrib
from cfd_proxy_tpu_torch.tools.golden import main as golden_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GOLDEN = os.path.join(REPO, "data", "small_golden.nc")
SMALL = ["--nx", "12", "--ny", "10", "--nz", "8"]


@pytest.mark.parametrize("model", ["gg", "flux"])
def test_golden_dump_is_the_reference_file(tmp_path, model):
    port, ref = str(tmp_path / "port.nc"), str(tmp_path / "ref.nc")
    argv = ["dump", "--nx", "8", "--model", model]
    assert golden_main([*argv, "--out", port]) == 0
    assert ref_golden([*argv, "--out", ref]) == 0
    assert open(port, "rb").read() == open(ref, "rb").read()


def test_golden_check_shipped_file_bitwise(capsys):
    assert golden_main(["check", *SMALL, "--ref", SMALL_GOLDEN]) == 0
    assert "bitwise MATCH" in capsys.readouterr().out


def test_golden_check_perturbed_config_fails(capsys):
    assert golden_main(["check", *SMALL, "--ref", SMALL_GOLDEN, "--seed",
                        "1"]) == 1
    assert "config MISMATCH" in capsys.readouterr().out


@pytest.mark.parametrize("backend,schedule,bound", [
    ("pallas", "overlap", "1e-05"), ("xla", "overlap", "1e-12"),
    ("xla", "bulk", "1e-12")])
def test_golden_check_models(capsys, backend, schedule, bound):
    """The kernel model (f32) at P=4 and the ELL model in f64 against the
    shipped golden, within the reference's bounds."""
    assert golden_main(["check", *SMALL, "--ref", SMALL_GOLDEN, "--backend",
                        backend, "--parts", "4", "--schedule", schedule,
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"(bound {bound})" in out and out.strip().endswith("OK")


def test_golden_flux_round_trip(tmp_path):
    ref = str(tmp_path / "flux.nc")
    assert golden_main(["dump", "--nx", "8", "--model", "flux", "--out",
                        ref]) == 0
    assert golden_main(["check", "--nx", "8", "--model", "flux", "--ref",
                        ref]) == 0
    assert golden_main(["check", "--nx", "8", "--model", "flux", "--ref",
                        ref, "--backend", "pallas", "--parts", "2",
                        "--schedule", "overlap", "--device", "cpu"]) == 0
    with pytest.raises(SystemExit, match="requires --backend pallas"):
        golden_main(["check", "--nx", "8", "--model", "flux", "--ref", ref,
                     "--backend", "xla", "--device", "cpu"])
    with pytest.raises(SystemExit, match="dumped with --model flux"):
        golden_main(["check", "--nx", "8", "--ref", ref])


def _digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_fixture_generate_verify_and_tamper(tmp_path, monkeypatch):
    """generate writes files and a manifest under --dir only; verify
    rebuilds from the manifest's stored recipe (a later RECIPE change is
    not corruption); a tampered hash fails; the files hash equal to the
    reference tool's."""
    shared = _digest(fixture.MANIFEST)
    tiny = dict(fixture.RECIPE, nx=6, ny=6, nz=5, parts=[2])
    monkeypatch.setattr(fixture, "RECIPE", tiny)
    a = tmp_path / "a"
    assert fixture.main(["generate", "--dir", str(a)]) == 0
    manifest = str(a / fixture.MANIFEST_NAME)
    assert sorted(os.listdir(a)) == sorted(
        ["large.2p.0.nc", "large.2p.1.nc", fixture.MANIFEST_NAME])
    assert fixture.main(["verify", "--dir", str(tmp_path / "b"),
                         "--manifest", manifest]) == 0
    monkeypatch.setattr(fixture, "RECIPE", dict(tiny, seed=tiny["seed"] + 1))
    assert fixture.main(["verify", "--dir", str(tmp_path / "c"),
                         "--manifest", manifest]) == 0
    ref = ref_fixture.build(str(tmp_path / "ref"), tiny)
    assert json.load(open(manifest))["sha256"] == ref
    m = json.load(open(manifest))
    key = next(k for k in m["sha256"] if k != "_mesh")
    m["sha256"][key] = "0" * 64
    json.dump(m, open(manifest, "w"))
    assert fixture.main(["verify", "--dir", str(tmp_path / "d"),
                         "--manifest", manifest]) == 1
    assert _digest(fixture.MANIFEST) == shared


@pytest.mark.parametrize("kernel,bp", [("packed", None), ("gather", 128)])
def test_solver_attrib_runs_every_mode(kernel, bp):
    """Every knockout body builds and runs on the port's model (CPU times
    may sit below the noise floor: an empty sample list is fine)."""
    from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
    from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
    from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch

    m = generate_mesh(8, 8, 8, jitter=0.05, diag_frac=0.2, seed=0)
    model = GreenGaussTorch(partition_mesh(m, 1), 7, kernel=kernel, bp=bp,
                            device="cpu")
    state = model.distribute_state(make_state(m.npoint, 7, seed=1),
                                   schedules=["bulk"])
    got = solver_attrib.attribute(model, state, solver_attrib.MODES, 3, 2)
    assert list(got) == list(solver_attrib.MODES)
    assert all(isinstance(v, list) and len(v) <= 2 for v in got.values())
    v0 = state["var_T"]
    for mode in solver_attrib.MODES:
        v = solver_attrib.knockout_fn(model, state, mode)(2, v0)
        assert v.shape == v0.shape and bool(v.isfinite().all())


def test_solver_attrib_cli(capsys):
    rc = solver_attrib.main(["--nx", "8", "--device", "cpu", "--iters", "3",
                             "--repeats", "2", "--mode", "noop", "all"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "mode=noop" in out and "mode=all" in out


def test_dryrun_every_leg_runs_at_8(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--n", "8", "--device", "cpu", "--out",
                        str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec == json.loads(capsys.readouterr().out.strip())
    assert rec["ok"] and rec["n_shards"] == 8 and rec["device"] == "cpu"
    assert sorted(rec["legs"]) == ["multi_slice", "pallas",
                                   "reduced_precision", "solver_mode", "xla"]
    assert all(v.startswith("ran") for v in rec["legs"].values()), rec


def test_dryrun_skips_legs_by_shard_count():
    legs = dryrun.dryrun(2, "cpu")
    assert legs["multi_slice"].startswith("skipped")
    assert legs["solver_mode"].startswith("ran")
