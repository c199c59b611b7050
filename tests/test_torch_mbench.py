"""The port's model-level paired A/B harness
(`cfd_proxy_tpu_torch.tools.mbench`), on the CPU: tests/test_mbench.py's
cases on the port's SolverConfig and model, with `--device cpu` (the
kernels' plain versions; the ratios are mechanics only)."""

import dataclasses
import inspect

import pytest

from cfd_proxy_tpu_torch import solver
from cfd_proxy_tpu_torch.solver import SolverConfig
from cfd_proxy_tpu_torch.tools.mbench import (_MODEL_FIELDS, REFUSED, main,
                                              parse_overrides)
from cfd_proxy_tpu_torch.utils.errors import CheckError

SMALL = ["--nx", "10", "--ny", "9", "--nz", "8", "--parts", "1", "--iters",
         "20", "--repeats", "2", "--warmup", "0", "--device", "cpu"]


def test_parse_overrides_types():
    base = SolverConfig()
    got = parse_overrides(
        base, "src_dtype=bfloat16,bp=512,force_rdma=1,kcompact=off")
    assert got.src_dtype == "bfloat16"
    assert got.bp == 512 and isinstance(got.bp, int)
    assert got.force_rdma is True
    assert got.kcompact is False
    # base is untouched (replace, not mutation)
    assert base.src_dtype == "float32" and base.bp is None  # None = auto bp


def test_parse_overrides_rejects_unknown():
    with pytest.raises(CheckError, match="unknown SolverConfig field"):
        parse_overrides(SolverConfig(), "not_a_field=1")
    with pytest.raises(CheckError, match="field=value"):
        parse_overrides(SolverConfig(), "oops")


def test_parse_overrides_rejects_shared_mesh_fields():
    """Mesh-shaping fields (nx/parts/...) are built from the shared base — a
    per-side override would be silently ignored and record a false ~1.00
    'no difference' verdict; they are rejected up front."""
    for spec in ("nx=64", "parts=2", "ghost_layers=2", "iters=5"):
        with pytest.raises(CheckError, match="cannot differ"):
            parse_overrides(SolverConfig(), spec)


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_refused_fields_name_their_item(field):
    """The reference's model fields the port does not build are refused by
    name, with the ROADMAP item or list that brings them."""
    with pytest.raises(CheckError, match=rf"{field}.*ROADMAP"):
        parse_overrides(SolverConfig(), f"{field}=1")


def test_model_fields_exist():
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    assert set(_MODEL_FIELDS) <= names
    assert not set(_MODEL_FIELDS) & set(REFUSED)


def test_build_consumes_every_model_field():
    """Every _MODEL_FIELDS entry is forwarded by solver.build_model — a
    field that parse_overrides accepts but the build drops makes both sides
    build the same model and records a false ~1.00 verdict."""
    src = inspect.getsource(solver.build_model)
    missing = [f for f in _MODEL_FIELDS if f"cfg.{f}" not in src]
    assert not missing, f"build_model drops model fields: {missing}"


def test_drive_refusals_go_through_check_config(capsys):
    """A side the port cannot drive (solver mode on the xla backend) exits
    with check_config's refusal."""
    with pytest.raises(SystemExit):
        main([*SMALL, "--b", "backend=xla,solver_mode=1"])
    assert "requires the pallas backend" in capsys.readouterr().err


def test_mbench_pairs_the_backends(capsys):
    """backend is a model field: an xla side builds the ELL model of its
    own beside the kernel model."""
    rc = main([*SMALL, "--b", "backend=xla", "--json"])
    assert rc == 0
    out = capsys.readouterr()
    assert '"pairs": 2' in out.out and "share one model" not in out.err


def test_mbench_pairs_the_fake_phases(capsys):
    rc = main([*SMALL, "--b", "min_phases=4,fake_sends=64", "--json"])
    assert rc == 0
    assert '"pairs": 2' in capsys.readouterr().out


def test_mbench_shared_model_schedule_ab(capsys):
    """Schedule A/B on equal configs shares one model and emits the paired
    ratio line."""
    rc = main([*SMALL, "--a", "schedule=bulk", "--b", "schedule=early",
               "--json"])
    assert rc == 0
    out = capsys.readouterr()
    assert '"ratio_a_over_b"' in out.out and '"device": "cpu"' in out.out
    assert "share one model" in out.err


def test_mbench_two_models(capsys):
    rc = main([*SMALL, "--b", "grad_dtype=bfloat16", "--json"])
    assert rc == 0
    assert '"pairs": 2' in capsys.readouterr().out


def test_parse_overrides_takes_slice_size():
    """slice_size is a model field, as in the reference's mbench: the
    routing it selects is built by solver.build_model."""
    assert "slice_size" in _MODEL_FIELDS and "slice_size" not in REFUSED
    assert parse_overrides(SolverConfig(), "slice_size=1").slice_size == 1
    assert parse_overrides(SolverConfig(), "slice_size=None").slice_size \
        is None


def test_mbench_slice_size_ab_builds_each_side(monkeypatch, capsys):
    """An A/B of slice_size=1 against None at four parts runs, each side's
    model built with its own slice_size: side A (one shard a slice) routes
    every phase to the collective carrier, side B keeps them all in the
    kernel."""
    from cfd_proxy_tpu_torch.tools import mbench

    built = []

    def build(cfg, parts):
        model, gmesh = solver.build_model(cfg, parts)
        built.append((cfg.slice_size, model))
        return model, gmesh

    monkeypatch.setattr(mbench, "build_model", build)
    argv = [*SMALL, "--a", "slice_size=1", "--b", "slice_size=None",
            "--json"]
    argv[argv.index("--parts") + 1] = "4"
    assert main(argv) == 0
    assert '"pairs": 2' in capsys.readouterr().out
    (sa, ma), (sb, mb) = built
    assert (sa, sb) == (1, None) and ma is not mb
    every = list(range(ma.nphases))
    assert every and ma.coll_phases == every and not ma.kernel_phases
    assert mb.kernel_phases == every and not mb.coll_phases


def test_platform_is_refused_by_name():
    """The reference's --platform is parsed and refused with a CheckError
    naming --device, as the solver does; not argparse's 'unrecognized
    arguments'."""
    with pytest.raises(CheckError, match="--platform cpu.*--device"):
        main(["--platform", "cpu", *SMALL])
