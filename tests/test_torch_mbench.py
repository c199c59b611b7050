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
    """A side the port cannot drive (backend=xla) exits with the refusal."""
    with pytest.raises(SystemExit):
        main([*SMALL, "--b", "backend=xla"])
    assert "item 10" in capsys.readouterr().err


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
