"""`correct` on small CPU runs of every cell: true for the program, false for
its bf16-gradient control and for each fault a cell can have, planted under
the timed path.  The chip's readings at the cells' own sizes are in PERF.md
(`python3 -m cfdbench.readings`)."""

from __future__ import annotations

import pytest
import torch

from cfd_proxy_tpu_torch.models import gradients
from cfdbench.tests.conftest import files_cell, run_small

ONE_RANK = ["gg96.p1.bulk", "gg96.p8.overlap", "gg96-solver.p1.bulk"]


@pytest.mark.parametrize("workload", ONE_RANK)
def test_the_program_is_correct_on_a_small_mesh(workload):
    out = run_small(workload)
    assert out["correct"], out["checks"]


def test_four_ranks_are_correct_on_a_small_mesh():
    # the four-card cell's path on four CPU processes (gloo, dist transport)
    out = run_small(files_cell("gg152", "w4.overlap"), nx=10)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4


@pytest.mark.parametrize("workload", ONE_RANK)
def test_the_bf16_gradient_control_is_not_correct(workload):
    out = run_small(workload, overrides={"grad_dtype": "bfloat16"})
    assert not out["correct"]
    assert max(c["value"] / c["limit"] for c in out["checks"].values()) > 3


def _unchanged(v, g, coupling, out=None):
    """A step that returns its state unchanged."""
    return v.clone() if out is None else out.copy_(v)


def _half_left_out(orig):
    """Half the points left out of the sweep: every other column of each
    shard reads zero."""
    def sweep(self, *a, **kw):
        g = orig(self, *a, **kw)
        g[..., 1::2] = 0
        return g
    return sweep


def _altered(orig):
    """One answer altered where it is produced."""
    def sweep(self, *a, **kw):
        g = orig(self, *a, **kw)
        g[0, 0, 3] += 1.0
        return g
    return sweep


FAULTS = {
    "unchanged": lambda mp: mp.setattr(gradients, "chain_update",
                                       _unchanged),
    "half": lambda mp: mp.setattr(gradients.GreenGaussTorch, "_sweep",
                                  _half_left_out(
                                      gradients.GreenGaussTorch._sweep)),
    "altered": lambda mp: mp.setattr(gradients.GreenGaussTorch, "_sweep",
                                     _altered(
                                         gradients.GreenGaussTorch._sweep)),
    "no_exchange": lambda mp: mp.setattr(gradients.GreenGaussTorch,
                                         "_unpack",
                                         lambda self, x, recv, phases=None:
                                         None),
}
CASES = [(w, f) for w in ONE_RANK for f in ("unchanged", "half", "altered")]
CASES.append(("gg96.p8.overlap", "no_exchange"))


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_under_the_timed_path_is_not_correct(workload, fault,
                                                     monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small(workload)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p = subprocess.run([sys.executable, "-m", "cfdbench.run", "--workload",
                        "gg96.p1.bulk", "--seed", "5", "--seconds", "2",
                        "--trace", "1"], cwd=root, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert torch.cuda.get_device_name(0) == out["device"]["kind"]
    assert 0 < out["metrics"]["sweep_roofline_pct"]["value"] <= 100
