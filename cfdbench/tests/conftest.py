"""Fixtures of the benchmark's tests: small CPU runs of the cells through the
harness (the program's plain versions), and the card's presence, decided when
a test asks for it, never at import."""

from __future__ import annotations

import time

import pytest

SMALL_NX = 8


def files_cell(config: str, traffic: str) -> dict:
    """A cell from its configuration and traffic files alone, as
    `cell.find_cell` builds one from BENCHMARK.json: the four-card cell's
    files are here, its entry not yet (PERF.md, Open questions)."""
    import os

    from cfdbench import cell

    c = cell.find_cell("gg96.p1.bulk")
    c["config"] = cell.load_json(os.path.join(cell.HERE, "configs",
                                              config + ".json"))
    c["traffic"] = cell.load_json(os.path.join(cell.HERE, "traffic",
                                               traffic + ".json"))
    c["name"] = f"{config}.{traffic}"
    c["chips"] = c["traffic"]["ranks"]
    return c


def small_spec(workload, nx: int = SMALL_NX, seed: int = 2**31 + 11,
               **extra) -> tuple[dict, dict]:
    """(cell, spec) of `workload` (a cell's name, or a cell) at an nx³ mesh
    on the CPU: the harness's run without its look for a chip.  A peer
    transport runs as dist (the CPU has no peer form)."""
    from cfdbench import cell

    c = cell.find_cell(workload) if isinstance(workload, str) else workload
    cfg = dict(c["config"], mesh=dict(c["config"]["mesh"], nx=nx, ny=nx,
                                      nz=nx))
    spec = {"config": cfg, "traffic": c["traffic"], "seed": seed,
            "seconds": 0.2, "trace": False, "device": "cpu",
            "t0": time.time()}
    if c["traffic"]["transport"] == "peer":
        spec["transport"] = "dist"
    spec.update(extra)
    return c, spec


def run_small(workload, **kw) -> dict:
    """The result line's object of a small CPU run."""
    from cfdbench import run

    c, spec = small_spec(workload, **kw)
    out, _ = run.assemble(c, run.run_spec(spec, spec["t0"]), spec["trace"],
                          None)
    return out


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
