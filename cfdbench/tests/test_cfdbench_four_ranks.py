"""`correct` on the four-card cell, `gg152.w4.overlap`, resolved from
BENCHMARK.json by its name and run at 10³ on four CPU processes (gloo; the
peer transport runs as dist, which the CPU has): true for the program,
false with the fault the one-card cells' tests plant at eight shards, the
exchange left out.  The fault is planted inside each rank, since a spawned
rank imports the program anew."""

from __future__ import annotations

from cfdbench import cell, run
from cfdbench.tests.conftest import run_small, small_spec

CELL = "gg152.w4.overlap"
NX = 10


def _rank_without_exchange(spec: dict) -> dict:
    """One rank's run whose unpack writes nothing: every ghost column keeps
    what it held before the exchange."""
    from cfd_proxy_tpu_torch.models import gradients

    gradients.GreenGaussTorch._unpack = \
        lambda self, x, recv, phases=None: None
    return cell.run_rank(spec)


def test_the_cell_by_its_name_is_correct_on_four_ranks():
    out = run_small(CELL, nx=NX)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4


def test_the_exchange_left_out_on_four_ranks_is_not_correct():
    from cfd_proxy_tpu_torch.parallel import launch

    c, spec = small_spec(CELL, nx=NX)
    assert c["chips"] == 4 and spec["transport"] == "dist"
    ranks = launch.spawn(4, _rank_without_exchange, (spec,),
                         timeout_s=300)[0]["ranks"]
    out, _ = run.assemble(c, ranks, False, None)
    assert len(ranks) == 4
    assert not out["correct"], out["checks"]
    assert max(ch["value"] / ch["limit"] for ch in out["checks"].values()) \
        > 3
