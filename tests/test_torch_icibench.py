"""The push bench of the port (`tools/icibench.py`) and K6's plain version
on the CPU, against the reference's bench.

On the CPU `push_phases` runs its plain version through the `Loopback`
transport (one rank) or `Dist` over gloo (`--ranks 2`): every mode runs and
prints the reference's columns; what it pushes is held bitwise (a copy has
no tolerance) against the semantics of the reference's kernel run in
interpret mode (`cfd_proxy_tpu/tools/icibench.py`, whose interpret branch
is `recv = send`).  No suggestion line appears without `--link-gbps`: the
port assumes no link rate.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.tools import icibench as ref_icibench
from cfd_proxy_tpu_torch.ops import push
from cfd_proxy_tpu_torch.parallel import launch, workers
from cfd_proxy_tpu_torch.parallel.transport import Loopback
from cfd_proxy_tpu_torch.tools import icibench
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

COLUMNS = ["phases", "MB/phase", "ms/iter", "GB/s payload", "GB/s HBM r+w"]


def run_main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def header(lines):
    return next(ln for ln in lines if ln.lstrip().startswith("phases"))


@pytest.mark.parametrize("mode", push.MODES)
def test_main_runs_every_mode_on_the_cpu(mode):
    rc, lines = run_main(icibench.main, [
        "--device", "cpu", "--phases", "1", "2", "--mb", "0.125", "--iters",
        "5", "--mode", mode])
    assert rc == 0
    assert lines[0].startswith("# WARNING: no GPU")
    assert f"mode={mode}" in lines[1]
    bar = "on" if mode in ("full", "baronly") else "off"
    copy = "on" if mode in ("full", "nobar") else "off"
    assert f"barrier={bar}, copy={copy}" in lines[1]
    for c in COLUMNS:
        assert c in header(lines)
    rows = [ln.split() for ln in lines if ln.split()[0] in ("1", "2")]
    assert [r[0] for r in rows] == ["1", "2"]
    assert all(r[1] == "0.123" for r in rows)    # 24 rows x 1280 lanes x 4 B
    assert not any("suggested" in ln for ln in lines)


def test_columns_are_the_references():
    """The same header and row layout as the reference's bench (run in
    interpret mode at its smallest size)."""
    rc, ref_lines = run_main(ref_icibench.main, [
        "--phases", "1", "--mb", "0.01", "--iters", "2"])
    assert rc == 0
    rc, lines = run_main(icibench.main, [
        "--device", "cpu", "--phases", "1", "--mb", "0.01", "--iters", "2"])
    assert rc == 0
    assert header(lines) == header(ref_lines)


def test_suggestion_line_only_with_a_link_rate():
    argv = ["--device", "cpu", "--phases", "1", "--mb", "0.125", "--iters",
            "5"]
    rc, lines = run_main(icibench.main, [*argv, "--link-gbps", "1e-3"])
    assert rc == 0
    assert lines[-1].startswith("# peak payload rate")
    assert "min(measured, 0.001 GB/s link)" in lines[-1]
    rc, lines = run_main(icibench.main, argv)
    assert not any("peak payload rate" in ln for ln in lines)
    # the reference's 45 GB/s default is a TPU link's: not carried over
    assert "45" not in icibench.__doc__


def test_two_ranks_over_gloo():
    rc, lines = run_main(icibench.main, [
        "--device", "cpu", "--ranks", "2", "--phases", "2", "--mb", "0.125",
        "--iters", "5"])
    assert rc == 0
    assert "ranks=2" in lines[1]
    assert [ln.split()[0] for ln in lines[3:]] == ["2"]


def test_payload_rule_is_the_references():
    # max(128, round(mb·1e6 / (rows·4) / 128)·128), icibench.py:178
    assert icibench.payload_lanes(0.125, 24) == 1280
    assert icibench.payload_lanes(32.0, 24) == 333312
    assert icibench.payload_lanes(1e-6, 24) == 128


@pytest.mark.parametrize("mode", push.MODES)
@pytest.mark.parametrize("nph", [1, 3])
def test_push_plain_version_semantics(mode, nph):
    """full / nobar: every phase arrives (a self-send at one rank: recv =
    send, the reference's interpret branch); baronly / empty: phase 0 only,
    the other phases untouched."""
    send = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, nph, 24, 128)).astype(np.float32))
    t = Loopback(np.zeros((1, nph), np.int64), "cpu")
    before = {a: getattr(push.push_phases, a)
              for a in push.push_phases.count_attrs}
    got = push.push_phases(send, t, mode)
    if mode in ("full", "nobar"):
        assert torch.equal(got, send)
    else:
        assert torch.equal(got[:, 0], send[:, 0])
        assert not got[:, 1:].any()
    # the plain version launches nothing
    assert before == {a: getattr(push.push_phases, a) for a in before}
    assert sorted(push.launch_counters()) == sorted(
        "push_phases_" + m for m in push.MODES)


def test_push_ring_of_three_ranks():
    """`--ranks W`: rank r pushes to rank r+1; every mode, bitwise."""
    for r in launch.spawn(3, workers.push_ring, (2, 24, 128, "cpu"),
                          timeout_s=120):
        assert r["bitwise"], r


def test_ring_map():
    d, s = icibench.ring_map(3, 2)
    assert d.tolist() == [[1, 1], [2, 2], [0, 0]]
    assert s.tolist() == [[2, 2], [0, 0], [1, 1]]
    d, s = icibench.ring_map(1, 4)
    assert d.tolist() == s.tolist() == [[0, 0, 0, 0]]


@pytest.mark.parametrize("argv,match", [
    (["--device", "cuda"], "no CUDA device"),
    (["--device", "cpu", "--phases", "0"], "must be positive"),
])
def test_main_refuses_by_name(argv, match):
    if "cuda" in argv and torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    with pytest.raises(CheckError, match=match):
        icibench.main(argv)


def test_unknown_mode_is_refused():
    send = torch.zeros((1, 1, 24, 128))
    with pytest.raises(CheckError, match="unknown push mode"):
        push.push_phases(send, Loopback(np.zeros((1, 1)), "cpu"), "plain")
