"""The port's examples (examples/torch_*.py) on the CPU, with the asserts
tests/test_examples.py holds the originals to: the convergence driver
converges monotonically, the multi-shard example's phases put the
intra-node ones first and every schedule agrees with the golden and with
bulk, the pseudo-time-stepping loop runs five finite steps."""

import os
import sys

import numpy as np

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return __import__(name)
    finally:
        sys.path.remove(EXAMPLES)


def test_convergence_driver_converges():
    drive = _example("torch_convergence_driver").drive
    status, res = drive(nx=8, ny=8, nz=6, nparts=2, max_steps=60,
                        device="cpu", verbose=False)
    assert status == "converged", (status, res)
    assert res[-1] < 0.1 * res[0]
    # monotone decay up to explicit-scheme ripple
    assert all(b < 1.05 * a for a, b in zip(res, res[1:])), res


def test_multichip_overlap_example():
    main = _example("torch_multichip_overlap").main
    model, out = main(nx=10, ny=9, nz=8, nparts=4, slice_size=2,
                      device="cpu", verbose=False)
    # node-aware coloring: intra-node phases strictly before the others
    kinds = [k in model.dcn_phases for k in range(model.nphases)]
    assert kinds == sorted(kinds), kinds
    assert any(kinds) and not all(kinds)  # both kinds of phase present
    for k, v in out.items():
        assert v < 1e-6, (k, v)


def test_pseudo_time_stepping_runs(capsys):
    _example("torch_pseudo_time_stepping").main(device="cpu")
    out = capsys.readouterr().out
    assert "done" in out
    norms = [float(ln.split("=")[1]) for ln in out.splitlines()
             if "||q||" in ln]
    assert len(norms) == 5 and all(np.isfinite(norms))
