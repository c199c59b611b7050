"""The fake exchange phases (`min_phases`, `fake_sends`, `fake_tail_frac`)
of the port's kernel model against the JAX model's.

`GreenGaussTorch` on CPU tensors against `GreenGaussPallas` in interpret
mode at P=4 on the 9×8×7 mesh, schedule by schedule, packed and gather
kernels: the padded phases carry real self-sent payloads, which land in
ghost regions no face reads, so the owned columns (gather_global) stay
within 1e-6 of the reference and 1e-5 of the golden, and the port's
layout (phases, s_max, the push map with its self-permutations) is the
reference's.  Also: a single shard with fake phases runs the fused
overlap kernel's plain version on self-sends; a tail fraction without fake
lanes is refused (it would do nothing).
"""

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.models import GreenGaussPallas
from cfd_proxy_tpu.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

NVAR = 5
BP = 128
PORT_TOL = 1e-6
GOLDEN_TOL = 1e-5
SCHEDULES = ("bulk", "early", "overlap")
FAKE = {"min_phases": 8, "fake_sends": 96}


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def gref(mesh, gvar):
    g = compute_gradients_gg(gvar.astype(np.float64), mesh.faces, mesh.normals)
    return scale_gradients(g, mesh.volume, mesh.npoint).reshape(mesh.npoint, -1)


@pytest.fixture(scope="module")
def runs(mesh, gvar):
    """(kernel, tail) → (JAX model, port model, {schedule: (JAX global,
    port global, port stacked)}), built on first use."""
    cache = {}

    def get(kernel, tail):
        if (kernel, tail) not in cache:
            parts = partition_mesh(mesh, 4, ghost_layers=1)
            opts = dict(FAKE, fake_tail_frac=tail)
            jm = GreenGaussPallas(parts, NVAR, bp=BP, interpret=True,
                                  kernel=kernel, **opts)
            tm = GreenGaussTorch(parts, NVAR, bp=BP, kernel=kernel,
                                 device="cpu", **opts)
            js, ts = jm.distribute_state(gvar), tm.distribute_state(gvar)
            outs = {}
            for s in SCHEDULES:
                g = tm.step(ts, s)
                outs[s] = (jm.gather_global(np.asarray(jm.step(js, s))),
                           tm.gather_global(g), g)
            cache[kernel, tail] = (jm, tm, outs)
        return cache[kernel, tail]

    return get


@pytest.mark.parametrize("kernel,tail", [("packed", 0.0), ("packed", 0.25),
                                         ("gather", 0.0)])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_owned_columns_match_reference_and_golden(runs, gref, kernel, tail,
                                                  schedule):
    _, _, outs = runs(kernel, tail)
    want, got, _ = outs[schedule]
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= PORT_TOL * scale
    assert np.abs(got - gref).max() / max(1.0, np.abs(gref).max()) \
        <= GOLDEN_TOL


@pytest.mark.parametrize("kernel,tail", [("packed", 0.0), ("packed", 0.25)])
def test_layout_is_the_reference_layout(runs, kernel, tail):
    """Eight phases, the padded ones self-permutations of real payloads,
    the same send lists, masks and push map as the reference."""
    jm, tm, _ = runs(kernel, tail)
    assert tm.nphases == FAKE["min_phases"] == jm.layout.nphases
    assert tm.s_max == jm.layout.s_max >= FAKE["fake_sends"]
    assert tm.fake_sends == FAKE["fake_sends"]
    np.testing.assert_array_equal(tm.dsts.numpy(), np.asarray(jm._dsts))
    np.testing.assert_array_equal(tm.srcs.numpy(), np.asarray(jm._srcs))
    np.testing.assert_array_equal(tm.pack_cols[:, :, 0].numpy(),
                                  np.asarray(jm._send_idx))
    real = len([p for p in jm.layout.perms if p and
                any(s != d for s, d in p)])
    for k in range(real, tm.nphases):
        assert tm.perms[k] == tuple((d, d) for d in range(4))
        assert tm.send_mask[:, k].sum() == 4 * FAKE["fake_sends"]


def test_owned_columns_agree_across_schedules(runs):
    """The fake ghost regions differ by schedule by design (bulk packs
    scaled gradients at the fake columns, early the boundary sums, which
    are zero there); the owned columns agree."""
    _, tm, outs = runs("packed", 0.0)
    own = tm.ghost_start
    bulk = outs["bulk"][2]
    for s in ("early", "overlap"):
        g = outs[s][2]
        scale = float(bulk.abs().max())
        assert (g[..., :own] - bulk[..., :own]).abs().max() <= 1e-6 * scale


def test_one_shard_fake_phases_run_the_fused_form(mesh, gvar, gref):
    """At one shard the fake phases are the only ones that move data: the
    overlap step runs the fused kernel's form on the self-sends, and the
    result is the plain one-shard result."""
    parts = partition_mesh(mesh, 1)
    plain = GreenGaussTorch(parts, NVAR, bp=BP, device="cpu")
    fake = GreenGaussTorch(parts, NVAR, bp=BP, device="cpu", min_phases=3,
                           fake_sends=256, fake_tail_frac=0.5)
    assert fake.has_comm and fake.moves and not plain.has_comm
    got = fake.gather_global(fake.step(fake.distribute_state(gvar),
                                       "overlap"))
    want = plain.gather_global(plain.step(plain.distribute_state(gvar),
                                          "overlap"))
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("opts,match", [
    ({"fake_tail_frac": 0.25}, "needs fake_sends"),
    ({"min_phases": 0}, "min_phases"),
    ({"fake_sends": -1}, "fake_sends"),
])
def test_model_refuses_bad_fake_options(mesh, opts, match):
    with pytest.raises(CheckError, match=match):
        GreenGaussTorch(partition_mesh(mesh, 1), NVAR, device="cpu", **opts)
