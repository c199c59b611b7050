"""Kernel twins of the port against the JAX reference kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the reference's Pallas kernels in interpret mode, on the JAX
model's own bulk plan carried across by `convert.plans_from_jax`:

- `pack_srcs_ref` equals the JAX `pack_srcs` table bit for bit (a gather);
- `sweep_blocks_ref` equals the JAX packed sweep within 1e-6 × max|ref|,
  the FMA-contraction bound the reference's own cross-schedule test uses.

The `cuda`-marked tests compare each CUDA kernel with its plain version on
the card and skip without one.  They import no JAX, so they run on a GPU
machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.utils.errors import CheckError
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops import blocksweep as bs

torch.set_num_threads(1)

NVAR = 5
CASES = [(128, True), (128, False), (256, True), (256, False)]  # bp, kcompact
SWEEP_TOL = 1e-6


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def jax_cases(mesh, gvar):
    """Per (bp, kcompact): the JAX model, its bulk state, and its plan in
    the port's arrays."""
    from cfd_proxy_tpu.models import GreenGaussPallas
    from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax

    parts = partition_mesh(mesh, 1, ghost_layers=1)
    out = {}
    for bp, kc in CASES:
        jm = GreenGaussPallas(parts, NVAR, bp=bp, interpret=True,
                              kcompact=kc)
        js = jm.distribute_state(gvar, schedules=["bulk"])
        out[(bp, kc)] = (jm, js, plans_from_jax(jm), state_from_jax(js))
    return out


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))     # writable copy


def _port_args(arrays):
    return (_t(arrays["slot_w"]), _t(arrays["scale"]),
            _t(arrays["block_ids"]), _t(bs.slot_table(arrays["wks"])))


def _jax_table(jm, js):
    """The JAX packed table in the compact (nb, NV, L) layout (with kcompact
    off the reference keeps (nb, K, NV, bp) rectangles: every slot at full
    width)."""
    tbl = np.asarray(js["tbl_bulk"])[0]
    if tbl.ndim == 4:
        tbl = np.concatenate([tbl[:, k] for k in range(tbl.shape[1])], -1)
    return tbl


@pytest.mark.parametrize("bp,kcompact", CASES)
def test_pack_srcs_ref_equals_jax_pack_bitwise(jax_cases, bp, kcompact):
    jm, js, arrays, var_T = jax_cases[(bp, kcompact)]
    ref = _jax_table(jm, js)
    got = bs.pack_srcs_ref(_t(var_T), _t(arrays["src_cols"])).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = bs.pack_srcs.launches
    np.testing.assert_array_equal(
        bs.pack_srcs(_t(var_T), _t(arrays["src_cols"])).numpy(), ref)
    assert bs.pack_srcs.launches == before


@pytest.mark.parametrize("bp,kcompact", CASES)
def test_sweep_blocks_ref_matches_jax_sweep(jax_cases, bp, kcompact):
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep

    jm, js, arrays, var_T = jax_cases[(bp, kcompact)]
    ep, ks, nb = jm._dims["bulk"]
    pa = {k: jnp.asarray(np.asarray(v)[0])
          for k, v in jm._plans_dev["bulk"].items()}
    pa["srcs"] = jnp.asarray(np.asarray(js["tbl_bulk"])[0])
    ref = np.asarray(jax_sweep(jnp.asarray(var_T), pa, bp=jm.bp, ep=ep,
                               kslots=ks, nblocks=nb, interpret=True,
                               packed=True, wks=jm._wks["bulk"]))
    tbl = _t(_jax_table(jm, js))
    got = bs.sweep_blocks_ref(_t(var_T), tbl, *_port_args(arrays)).numpy()
    assert got.shape == ref.shape == (3 * 8, jm.layout.ndev)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= SWEEP_TOL * scale
    before = bs.sweep_blocks.launches
    np.testing.assert_array_equal(
        bs.sweep_blocks(_t(var_T), tbl, *_port_args(arrays)).numpy(), got)
    assert bs.sweep_blocks.launches == before


def test_slot_table_skips_zero_widths():
    """Offsets advance only over nonzero widths; widths need not be
    monotone."""
    tab = bs.slot_table((256, 128, 0, 256, 0, 128))
    np.testing.assert_array_equal(tab, [[256, 128, 0, 256, 0, 128],
                                        [0, 256, 384, 384, 640, 640]])
    assert tab.dtype == np.int32


def test_sweep_ref_nonmonotone_widths_and_unlisted_blocks():
    """A narrow slot before a wider one is summed over its own prefix only;
    a zero-width slot contributes nothing; columns of blocks the plan does
    not list stay zero."""
    rng = np.random.default_rng(0)
    bp, wks, ndev = 128, (128, 0, 64, 128), 3 * 128
    L = sum(wks)
    var_T = rng.standard_normal((8, ndev)).astype(np.float32)
    srcs = rng.standard_normal((1, 8, L)).astype(np.float32)
    slot_w = rng.standard_normal((1, 3, L)).astype(np.float32)
    scale = rng.random((1, 1, bp)).astype(np.float32)
    got = bs.sweep_blocks_ref(_t(var_T), _t(srcs), _t(slot_w), _t(scale),
                              _t(np.array([1], np.int32)),
                              _t(bs.slot_table(wks))).numpy()
    own = var_T[:, bp:2 * bp].astype(np.float64)
    acc = np.zeros((3, 8, bp))
    off = 0
    for w in wks:
        for lane in range(w):
            avg = 0.5 * (own[:, lane] + srcs[0, :, off + lane])
            acc[:, :, lane] += np.outer(slot_w[0, :, off + lane], avg)
        off += w
    want = acc.reshape(24, bp) * scale[0]
    np.testing.assert_allclose(got[:, bp:2 * bp], want, rtol=1e-5, atol=1e-6)
    assert not got[:, :bp].any() and not got[:, 2 * bp:].any()


def _good_args():
    rng = np.random.default_rng(1)
    bp, nb, L = 128, 2, 384
    return {
        "var_T": _t(rng.standard_normal((8, nb * bp)).astype(np.float32)),
        "srcs": _t(rng.standard_normal((nb, 8, L)).astype(np.float32)),
        "slot_w": _t(rng.standard_normal((nb, 3, L)).astype(np.float32)),
        "scale": _t(rng.random((nb, 1, bp)).astype(np.float32)),
        "block_ids": _t(np.arange(nb, dtype=np.int32)),
        "slots": _t(bs.slot_table((128, 128, 128))),
        "src_cols": _t(rng.integers(0, nb * bp, (nb, L)).astype(np.int32)),
    }


SWEEP_KEYS = ("var_T", "srcs", "slot_w", "scale", "block_ids", "slots")


@pytest.mark.parametrize("name,key,bad", [
    ("sweep", "var_T", lambda t: t.double()),
    ("sweep", "srcs", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
    ("sweep", "slot_w", lambda t: t[:, :, :256].contiguous()),
    ("sweep", "scale", lambda t: t.reshape(t.shape[0], -1)),
    ("sweep", "block_ids", lambda t: t.long()),
    ("sweep", "slots", lambda t: t[:1].contiguous()),
    ("pack", "var_T", lambda t: t.t()),
    ("pack", "var_T", lambda t: t[:5].contiguous()),
    ("pack", "src_cols", lambda t: t.long()),
])
def test_wrappers_reject_bad_inputs(name, key, bad):
    a = _good_args()
    a[key] = bad(a[key])
    with pytest.raises(CheckError):
        if name == "sweep":
            bs.sweep_blocks(*[a[k] for k in SWEEP_KEYS])
        else:
            bs.pack_srcs(a["var_T"], a["src_cols"])


def test_wrappers_accept_good_inputs():
    a = _good_args()
    out = bs.sweep_blocks(*[a[k] for k in SWEEP_KEYS])
    assert out.shape == (24, 256) and torch.isfinite(out).all()
    assert bs.pack_srcs(a["var_T"], a["src_cols"]).shape == (2, 8, 384)


# ------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def cuda_model(mesh, gvar):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    parts = partition_mesh(mesh, 1, ghost_layers=1)
    model = GreenGaussTorch(parts, NVAR, bp=128, device="cuda")
    return model, model.distribute_state(gvar)


@pytest.mark.cuda
def test_cuda_pack_srcs_kernel_equals_plain_bitwise(cuda_model):
    model, state = cuda_model
    got = bs.pack_srcs(state["var_T"], model.src_cols)
    ref = bs.pack_srcs_ref(state["var_T"], model.src_cols)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_sweep_kernel_matches_plain(cuda_model):
    model, state = cuda_model
    args = (model.slot_w, model.scale, model.block_ids, model.slots)
    before = bs.sweep_blocks.launches
    got = bs.sweep_blocks(state["var_T"], state["tbl_bulk"], *args)
    ref = bs.sweep_blocks_ref(state["var_T"], state["tbl_bulk"], *args)
    torch.cuda.synchronize()
    assert bs.sweep_blocks.launches == before + 1
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= SWEEP_TOL * scale
