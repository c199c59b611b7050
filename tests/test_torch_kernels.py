"""Kernel twins of the port against the JAX reference kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the reference's Pallas kernels in interpret mode, on the JAX
model's own plans carried across by `convert.plans_from_jax`:

- `pack_srcs_ref` equals the JAX `pack_srcs` table bit for bit (a gather);
- `sweep_blocks_ref`, without and with `init`, equals the JAX packed sweep
  within 1e-6 × max|ref|, the FMA-contraction bound the reference's own
  cross-schedule test uses;
- `sweep_blocks_overlap_ref` equals the JAX fused kernel (grad within the
  same bound, the pushed buffers bitwise), called under `shard_map` on a
  one-device mesh as the model calls it.

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


def _port_args(arrays, cls="bulk"):
    a = arrays["classes"][cls]
    return (_t(a["slot_w"]), _t(a["scale"]), _t(a["block_ids"]),
            _t(bs.slot_table(a["wks"])))


def _jax_table(jm, js, cls="bulk"):
    """The JAX packed table in the compact (P, nb, NV, L) layout (with
    kcompact off the reference keeps (P, nb, K, NV, bp) rectangles: every
    slot at full width)."""
    tbl = np.asarray(js[f"tbl_{cls}"])
    if tbl.ndim == 5:
        tbl = np.concatenate([tbl[:, :, k] for k in range(tbl.shape[2])], -1)
    return tbl


def _jax_plan(jm, cls, shard):
    import jax.numpy as jnp

    return {k: jnp.asarray(np.asarray(v)[shard])
            for k, v in jm._plans_dev[cls].items()}


@pytest.mark.parametrize("bp,kcompact", CASES)
def test_pack_srcs_ref_equals_jax_pack_bitwise(jax_cases, bp, kcompact):
    jm, js, arrays, var_T = jax_cases[(bp, kcompact)]
    ref = _jax_table(jm, js)
    cols = _t(arrays["classes"]["bulk"]["src_cols"])
    got = bs.pack_srcs_ref(_t(var_T), cols).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = bs.pack_srcs.launches
    np.testing.assert_array_equal(bs.pack_srcs(_t(var_T), cols).numpy(), ref)
    assert bs.pack_srcs.launches == before


@pytest.mark.parametrize("bp,kcompact", CASES)
def test_sweep_blocks_ref_matches_jax_sweep(jax_cases, bp, kcompact):
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep

    jm, js, arrays, var_T = jax_cases[(bp, kcompact)]
    ep, ks, nb = jm._dims["bulk"]
    pa = _jax_plan(jm, "bulk", 0)
    pa["srcs"] = jnp.asarray(np.asarray(js["tbl_bulk"])[0])
    ref = np.asarray(jax_sweep(jnp.asarray(var_T[0]), pa, bp=jm.bp, ep=ep,
                               kslots=ks, nblocks=nb, interpret=True,
                               packed=True, wks=jm._wks["bulk"]))[None]
    tbl = _t(_jax_table(jm, js))
    got = bs.sweep_blocks_ref(_t(var_T), tbl, *_port_args(arrays)).numpy()
    assert got.shape == ref.shape == (1, 3 * 8, jm.layout.ndev)
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
    var_T = rng.standard_normal((1, 8, ndev)).astype(np.float32)
    srcs = rng.standard_normal((1, 1, 8, L)).astype(np.float32)
    slot_w = rng.standard_normal((1, 1, 3, L)).astype(np.float32)
    scale = rng.random((1, 1, 1, bp)).astype(np.float32)
    got = bs.sweep_blocks_ref(_t(var_T), _t(srcs), _t(slot_w), _t(scale),
                              _t(np.array([[1]], np.int32)),
                              _t(bs.slot_table(wks))).numpy()[0]
    own = var_T[0, :, bp:2 * bp].astype(np.float64)
    acc = np.zeros((3, 8, bp))
    off = 0
    for w in wks:
        for lane in range(w):
            avg = 0.5 * (own[:, lane] + srcs[0, 0, :, off + lane])
            acc[:, :, lane] += np.outer(slot_w[0, 0, :, off + lane], avg)
        off += w
    want = acc.reshape(24, bp) * scale[0, 0]
    np.testing.assert_allclose(got[:, bp:2 * bp], want, rtol=1e-5, atol=1e-6)
    assert not got[:, :bp].any() and not got[:, 2 * bp:].any()


def _good_args():
    """Two shards, two blocks each, two exchange phases: phase 0 swaps the
    shards, phase 1 is a self-send."""
    rng = np.random.default_rng(1)
    P, bp, nb, L, s_max = 2, 128, 2, 384, 128

    def f32(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32))

    return {
        "var_T": f32(P, 8, nb * bp),
        "srcs": f32(P, nb, 8, L),
        "slot_w": f32(P, nb, 3, L),
        "scale": _t(rng.random((P, nb, 1, bp)).astype(np.float32)),
        "block_ids": _t(np.tile(np.arange(nb, dtype=np.int32), (P, 1))),
        "slots": _t(bs.slot_table((128, 128, 128))),
        "src_cols": _t(rng.integers(0, nb * bp, (P, nb, L)).astype(np.int32)),
        "init": f32(P, 24, nb * bp),
        "sendbufs": f32(P, 2, 24, s_max),
        "dsts": _t(np.array([[1, 0], [0, 1]], np.int32)),
        "src_devs": _t(np.array([[1, 0], [0, 1]], np.int32)),
    }


SWEEP_KEYS = ("var_T", "srcs", "slot_w", "scale", "block_ids", "slots")
OVERLAP_KEYS = (*SWEEP_KEYS, "init", "sendbufs", "dsts", "src_devs")


def _call(name, a):
    if name == "sweep":
        return bs.sweep_blocks(*[a[k] for k in SWEEP_KEYS])
    if name == "sweep_init":
        return bs.sweep_blocks(*[a[k] for k in SWEEP_KEYS], init=a["init"])
    if name == "overlap":
        return bs.sweep_blocks_overlap(*[a[k] for k in OVERLAP_KEYS])
    return bs.pack_srcs(a["var_T"], a["src_cols"])


@pytest.mark.parametrize("name,key,bad", [
    ("sweep", "var_T", lambda t: t.double()),
    ("sweep", "srcs", lambda t: t.transpose(2, 3).contiguous().transpose(2, 3)),
    ("sweep", "slot_w", lambda t: t[..., :256].contiguous()),
    ("sweep", "scale", lambda t: t.reshape(t.shape[0], t.shape[1], -1)),
    ("sweep", "block_ids", lambda t: t.long()),
    ("sweep", "slots", lambda t: t[:1].contiguous()),
    ("pack", "var_T", lambda t: t.transpose(1, 2)),
    ("pack", "var_T", lambda t: t[:, :5].contiguous()),
    ("pack", "src_cols", lambda t: t.long()),
    ("sweep_init", "init", lambda t: t.double()),
    ("sweep_init", "init", lambda t: t[:, :, :128].contiguous()),
    ("sweep_init", "init", lambda t: t[:1].contiguous()),
    ("overlap", "init", lambda t: t.half()),
    ("overlap", "init", lambda t: t[:, :12].contiguous()),
    ("overlap", "sendbufs", lambda t: t[:, :1].contiguous()),
    ("overlap", "sendbufs", lambda t: t[:, :, :12].contiguous()),
    ("overlap", "sendbufs", lambda t: t[..., :126].contiguous()),
    ("overlap", "dsts", lambda t: t.long()),
    ("overlap", "dsts", lambda t: t[:, :1].contiguous()),
    ("overlap", "dsts", lambda t: t + 1),
    ("overlap", "dsts", lambda t: t - 1),
    ("overlap", "dsts", lambda t: torch.zeros_like(t)),
    ("overlap", "src_devs", lambda t: t[:1].contiguous()),
    ("overlap", "src_devs", lambda t: t.flip(1).contiguous()),
])
def test_wrappers_reject_bad_inputs(name, key, bad):
    a = _good_args()
    a[key] = bad(a[key])
    with pytest.raises(CheckError):
        _call(name, a)


def test_wrappers_accept_good_inputs():
    a = _good_args()
    out = _call("sweep", a)
    assert out.shape == (2, 24, 256) and torch.isfinite(out).all()
    assert _call("pack", a).shape == (2, 2, 8, 384)
    init = a["init"].clone()
    got = _call("sweep_init", a)
    assert got is a["init"] and not torch.equal(got, init)
    a["init"] = init
    g, recv = _call("overlap", a)
    assert g is init and recv.shape == a["sendbufs"].shape


def test_sweep_ref_init_accumulates_in_place():
    """With init, listed columns are init + Σ slots, scaled, written back
    into init; unlisted columns keep init's values (the reference aliases
    init to the output)."""
    a = _good_args()
    a["block_ids"] = _t(np.array([[0, 0], [1, 1]], np.int32))  # pad repeats
    init = a["init"].clone()
    zero = _call("sweep", a)                     # Σ slots · scale, from 0
    got = bs.sweep_blocks_ref(*[a[k] for k in SWEEP_KEYS], init=a["init"])
    assert got is a["init"]
    scale = a["scale"].reshape(2, 2 * 128)[:, :128]      # entry 0's scale
    for p, blk in ((0, 0), (1, 1)):
        cols = slice(blk * 128, (blk + 1) * 128)
        want = zero[p, :, cols] + init[p, :, cols] * scale[p]
        np.testing.assert_allclose(got[p, :, cols], want, rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(got[0, :, 128:], init[0, :, 128:], rtol=0,
                               atol=0)
    torch.testing.assert_close(got[1, :, :128], init[1, :, :128], rtol=0,
                               atol=0)


def test_loopback_pushes_along_dsts():
    a = _good_args()
    recv = bs.loopback(a["sendbufs"], a["dsts"])
    send = a["sendbufs"]
    assert torch.equal(recv[1, 0], send[0, 0])
    assert torch.equal(recv[0, 0], send[1, 0])
    assert torch.equal(recv[:, 1], send[:, 1])
    g, r = _call("overlap", a)
    assert torch.equal(r, recv)


# --------------------------------------- init and overlap vs the reference

@pytest.fixture(scope="module")
def jax_p4(mesh, gvar):
    """A four-shard JAX model with all table classes, and its plan in the
    port's arrays."""
    from cfd_proxy_tpu.models import GreenGaussPallas
    from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax

    jm = GreenGaussPallas(partition_mesh(mesh, 4, ghost_layers=1), NVAR,
                          bp=128, interpret=True)
    js = jm.distribute_state(gvar)
    return jm, js, plans_from_jax(jm), state_from_jax(js)


@pytest.mark.parametrize("cls", ["boundary", "interior"])
def test_sweep_ref_init_matches_jax_sweep(jax_p4, cls):
    """The accumulate form on every shard of the class plans the early
    schedule runs, seeded with a random init, against the reference's
    sweep_blocks(init=...)."""
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep

    jm, js, arrays, var_T = jax_p4
    ep, ks, nb = jm._dims[cls]
    P, ndev = var_T.shape[0], var_T.shape[2]
    init = np.random.default_rng(7).standard_normal(
        (P, 24, ndev)).astype(np.float32)
    ref = []
    for d in range(P):
        pa = _jax_plan(jm, cls, d)
        pa["srcs"] = jnp.asarray(np.asarray(js[f"tbl_{cls}"])[d])
        ref.append(np.asarray(jax_sweep(
            jnp.asarray(var_T[d]), pa, bp=jm.bp, ep=ep, kslots=ks,
            nblocks=nb, init=jnp.asarray(init[d]), interpret=True,
            packed=True, wks=jm._wks[cls])))
    ref = np.stack(ref)
    got = bs.sweep_blocks(_t(var_T), _t(_jax_table(jm, js, cls)),
                          *_port_args(arrays, cls), init=_t(init)).numpy()
    scale = np.abs(ref).max()
    assert got.shape == ref.shape and scale > 0
    assert np.abs(got - ref).max() <= SWEEP_TOL * scale


def test_overlap_ref_matches_jax_kernel(mesh, gvar):
    """sweep_blocks_overlap_ref against the reference's fused kernel at one
    shard with two self-send phases of random payloads, called under
    shard_map on a one-device mesh as the model calls it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec
    from cfd_proxy_tpu.models import GreenGaussPallas
    from cfd_proxy_tpu.models.gradients_pallas import AXIS, _shard_map
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks_overlap
    from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax

    jm = GreenGaussPallas(partition_mesh(mesh, 1), NVAR, bp=128,
                          interpret=True, force_rdma=True)
    js = jm.distribute_state(gvar, schedules=["overlap"])
    ep, ks, nb = jm._dims["interior"]
    rng = np.random.default_rng(3)
    init = rng.standard_normal((1, 24, jm.layout.ndev)).astype(np.float32)
    send = rng.standard_normal((1, 2, 24, jm.layout.s_max)).astype(
        np.float32)
    dsts = np.zeros((1, 2), np.int32)
    keys = list(jm._plans_dev["interior"])

    def body(v, tbl, ini, sb, d, s, *plans):
        pa = {k: x[0] for k, x in zip(keys, plans)}
        pa["srcs"] = tbl[0]
        g, r = sweep_blocks_overlap(
            v[0], pa, bp=jm.bp, ep=ep, kslots=ks, nblocks=nb, init=ini[0],
            sendbufs=sb[0], dsts=d[0], srcs=s[0], interpret=True,
            packed=True, wks=jm._wks["interior"])
        return g[None], r[None]

    one = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    spec = PartitionSpec(AXIS)
    fn = jax.jit(_shard_map(body, one, in_specs=(spec,) * (6 + len(keys)),
                            out_specs=(spec, spec)))
    g_ref, r_ref = (np.asarray(x) for x in fn(
        js["var_T"], js["tbl_interior"], jnp.asarray(init),
        jnp.asarray(send), jnp.asarray(dsts), jnp.asarray(dsts),
        *jm._plans_dev["interior"].values()))
    arrays = plans_from_jax(jm)
    g, r = bs.sweep_blocks_overlap(
        _t(state_from_jax(js)), _t(_jax_table(jm, js, "interior")),
        *_port_args(arrays, "interior"), _t(init), _t(send), _t(dsts),
        _t(dsts))
    scale = np.abs(g_ref).max()
    assert scale > 0
    assert np.abs(g.numpy() - g_ref).max() <= SWEEP_TOL * scale
    np.testing.assert_array_equal(r.numpy(), r_ref)
    assert np.abs(r_ref).max() > 0


# ------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def cuda_model(mesh, gvar):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    model = GreenGaussTorch(parts, NVAR, bp=128, device="cuda")
    return model, model.distribute_state(gvar)


def _plan_args(model, cls):
    pl = model.plans[cls]
    return pl["slot_w"], pl["scale"], pl["block_ids"], pl["slots"]


@pytest.mark.cuda
def test_cuda_pack_srcs_kernel_equals_plain_bitwise(cuda_model):
    model, state = cuda_model
    for pl in model.plans.values():
        got = bs.pack_srcs(state["var_T"], pl["src_cols"])
        ref = bs.pack_srcs_ref(state["var_T"], pl["src_cols"])
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_sweep_kernel_matches_plain(cuda_model):
    model, state = cuda_model
    args = _plan_args(model, "bulk")
    tbl = state["tables"]["bulk"]
    before = bs.sweep_blocks.launches
    got = bs.sweep_blocks(state["var_T"], tbl, *args)
    ref = bs.sweep_blocks_ref(state["var_T"], tbl, *args)
    torch.cuda.synchronize()
    assert bs.sweep_blocks.launches == before + 1
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= SWEEP_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["boundary", "interior"])
def test_cuda_sweep_init_kernel_matches_plain(cuda_model, cls):
    """K1-init on the padded boundary list (pad entries repeat the trash
    block) and on the interior list, seeded with a random init."""
    model, state = cuda_model
    args = (state["var_T"], state["tables"][cls], *_plan_args(model, cls))
    init = torch.randn((len(model.parts), 24, model.ndev), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(5))
    before = bs.sweep_blocks.init_launches
    got = bs.sweep_blocks(*args, init=init.clone())
    ref = bs.sweep_blocks_ref(*args, init=init.clone())
    torch.cuda.synchronize()
    assert bs.sweep_blocks.init_launches == before + 1
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= SWEEP_TOL * scale


@pytest.mark.cuda
def test_cuda_overlap_kernel_matches_plain(cuda_model):
    """K3: the interior sweep within the sweep bound, the pushed buffers
    bitwise, at the model's own push map."""
    model, state = cuda_model
    args = (state["var_T"], state["tables"]["interior"],
            *_plan_args(model, "interior"))
    gen = torch.Generator("cuda").manual_seed(6)
    init = torch.randn((len(model.parts), 24, model.ndev), device="cuda",
                       generator=gen)
    send = torch.randn((len(model.parts), model.nphases, 24, model.s_max),
                       device="cuda", generator=gen)
    before = bs.sweep_blocks_overlap.launches
    g, r = bs.sweep_blocks_overlap(*args, init.clone(), send, model.dsts,
                                   model.srcs)
    g_ref, r_ref = bs.sweep_blocks_overlap_ref(*args, init.clone(), send,
                                               model.dsts, model.srcs)
    torch.cuda.synchronize()
    assert bs.sweep_blocks_overlap.launches == before + 1
    scale = float(g_ref.abs().max())
    assert float((g - g_ref).abs().max()) <= SWEEP_TOL * scale
    assert torch.equal(r, r_ref)
