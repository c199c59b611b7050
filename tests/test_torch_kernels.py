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
  one-device mesh as the model calls it;
- the gather formulation's plain versions (`sweep_blocks_gather_ref`, with
  and without `init`, and `sweep_blocks_overlap_gather_ref`) against the
  JAX gather kernels in the same way, and bitwise against the packed plain
  versions on the same plan (the two formulations add the same terms in the
  same order).

The `cuda`-marked tests compare each CUDA kernel with its plain version on
the card, for both ops (the flux instances: K1-flux with and without init,
K2-flux with and without init, K3-flux in both bodies) and every
reduced-precision instance (bf16 weights, deltas and outputs: f32 outputs
within the sweep bound, bf16 outputs within one bf16 ulp; K4's delta pack
and the bf16 push bitwise); K1's zero-filled forms on NaN-filled outputs
(the zeros of the blocks a plan leaves out are the kernel's own: +0.0 bit
for bit, the whole output bit for bit K1-init on zeros) at one and eight
shards' boundary plans, every K1 instance's ptxas registers and spills,
and the chained update kernel bit for bit its plain version; and skip
without one.  The reduced-precision
CPU cases are in tests/test_torch_precision.py.  The flux op's CPU cases are in tests/test_torch_flux.py.  They import no JAX, so they run on a GPU
machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.utils.errors import CheckError
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


def _gather_args():
    """_good_args with gather tables: EP 128, W-indices over [0, bp + EP)
    (the last slot all pad: index 0, zero weight)."""
    a = _good_args()
    rng = np.random.default_rng(2)
    P, nb, bp, ep, K = 2, 2, 128, 128, 3
    sidx = rng.integers(0, bp + ep, (P, nb, K, bp)).astype(np.int32)
    sidx[:, :, -1] = 0
    sw = rng.standard_normal((P, nb, K, 3, bp)).astype(np.float32)
    sw[:, :, -1] = 0
    a.update(exts=_t(rng.standard_normal((P, nb, 8, ep)).astype(np.float32)),
             slot_idx=_t(sidx), slot_w=_t(sw))
    return a


GATHER_KEYS = ("var_T", "exts", "slot_idx", "slot_w", "scale", "block_ids",
               "slots")
GATHER_OVERLAP_KEYS = (*GATHER_KEYS, "init", "sendbufs", "dsts", "src_devs")


def _call(name, a):
    if name == "gather":
        return bs.sweep_blocks_gather(*[a[k] for k in GATHER_KEYS])
    if name == "gather_init":
        return bs.sweep_blocks_gather(*[a[k] for k in GATHER_KEYS],
                                      init=a["init"])
    if name == "overlap_gather":
        return bs.sweep_blocks_overlap_gather(
            *[a[k] for k in GATHER_OVERLAP_KEYS])
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


@pytest.mark.parametrize("name,key,bad", [
    ("gather", "exts", lambda t: t.double()),
    ("gather", "exts", lambda t: t[:, :, :5].contiguous()),
    ("gather", "exts", lambda t: t[:, :1].contiguous()),
    ("gather", "slot_idx", lambda t: t.long()),
    ("gather", "slot_idx", lambda t: t[:, :, :2].contiguous()),
    ("gather", "slot_idx", lambda t: t[..., :64].contiguous()),
    ("gather", "slot_w", lambda t: t.reshape(2, 2, 9, 128)),
    ("gather", "slot_w", lambda t: t[:, :, :, :2].contiguous()),
    ("gather", "slot_w", lambda t: t.transpose(3, 4).contiguous()
     .transpose(3, 4)),
    ("gather", "scale", lambda t: t[..., :64].contiguous()),
    ("gather_init", "init", lambda t: t[:, :8].contiguous()),
    ("overlap_gather", "sendbufs", lambda t: t[:, :, :8].contiguous()),
    ("overlap_gather", "dsts", lambda t: torch.zeros_like(t)),
])
def test_gather_wrappers_reject_bad_inputs(name, key, bad):
    a = _gather_args()
    a[key] = bad(a[key])
    with pytest.raises(CheckError):
        _call(name, a)


def test_gather_ref_equals_packed_ref_on_the_same_plan():
    """A gather plan and the packed tables it implies (sources resolved by
    the W-index, every slot at full width) give the same sums bitwise, with
    and without init, and through the fused form."""
    a = _gather_args()
    P, nb, K, bp = a["slot_idx"].shape
    own = torch.stack([a["var_T"][p][:, a["block_ids"][p].long()[:, None]
                                     * bp + torch.arange(bp)]
                       for p in range(P)]).permute(0, 2, 1, 3)
    tbl = torch.cat([own, a["exts"]], 3)                # (P, nb, NV, bp+EP)
    idx = a["slot_idx"].long()[:, :, :, None, :].expand(P, nb, K, 8, bp)
    srcs = torch.gather(tbl[:, :, None].expand(P, nb, K, 8, tbl.shape[3]), 4,
                        idx)
    packed = dict(a, srcs=torch.cat(srcs.unbind(2), -1).contiguous(),
                  slot_w=torch.cat(a["slot_w"].unbind(2), -1).contiguous())
    assert torch.equal(_call("gather", a), _call("sweep", packed))
    got = _call("gather_init", dict(a, init=a["init"].clone()))
    assert torch.equal(got, _call("sweep_init",
                                  dict(packed, init=a["init"].clone())))
    g, r = _call("overlap_gather", dict(a, init=a["init"].clone()))
    g2, r2 = _call("overlap", dict(packed, init=a["init"].clone()))
    assert torch.equal(g, g2) and torch.equal(r, r2)


def test_gather_wrappers_accept_good_inputs():
    a = _gather_args()
    out = _call("gather", a)
    assert out.shape == (2, 24, 256) and torch.isfinite(out).all()
    before = (bs.sweep_blocks_gather.launches,
              bs.sweep_blocks_gather.init_launches,
              bs.sweep_blocks_overlap_gather.launches)
    init = a["init"].clone()
    got = _call("gather_init", a)
    assert got is a["init"] and not torch.equal(got, init)
    a["init"] = init
    g, recv = _call("overlap_gather", a)
    assert g is init and torch.equal(recv, bs.loopback(a["sendbufs"],
                                                      a["dsts"]))
    # on CPU tensors the wrappers run the plain versions and launch nothing
    assert before == (bs.sweep_blocks_gather.launches,
                      bs.sweep_blocks_gather.init_launches,
                      bs.sweep_blocks_overlap_gather.launches)


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


@pytest.fixture(scope="module")
def jax_gather_p4(mesh, gvar):
    """A four-shard JAX gather model with all table classes, its plan in
    the port's arrays and its state."""
    from cfd_proxy_tpu.models import GreenGaussPallas
    from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax

    jm = GreenGaussPallas(partition_mesh(mesh, 4, ghost_layers=1), NVAR,
                          bp=128, interpret=True, kernel="gather")
    js = jm.distribute_state(gvar)
    return jm, js, plans_from_jax(jm), state_from_jax(js)


def _gather_port_args(arrays, cls):
    a = arrays["classes"][cls]
    return (_t(a["slot_idx"]), _t(a["slot_w"]), _t(a["scale"]),
            _t(a["block_ids"]), _t(bs.slot_table(a["wks"])))


@pytest.mark.parametrize("cls,with_init", [("bulk", False),
                                           ("boundary", True),
                                           ("interior", True)])
def test_gather_sweep_ref_matches_jax_sweep(jax_gather_p4, cls, with_init):
    """The gather sweep's plain version on every shard, without init (the
    bulk plan) and with a random init (the early schedule's plans), against
    the reference's sweep_blocks(packed=False); the port's own ext tables
    equal the reference's bitwise."""
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep

    jm, js, arrays, var_T = jax_gather_p4
    ep, ks, nb = jm._dims[cls]
    P, ndev = var_T.shape[0], var_T.shape[2]
    init = (np.random.default_rng(8).standard_normal((P, 24, ndev))
            .astype(np.float32) if with_init else None)
    exts = bs.gather_exts(_t(var_T), _t(arrays["classes"][cls]["ext_idx"]))
    np.testing.assert_array_equal(exts.numpy(),
                                  np.asarray(js[f"tbl_{cls}"]))
    ref = []
    for d in range(P):
        pa = _jax_plan(jm, cls, d)
        pa["exts"] = jnp.asarray(np.asarray(js[f"tbl_{cls}"])[d])
        ref.append(np.asarray(jax_sweep(
            jnp.asarray(var_T[d]), pa, bp=jm.bp, ep=ep, kslots=ks,
            nblocks=nb, interpret=True, packed=False, wks=jm._wks[cls],
            init=None if init is None else jnp.asarray(init[d]))))
    ref = np.stack(ref)
    got = bs.sweep_blocks_gather(
        _t(var_T), exts, *_gather_port_args(arrays, cls),
        init=None if init is None else _t(init)).numpy()
    scale = np.abs(ref).max()
    assert got.shape == ref.shape and scale > 0
    assert np.abs(got - ref).max() <= SWEEP_TOL * scale


def test_overlap_gather_ref_matches_jax_kernel(mesh, gvar):
    """sweep_blocks_overlap_gather_ref against the reference's fused kernel
    in its gather form, at one shard with two self-send phases of random
    payloads, under shard_map on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec
    from cfd_proxy_tpu.models import GreenGaussPallas
    from cfd_proxy_tpu.models.gradients_pallas import AXIS, _shard_map
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks_overlap
    from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax

    jm = GreenGaussPallas(partition_mesh(mesh, 1), NVAR, bp=128,
                          interpret=True, force_rdma=True, kernel="gather")
    js = jm.distribute_state(gvar, schedules=["overlap"])
    ep, ks, nb = jm._dims["interior"]
    rng = np.random.default_rng(4)
    init = rng.standard_normal((1, 24, jm.layout.ndev)).astype(np.float32)
    send = rng.standard_normal((1, 2, 24, jm.layout.s_max)).astype(
        np.float32)
    dsts = np.zeros((1, 2), np.int32)
    keys = list(jm._plans_dev["interior"])

    def body(v, tbl, ini, sb, d, s, *plans):
        pa = {k: x[0] for k, x in zip(keys, plans)}
        pa["exts"] = tbl[0]
        g, r = sweep_blocks_overlap(
            v[0], pa, bp=jm.bp, ep=ep, kslots=ks, nblocks=nb, init=ini[0],
            sendbufs=sb[0], dsts=d[0], srcs=s[0], interpret=True,
            packed=False, wks=jm._wks["interior"])
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
    g, r = bs.sweep_blocks_overlap_gather(
        _t(state_from_jax(js)), _t(np.asarray(js["tbl_interior"])),
        *_gather_port_args(arrays, "interior"), _t(init), _t(send),
        _t(dsts), _t(dsts))
    scale = np.abs(g_ref).max()
    assert scale > 0
    assert np.abs(g.numpy() - g_ref).max() <= SWEEP_TOL * scale
    np.testing.assert_array_equal(r.numpy(), r_ref)


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
    for c, pl in model.plans.items():
        got = bs.pack_srcs(state["var_T"], pl["src_cols"], bp=model.bp,
                           **model.pack_operands(c))
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


@pytest.fixture(scope="module")
def cuda_gather_model(mesh, gvar):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    model = GreenGaussTorch(parts, NVAR, bp=128, kernel="gather",
                            device="cuda")
    return model, model.distribute_state(gvar)


@pytest.mark.cuda
@pytest.mark.parametrize("cls,with_init", [("bulk", False),
                                           ("boundary", True),
                                           ("interior", True)])
def test_cuda_gather_kernel_matches_plain(cuda_gather_model, cls, with_init):
    """K2 on the bulk plan and K2-init on the padded boundary list and the
    interior list (seeded with a random init), against the plain version."""
    model, state = cuda_gather_model
    args = (state["var_T"], *model._operands(cls, state["tables"]))
    init = (torch.randn((len(model.parts), 24, model.ndev), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
            if with_init else None)
    counter = "init_launches" if with_init else "launches"
    before = getattr(bs.sweep_blocks_gather, counter)
    got = bs.sweep_blocks_gather(
        *args, init=None if init is None else init.clone())
    ref = bs.sweep_blocks_gather_ref(
        *args, init=None if init is None else init.clone())
    torch.cuda.synchronize()
    assert getattr(bs.sweep_blocks_gather, counter) == before + 1
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= SWEEP_TOL * scale


@pytest.mark.cuda
def test_cuda_overlap_gather_kernel_matches_plain(cuda_gather_model):
    """K3's gather form: the interior sweep within the sweep bound, the
    pushed buffers bitwise, at the model's own push map."""
    model, state = cuda_gather_model
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    gen = torch.Generator("cuda").manual_seed(8)
    init = torch.randn((len(model.parts), 24, model.ndev), device="cuda",
                       generator=gen)
    send = torch.randn((len(model.parts), model.nphases, 24, model.s_max),
                       device="cuda", generator=gen)
    before = bs.sweep_blocks_overlap_gather.launches
    g, r = bs.sweep_blocks_overlap_gather(*args, init.clone(), send,
                                          model.dsts, model.srcs)
    g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
        *args, init.clone(), send, model.dsts, model.srcs)
    torch.cuda.synchronize()
    assert bs.sweep_blocks_overlap_gather.launches == before + 1
    scale = float(g_ref.abs().max())
    assert float((g - g_ref).abs().max()) <= SWEEP_TOL * scale
    assert torch.equal(r, r_ref)


@pytest.fixture(scope="module")
def cuda_flux_models(mesh, gvar):
    """Four-shard flux models on the card, packed and gather, with every
    table class."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    out = {}
    for kernel in ("packed", "gather"):
        model = GreenGaussTorch(parts, NVAR, bp=128, kernel=kernel, op="flux",
                                device="cuda")
        out[kernel] = model, model.distribute_state(gvar)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,cls,with_init", [
    ("packed", "bulk", False), ("packed", "boundary", True),
    ("gather", "bulk", False), ("gather", "interior", True)])
def test_cuda_flux_sweep_kernels_match_plain(cuda_flux_models, kernel, cls,
                                             with_init):
    """K1-flux, K1-flux-init (on the padded boundary list), K2-flux and
    K2-flux-init against their plain versions, each counted once."""
    model, state = cuda_flux_models[kernel]
    args = (state["var_T"], *model._operands(cls, state["tables"]))
    init = (torch.randn((len(model.parts), 8, model.ndev), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
            if with_init else None)
    sweep, ref = ((bs.sweep_blocks_gather, bs.sweep_blocks_gather_ref)
                  if kernel == "gather" else
                  (bs.sweep_blocks, bs.sweep_blocks_ref))
    counter = "flux_init_launches" if with_init else "flux_launches"
    before = getattr(sweep, counter)
    got = sweep(*args, init=None if init is None else init.clone(),
                op="flux")
    want = ref(*args, init=None if init is None else init.clone(), op="flux")
    torch.cuda.synchronize()
    assert getattr(sweep, counter) == before + 1
    assert got.shape == (len(model.parts), 8, model.ndev)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= SWEEP_TOL * scale


def _body_tag(model, cls, op, fused=False):
    """The count tag of the body `gather_body` picks for a gather model's
    class: "direct_" for the direct body, "cluster_" for the cluster body,
    "" for the staged one."""
    ep = model.plans[cls]["ext_idx"].shape[2]
    return bs._BODY_TAGS[bs.gather_body(model.bp, ep, op, fused)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_cuda_flux_overlap_kernels_match_plain(cuda_flux_models, kernel):
    """K3-flux and K3-gather-flux: the interior sweep within the sweep
    bound, the pushed NV-row buffers bitwise, at the model's push map."""
    model, state = cuda_flux_models[kernel]
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    gen = torch.Generator("cuda").manual_seed(10)
    P = len(model.parts)
    init = torch.randn((P, 8, model.ndev), device="cuda", generator=gen)
    send = torch.randn((P, model.nphases, 8, model.s_max), device="cuda",
                       generator=gen)
    fused, ref = ((bs.sweep_blocks_overlap_gather,
                   bs.sweep_blocks_overlap_gather_ref) if kernel == "gather"
                  else (bs.sweep_blocks_overlap, bs.sweep_blocks_overlap_ref))
    attr = "flux_" + (_body_tag(model, "interior", "flux", fused=True)
                      if kernel == "gather" else "") + "launches"
    before = getattr(fused, attr)
    g, r = fused(*args, init.clone(), send, model.dsts, model.srcs,
                 op="flux")
    g_ref, r_ref = ref(*args, init.clone(), send, model.dsts, model.srcs,
                       op="flux")
    torch.cuda.synchronize()
    assert getattr(fused, attr) == before + 1
    scale = float(g_ref.abs().max())
    assert float((g - g_ref).abs().max()) <= SWEEP_TOL * scale
    assert torch.equal(r, r_ref)


# ------------------------------- reduced precision, on the card

PRECISIONS = [(w, d, o) for w in (0, 1) for d in (0, 1) for o in (0, 1)
              if (w, d, o) != (0, 0, 0)]      # bf16 weights, deltas, out


def _assert_close(got, want, bf16_out):
    """f32 outputs within SWEEP_TOL of max|want|; bf16 outputs elementwise
    within one bf16 ulp of want (FMA contraction can move the f32 sum across
    a rounding boundary) plus SWEEP_TOL of max|want|."""
    scale = float(want.float().abs().max())
    assert scale > 0
    err = (got.float() - want.float()).abs()
    if not bf16_out:
        assert float(err.max()) <= SWEEP_TOL * scale
        return
    assert got.dtype == want.dtype == torch.bfloat16
    assert bool((err <= bs.bf16_ulp(want) + SWEEP_TOL * scale).all())


@pytest.mark.cuda
def test_cuda_pack_deltas_kernel_equals_plain_bitwise(cuda_model):
    """K4's bf16d form: deltas against each entry's own column, every
    class (pad lanes and pad entries included), bitwise."""
    model, state = cuda_model
    for c, pl in model.plans.items():
        kw = dict(src_format="bf16d", block_ids=pl["block_ids"],
                  slots=pl["slots"], bp=model.bp)
        before = bs.pack_srcs.d16_launches
        got = bs.pack_srcs(state["var_T"], pl["src_cols"], widx=pl["widx"],
                           ext_idx=pl["ext_idx"], **kw)
        ref = bs.pack_srcs_ref(state["var_T"], pl["src_cols"], **kw)
        torch.cuda.synchronize()
        assert bs.pack_srcs.d16_launches == before + 1
        assert got.dtype == torch.bfloat16 and torch.equal(got, ref)


def _packed_operands(model, state, cls, w16, d16):
    """A class's packed sweep operands with bf16 weights and/or the bf16
    delta table."""
    pl = model.plans[cls]
    tbl = (bs.pack_srcs(state["var_T"], pl["src_cols"], src_format="bf16d",
                        bp=model.bp, **model.pack_operands(cls))
           if d16 else state["tables"][cls])
    w = pl["slot_w"].to(torch.bfloat16) if w16 else pl["slot_w"]
    return state["var_T"], tbl, w, pl["scale"], pl["block_ids"], pl["slots"]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("form", ["sweep", "init", "overlap"])
@pytest.mark.parametrize("w16,d16,o16", PRECISIONS)
def test_cuda_reduced_precision_packed_kernels(cuda_model, op, form, w16,
                                               d16, o16):
    """Every reduced-precision instance of K1, K1-init and K3 (bf16 push)
    against its plain version, each counted once under its own name."""
    model, state = cuda_model
    cls = "bulk" if form == "sweep" else "interior"
    args = _packed_operands(model, state, cls, w16, d16)
    odt = torch.bfloat16 if o16 else torch.float32
    P, rows = len(model.parts), bs.out_rows(op)
    gen = torch.Generator("cuda").manual_seed(11)
    init = torch.randn((P, rows, model.ndev), device="cuda",
                       generator=gen).to(odt)
    fn = bs.sweep_blocks_overlap if form == "overlap" else bs.sweep_blocks
    attr = (("flux_" if op == "flux" else "")
            + ("init_" if form == "init" else "")
            + bs._tag(w16, d16, o16) + "launches")
    before = getattr(fn, attr)
    if form == "overlap":
        send = torch.randn((P, model.nphases, rows, model.s_max),
                           device="cuda", generator=gen).to(torch.bfloat16)
        (got, r), (want, r_ref) = (
            f(*args, init.clone(), send, model.dsts, model.srcs, op=op)
            for f in (bs.sweep_blocks_overlap, bs.sweep_blocks_overlap_ref))
    else:
        kw = ({"init": init.clone()} if form == "init"
              else {"out_dtype": odt})
        got = bs.sweep_blocks(*args, op=op, **kw)
        kw = ({"init": init.clone()} if form == "init"
              else {"out_dtype": odt})
        want = bs.sweep_blocks_ref(*args, op=op, **kw)
        r = r_ref = None
    torch.cuda.synchronize()
    assert getattr(fn, attr) == before + 1
    assert got.dtype == odt and got.shape == (P, rows, model.ndev)
    _assert_close(got, want, o16)
    if r is not None:
        assert r.dtype == torch.bfloat16 and torch.equal(r, r_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("form", ["sweep", "init", "overlap"])
@pytest.mark.parametrize("w16,o16", [(1, 0), (0, 1), (1, 1)])
def test_cuda_reduced_precision_gather_kernels(cuda_gather_model, op, form,
                                               w16, o16):
    """Every reduced-precision instance of K2, K2-init and K3-gather (bf16
    push) against its plain version, each counted once."""
    model, state = cuda_gather_model
    cls = "bulk" if form == "sweep" else "interior"
    tbl, sidx, w, *plan = model._operands(cls, state["tables"])
    w = w.to(torch.bfloat16) if w16 else w
    args = (state["var_T"], tbl, sidx, w, *plan)
    odt = torch.bfloat16 if o16 else torch.float32
    P, rows = len(model.parts), bs.out_rows(op)
    gen = torch.Generator("cuda").manual_seed(12)
    init = torch.randn((P, rows, model.ndev), device="cuda",
                       generator=gen).to(odt)
    fn = (bs.sweep_blocks_overlap_gather if form == "overlap"
          else bs.sweep_blocks_gather)
    attr = (("flux_" if op == "flux" else "")
            + ("init_" if form == "init" else "")
            + bs._tag(w16, False, o16)
            + _body_tag(model, cls, op, fused=form == "overlap") + "launches")
    before = getattr(fn, attr)
    r = r_ref = None
    if form == "overlap":
        send = torch.randn((P, model.nphases, rows, model.s_max),
                           device="cuda", generator=gen).to(torch.bfloat16)
        (got, r), (want, r_ref) = (
            f(*args, init.clone(), send, model.dsts, model.srcs, op=op)
            for f in (bs.sweep_blocks_overlap_gather,
                      bs.sweep_blocks_overlap_gather_ref))
    elif form == "init":
        got = bs.sweep_blocks_gather(*args, init=init.clone(), op=op)
        want = bs.sweep_blocks_gather_ref(*args, init=init.clone(), op=op)
    else:
        got = bs.sweep_blocks_gather(*args, op=op, out_dtype=odt)
        want = bs.sweep_blocks_gather_ref(*args, op=op, out_dtype=odt)
    torch.cuda.synchronize()
    assert getattr(fn, attr) == before + 1
    assert got.dtype == odt
    _assert_close(got, want, o16)
    if r is not None:
        assert torch.equal(r, r_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_cuda_bf16_push_on_f32_instances(cuda_model, cuda_gather_model,
                                         kernel):
    """halo_dtype alone: the f32 K3 instances push bf16 buffers, bitwise,
    and count as the f32 instance."""
    model, state = cuda_gather_model if kernel == "gather" else cuda_model
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    gen = torch.Generator("cuda").manual_seed(13)
    P = len(model.parts)
    init = torch.randn((P, 24, model.ndev), device="cuda", generator=gen)
    send = torch.randn((P, model.nphases, 24, model.s_max), device="cuda",
                       generator=gen).to(torch.bfloat16)
    fused, ref = ((bs.sweep_blocks_overlap_gather,
                   bs.sweep_blocks_overlap_gather_ref) if kernel == "gather"
                  else (bs.sweep_blocks_overlap, bs.sweep_blocks_overlap_ref))
    before = fused.launches
    g, r = fused(*args, init.clone(), send, model.dsts, model.srcs)
    g_ref, r_ref = ref(*args, init.clone(), send, model.dsts, model.srcs)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    _assert_close(g, g_ref, False)
    assert r.dtype == torch.bfloat16 and torch.equal(r, r_ref)


# ------------------------------------------------ kbench's twins, on the card

TWINS = [("stream", "launches"), ("wsum", "launches"), ("nv7", "launches"),
         ("cstream_c", "launches"), ("cstream_bso", "w16_d16_o16_launches"),
         ("bso_fold", "launches"), ("bso_wsum", "hoist_launches"),
         ("bso_acc3", "launches"), ("compact_i8", "launches"),
         ("cflux_fact", "launches"), ("cstream_flux", "launches"),
         ("var16", "v16_w16_d16_o16_launches")]


@pytest.fixture(scope="module")
def cuda_benches(mesh):
    """kbench's plans and tables on the card at bp 128 (every prefix width
    is bp) and bp 256 (every width partial)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.tools import kbench

    return {bp: kbench.make_benches(mesh, bp=bp, device="cuda")
            for bp in (128, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [128, 256])
@pytest.mark.parametrize("name,attr", TWINS)
def test_cuda_kbench_twins_match_plain(cuda_benches, bp, name, attr):
    """Each twin instance (K5a/K5e f32 and bf16, K5b, K5c, the rungs K5d,
    K5f in both forms, K5g, K5h, K5i) and K1 on the bf16 state (var16, held
    to `sweep_blocks_ref`) against its plain version on the same tables,
    counted once: f32 outputs within the sweep bound (the stream bodies have
    nothing to contract, so bitwise), bf16 outputs within one bf16 ulp."""
    from cfd_proxy_tpu_torch.ops import twins
    from cfd_proxy_tpu_torch.tools import kbench

    fn, v, t = kbench.variant_table(cuda_benches[bp], [name])[name]
    kind = kbench.VARIANTS[name][4]
    wrapper = {"stream": twins.stream_twin, "wsum": twins.wsum_twin,
               "nv7": twins.nv7_sweep, "fold": twins.bso_twin,
               "fold_wsum": twins.bso_twin, "acc3": twins.bso_acc3_twin,
               "i8": twins.i8_sweep, "flux_fact": twins.flux_fact_twin,
               "stream_flux": twins.stream_flux_twin,
               "var16": bs.sweep_blocks}[kind]
    before = getattr(wrapper, attr)
    got = fn(v, t)
    torch.cuda.synchronize()
    assert getattr(wrapper, attr) == before + 1
    want = fn(v.cpu(), {k: x.cpu() for k, x in t.items()})    # plain version
    rows = {"nv7": 21, "flux_fact": 8, "stream_flux": 8}.get(kind, 24)
    assert got.shape == want.shape == (1, rows, v.shape[2])
    assert got.dtype == want.dtype == kbench.VARIANTS[name][3]
    _assert_close(got.cpu(), want, got.dtype == torch.bfloat16)
    if name in ("stream", "cstream_c", "cstream_flux"):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [128, 256])
def test_cuda_i8_mid_group_widths_match_plain(cuda_benches, bp):
    """K5d (I8_LANES point columns per thread) within one bf16 ulp of its
    plain version on tables with entries whose live width ends inside a
    lane group of the padded prefix (their pad lanes carry zero weights),
    one launch."""
    from cfd_proxy_tpu_torch.ops import twins
    from cfd_proxy_tpu_torch.tools import kbench

    fn, v, t = kbench.variant_table(cuda_benches[bp],
                                    ["compact_i8"])["compact_i8"]
    w = t["slot_w"][0].cpu()
    widths, offs = t["slots"].tolist()
    mid = [(b, k) for k, (wk, off) in enumerate(zip(widths, offs))
           for b in range(w.shape[0])
           if (nz := (w[b, :, off:off + wk] != 0).any(dim=0)).any()
           and (int(nz.nonzero().max()) + 1) % twins.I8_LANES]
    assert mid, "no live width ends inside a lane group"
    want = fn(v.cpu(), {k: x.cpu() for k, x in t.items()})    # plain version
    before = twins.i8_sweep.launches
    got = fn(v, t)
    torch.cuda.synchronize()
    assert twins.i8_sweep.launches == before + 1
    _assert_close(got.cpu(), want, True)


I8_BAD_WIDTH = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from cfd_proxy_tpu_torch.ops import twins
d = dict(device="cuda")
out = twins.i8_sweep(
    torch.zeros((1, 8, 128), **d), torch.zeros((1, 1, 8, 256),
    dtype=torch.int8, **d), torch.zeros((1, 1, 3, 256), dtype=torch.bfloat16,
    **d), torch.ones((1, 1, 1, 128), **d), torch.zeros((1, 1),
    dtype=torch.int32, **d), torch.tensor([[126, 130], [0, 126]],
    dtype=torch.int32, **d), i8_scale=torch.ones((1, 1, 8, 128), **d))
torch.cuda.synchronize()
print("no trap")
"""


@pytest.mark.cuda
def test_cuda_i8_bad_slot_width_traps():
    """A slot width that is not a multiple of I8_LANES (so an offset that
    is not either) stops K5d's kernel: the card reports the launch as
    failed, and the process that made it cannot go on.  Hence a child
    process, on the library the parent built."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.ops import _cuda

    _cuda.build()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", I8_BAD_WIDTH, root],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode != 0 and "no trap" not in r.stdout, r.stdout
    assert "CUDA" in r.stderr or "cuda" in r.stderr, r.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [128, 256])
@pytest.mark.parametrize("name", ["bso_acc3", "bso_fold"])
def test_cuda_rungs_equal_compact_bso_bitwise(cuda_benches, bp, name):
    """On the card too: three accumulator sets (K5g) and the pre-halved
    weights (K5f, fold form) give K1-w16-d16-o16's output bit for bit (the
    same products, contracted into the same multiply-adds)."""
    from cfd_proxy_tpu_torch.tools import kbench

    table = kbench.variant_table(cuda_benches[bp], [name, "compact_bso"])
    (fn, v, t), (ref_fn, ref_v, ref_t) = table[name], table["compact_bso"]
    before = bs.sweep_blocks.w16_d16_o16_launches
    got, want = fn(v, t), ref_fn(ref_v, ref_t)
    torch.cuda.synchronize()
    assert bs.sweep_blocks.w16_d16_o16_launches == before + 1
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32_weights", "flux", "init"])
def test_cuda_bf16_state_refused_outside_its_form(cuda_benches, case):
    """A bf16 var_T on the card launches K1's one bf16-state instance or
    raises before a launch: nothing else is instantiated."""
    from cfd_proxy_tpu_torch.tools import kbench

    _, v, t = kbench.variant_table(cuda_benches[128], ["var16"])["var16"]
    o = [t["srcs"], t["slot_w"], t["scale"], t["block_ids"], t["slots"]]
    before = {a: getattr(bs.sweep_blocks, a)
              for a in bs.sweep_blocks.count_attrs}
    with pytest.raises(CheckError, match="bf16 var_T"):
        if case == "f32_weights":
            o[1] = o[1].float()
            bs.sweep_blocks(v, *o, out_dtype=torch.bfloat16)
        elif case == "flux":
            bs.sweep_blocks(v, *o, op="flux", out_dtype=torch.bfloat16)
        else:
            bs.sweep_blocks(v, *o, init=torch.zeros(
                (1, 24, v.shape[2]), dtype=torch.bfloat16, device="cuda"))
    assert before == {a: getattr(bs.sweep_blocks, a)
                      for a in bs.sweep_blocks.count_attrs}


# --------------------- the peer form of K3 and the push bench's K6, on the card

def _peer_for(model, dtype=torch.float32):
    from cfd_proxy_tpu_torch.parallel.transport import Peer

    return Peer(model.dsts.numpy(), model.srcs.numpy(), rows=model.rows,
                s_max=model.s_max, dtype=dtype, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_cuda_overlap_peer_kernels_match_plain(cuda_model, cuda_gather_model,
                                               cuda_flux_models, kernel, op,
                                               wire):
    """K3's peer form (address table, readiness barrier, arrival flags in
    one launch, one rank) against its plain version in every form K3 has:
    packed and gather, gg and flux, f32 and bf16 push.  The sweep within
    the sweep bound, the pushed buffers bitwise, over three launches on one
    transport (the device epoch words advance; recv is overwritten each
    time)."""
    if op == "flux":
        model, state = cuda_flux_models[kernel]
    else:
        model, state = cuda_gather_model if kernel == "gather" else cuda_model
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    fused, ref = ((bs.sweep_blocks_overlap_gather,
                   bs.sweep_blocks_overlap_gather_ref) if kernel == "gather"
                  else (bs.sweep_blocks_overlap, bs.sweep_blocks_overlap_ref))
    dtype = torch.bfloat16 if wire == "bf16" else torch.float32
    peer = _peer_for(model, dtype)
    gen = torch.Generator("cuda").manual_seed(21)
    P = len(model.parts)
    attr = ("peer_" + "flux_" * (op == "flux")
            + (_body_tag(model, "interior", op, fused=True)
               if kernel == "gather" else "") + "launches")
    before = getattr(fused, attr)
    try:
        for _ in range(3):
            init = torch.randn((P, model.rows, model.ndev), device="cuda",
                               generator=gen)
            send = torch.randn((P, model.nphases, model.rows, model.s_max),
                               device="cuda", generator=gen).to(dtype)
            g, r = fused(*args, init.clone(), send, None, None, op=op,
                         peer=peer)
            g_ref, r_ref = ref(*args, init.clone(), send, model.dsts,
                               model.srcs, op=op)
            torch.cuda.synchronize()
            _assert_close(g, g_ref, False)
            assert r.dtype == dtype and torch.equal(r, r_ref)
        assert getattr(fused, attr) == before + 3
    finally:
        peer.close()


@pytest.mark.cuda
@pytest.mark.parametrize("debug", ["nobar", "nodma"])
def test_cuda_overlap_peer_debug_modes(cuda_model, debug):
    """The kernel debug rungs: nobar pushes without the barrier (right on
    one rank), nodma leaves recv as it was; the sweep is the same."""
    model, state = cuda_model
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    peer = _peer_for(model)
    gen = torch.Generator("cuda").manual_seed(22)
    P = len(model.parts)
    init = torch.randn((P, 24, model.ndev), device="cuda", generator=gen)
    send = torch.randn((P, model.nphases, 24, model.s_max), device="cuda",
                       generator=gen)
    try:
        g, r = bs.sweep_blocks_overlap(*args, init.clone(), send, None, None,
                                       peer=peer, debug=debug)
        g_ref, r_ref = bs.sweep_blocks_overlap_ref(
            *args, init.clone(), send, model.dsts, model.srcs)
        torch.cuda.synchronize()
        _assert_close(g, g_ref, False)
        want = r_ref if debug == "nobar" else torch.zeros_like(r_ref)
        assert torch.equal(r, want)
    finally:
        peer.close()


@pytest.mark.cuda
@pytest.mark.parametrize("nph", [1, 4])
@pytest.mark.parametrize("mode", ["full", "nobar", "baronly", "empty"])
def test_cuda_push_phases_matches_plain(mode, nph):
    """K6 per mode against its plain version, bitwise, at a payload whose
    16-byte pieces do not divide among the push blocks evenly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.ops import push
    from cfd_proxy_tpu_torch.parallel.transport import Loopback
    from cfd_proxy_tpu_torch.tools.icibench import make_transport

    rows, lanes = 24, 128 * 37
    peer = make_transport(1, nph, rows, lanes, "cuda", None)
    plain = Loopback(np.zeros((1, nph), np.int32), "cuda")
    send = torch.randn((1, nph, rows, lanes), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(23))
    before = getattr(push.push_phases, mode + "_launches")
    try:
        for _ in range(2):
            got = push.push_phases(send, peer, mode)
            want = push.push_phases_ref(send, plain, mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            send = send + 1.0
        assert getattr(push.push_phases, mode + "_launches") == before + 2
    finally:
        peer.close()


def _graph_of(step):
    """step() captured in a torch.cuda.CUDAGraph after one warm-up call on
    a side stream (which launches: it counts as one launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph


def _epochs(peer):
    """The transport's launch epoch words: (barrier, copy) launches."""
    torch.cuda.synchronize()
    return tuple(int(x) for x in peer.epoch_words.cpu())


N_REPLAYS = 6


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_cuda_overlap_peer_replays_as_graph(cuda_model, cuda_gather_model,
                                            kernel):
    """K3's peer form captured in a CUDA graph and replayed N times equals
    N eager launches bit for bit: a chain whose launch i + 1 sweeps onto
    launch i's output and pushes a buffer made from launch i's recv.  The
    epochs are device words the launches advance (capture moves none), so
    eager launches after the replays, and a replay after them, still meet
    their flags."""
    model, state = cuda_gather_model if kernel == "gather" else cuda_model
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    fused = (bs.sweep_blocks_overlap_gather if kernel == "gather"
             else bs.sweep_blocks_overlap)
    kw = model._gather_kw("interior")
    gen = torch.Generator("cuda").manual_seed(24)
    P = len(model.parts)
    init0 = torch.randn((P, model.rows, model.ndev), device="cuda",
                        generator=gen)
    send0 = torch.randn((P, model.nphases, model.rows, model.s_max),
                        device="cuda", generator=gen)
    peer = _peer_for(model)
    g_, s_ = init0.clone(), send0.clone()

    def step(g=g_, s=s_):
        _, r = fused(*args, g, s, None, None, peer=peer, **kw)
        s.mul_(0.5).add_(r)

    try:
        graph = _graph_of(step)
        assert _epochs(peer) == (1, 1)          # the warm-up alone
        g_.copy_(init0)
        s_.copy_(send0)
        for _ in range(N_REPLAYS):
            graph.replay()
        g_e, s_e = init0.clone(), send0.clone()
        for _ in range(N_REPLAYS):
            step(g_e, s_e)
        torch.cuda.synchronize()
        assert torch.equal(g_, g_e) and torch.equal(s_, s_e)
        assert not torch.equal(g_, init0)
        assert _epochs(peer) == (1 + 2 * N_REPLAYS,) * 2
        # eager after the replays, then a replay after eager: one count
        step(g_e, s_e)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_, g_e) and torch.equal(s_, s_e)
        assert _epochs(peer) == (3 + 2 * N_REPLAYS,) * 2
    finally:
        peer.close()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "nobar", "baronly", "empty"])
def test_cuda_push_phases_replays_as_graph(mode):
    """K6 captured and replayed N times equals N eager launches bit for bit
    (the chain v <- v + c·push(v) of the push bench), and an eager launch
    after the replays still meets the flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.ops import push
    from cfd_proxy_tpu_torch.tools.icibench import make_transport

    nph, rows, lanes = 3, 24, 128 * 37
    peer = make_transport(1, nph, rows, lanes, "cuda", None)
    v0 = torch.randn((1, nph, rows, lanes), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(25))
    v_ = v0.clone()

    def step(v=v_):
        v.add_(0.25 * push.push_phases(v, peer, mode))

    bar, copy = (PUSH_BITS[mode] & 1, PUSH_BITS[mode] >> 1 & 1)
    try:
        graph = _graph_of(step)
        v_.copy_(v0)
        for _ in range(N_REPLAYS):
            graph.replay()
        v_e = v0.clone()
        for _ in range(N_REPLAYS):
            step(v_e)
        torch.cuda.synchronize()
        assert torch.equal(v_, v_e) and not torch.equal(v_, v0)
        n = 1 + 2 * N_REPLAYS
        assert _epochs(peer) == (n * bar, n * copy)
        step(v_e)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(v_, v_e)
        assert _epochs(peer) == ((n + 2) * bar, (n + 2) * copy)
    finally:
        peer.close()


PUSH_BITS = {"full": 3, "nobar": 2, "nodma": 0, "baronly": 5, "empty": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,mode", [
    ("k3", "full"), ("k3", "nobar"), ("k3", "nodma"), ("k6", "full"),
    ("k6", "nobar"), ("k6", "baronly"), ("k6", "empty")])
def test_cuda_epoch_words_count_launches_per_mode(cuda_model, kernel, mode):
    """The epoch words read back after launches in one mode: the barrier
    word counts the launches with kPushBarrier, the copy word those with
    kPushCopy (csrc/push_common.cuh), every launch advancing them once; a
    later full launch still meets its flags (recv bitwise)."""
    from cfd_proxy_tpu_torch.ops import push
    from cfd_proxy_tpu_torch.ops.blocksweep import PUSH_MODES

    assert PUSH_MODES == PUSH_BITS
    model, state = cuda_model
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    P = len(model.parts)
    gen = torch.Generator("cuda").manual_seed(26)
    init = torch.randn((P, 24, model.ndev), device="cuda", generator=gen)
    send = torch.randn((P, model.nphases, 24, model.s_max), device="cuda",
                       generator=gen)
    peer = _peer_for(model)

    def launch(m):
        if kernel == "k3":
            return bs.sweep_blocks_overlap(
                *args, init.clone(), send, None, None, peer=peer,
                debug=None if m == "full" else m)[1]
        return push.push_phases(send, peer, m)

    bar, copy = PUSH_BITS[mode] & 1, PUSH_BITS[mode] >> 1 & 1
    try:
        assert _epochs(peer) == (0, 0)
        for n in range(1, 4):
            launch(mode)
            assert _epochs(peer) == (n * bar, n * copy)
        got = launch("full").clone()
        assert _epochs(peer) == (3 * bar + 1, 3 * copy + 1)
        want = bs.sweep_blocks_overlap_ref(
            *args, init.clone(), send, model.dsts, model.srcs)[1]
        assert torch.equal(got, want)
    finally:
        peer.close()


@pytest.mark.cuda
def test_cuda_two_ranks_share_one_card():
    """Two processes on one card map each other's exchange memory: K6 ring
    and the model's every schedule through the peer transport at W = 2
    equal the one-process results bitwise (workers in the package)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.parallel import launch, workers

    one = workers.model_outputs(workers.ModelCase(
        nx=9, ny=8, nz=7, parts=4, device="cuda", model={"bp": 128}))
    two = launch.spawn(2, workers.model_outputs, (workers.ModelCase(
        nx=9, ny=8, nz=7, parts=4, device="cuda", backend="gloo",
        share_device=True, model={"bp": 128, "transport": "peer"}),),
        timeout_s=300)
    for s, want in one["outputs"].items():
        assert np.array_equal(two[0]["outputs"][s], want), s
        assert np.array_equal(two[1]["outputs"][s], want), s
    assert two[0]["launches"].get("sweep_blocks_overlap_peer", 0) >= 1
    ring = launch.spawn(2, workers.push_ring, (2, 24, 128 * 5, "cuda", True),
                        timeout_s=300)
    assert all(r["bitwise"] for r in ring)


# ------------------------- K1 clears its own gaps; the chained update

def _bits(t):
    """Bit patterns: a -0.0 against a +0.0 shows, and so does NaN."""
    t = t.contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.fixture(scope="module")
def cuda_gap_models():
    """(P, op) → model and state on a 20×20×20 mesh at bp 128: at one shard
    (force_rdma) the boundary class lists a single block of many, at eight
    it leaves long gaps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.models.gradients import PSDFluxModel

    g = generate_mesh(20, 20, 20, jitter=0.05, diag_frac=0.25, seed=7)
    gv = make_state(g.npoint, NVAR, seed=9)
    cache = {}

    def get(npart, op):
        if (npart, op) not in cache:
            cls = GreenGaussTorch if op == "gg" else PSDFluxModel
            m = cls(partition_mesh(g, npart, ghost_layers=1), NVAR, bp=128,
                    device="cuda", force_rdma=npart == 1)
            cache[(npart, op)] = m, m.distribute_state(gv)
        return cache[(npart, op)]

    return get


def _nan_empty(monkeypatch):
    """torch.empty hands NaN-filled tensors while the test runs: a column
    the kernel leaves unwritten stays NaN."""
    full = torch.full

    def empty(size, *a, dtype=None, device=None, **kw):
        return full(size, float("nan"), dtype=dtype, device=device)

    monkeypatch.setattr(torch, "empty", empty)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "w16_d16_o16", "v16"])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("npart,cls", [(1, "boundary"), (8, "boundary"),
                                       (8, "bulk"), (8, "interior")])
def test_cuda_zero_filled_sweep_clears_its_gaps(cuda_gap_models, monkeypatch,
                                                npart, cls, op, form):
    """K1 without init into an output pre-filled with NaN: the columns of
    the blocks the list leaves out are +0.0 (bit for bit the plain
    version's), the listed ones within the sweep bound of it, and the whole
    bit for bit K1-init on a zero output (the same sums); the bf16-state
    instance (v16, gg only) on the same plans."""
    if form == "v16" and op == "flux":
        pytest.skip("the bf16-state instance runs op gg only")
    model, state = cuda_gap_models(npart, op)
    w16 = d16 = o16 = form != "f32"
    args = list(_packed_operands(model, state, cls, w16, d16))
    if form == "v16":
        args[0] = args[0].to(torch.bfloat16)
    odt = torch.bfloat16 if o16 else torch.float32
    attr = (("flux_" if op == "flux" else "")
            + bs._tag(w16, d16, o16, v16=form == "v16") + "launches")
    before = getattr(bs.sweep_blocks, attr)
    with monkeypatch.context() as mp:
        _nan_empty(mp)
        got = bs.sweep_blocks(*args, op=op, out_dtype=odt)
    want = bs.sweep_blocks_ref(*args, op=op, out_dtype=odt)
    torch.cuda.synchronize()
    assert getattr(bs.sweep_blocks, attr) == before + 1
    assert not bool(got.isnan().any())
    ids = model.plans[cls]["block_ids"].long().cpu()
    listed = torch.zeros((len(model.parts), model.ndev), dtype=torch.bool)
    for p in range(len(model.parts)):
        for b in ids[p].unique():
            listed[p, b * model.bp:(b + 1) * model.bp] = True
    if cls == "boundary":
        assert int((~listed).sum()) > 4 * model.bp     # a long gap
    gaps = ~listed[:, None, :].expand(-1, got.shape[1], -1).to(got.device)
    assert bool((_bits(got)[gaps] == 0).all())
    assert bool((_bits(want)[gaps] == 0).all())
    if float(want.float().abs().max()) == 0.0:
        # the one-shard boundary plan lists the trash block alone (zero
        # scale): the output is +0.0 throughout
        assert bool((_bits(got) == 0).all())
    else:
        _assert_close(got, want, o16)
    if form != "v16":
        zeros = torch.zeros_like(got)
        init = bs.sweep_blocks(*args, init=zeros, op=op)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(init))


def _k1_ptxas(log):
    """{K1 instance (mangled): (registers, spill store bytes, spill load
    bytes)} from nvcc's ptxas report."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1) if "sweep_packed" in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(name, [None, None, None])[1:] = map(int,
                                                                m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, [None, None, None])[0] = int(m.group(1))
    return out


@pytest.mark.cuda
def test_cuda_k1_instances_keep_their_registers():
    """Every K1 instance (33: gg and flux, each form and precision, and the
    bf16-state one), by ptxas: the zero-filled forms, which now clear their
    gaps, without a spill, gg in at most 72 registers (64 before), flux in
    48 as before; the init forms as before: gg 96 registers, the four whose
    weights and sources differ in type with their 8 bytes of spill stores,
    the rest none; flux 48, none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import re
    import subprocess

    from cfd_proxy_tpu_torch.ops import _cuda

    facts = _k1_ptxas(_cuda.build()["log"])
    assert len(facts) == 33, sorted(facts)
    names = subprocess.run(["c++filt"], input="\n".join(facts),
                           capture_output=True, text=True).stdout.split("\n")
    for (mangled, (regs, st, ld)), name in zip(facts.items(), names):
        init = "<true," in name
        flux = "(cfd::Op)1" in name
        w, src = re.search(r"PackedSrc<([\w:]+), ([\w:]+)>", name).groups()
        if flux:
            assert (regs, st, ld) == (48, 0, 0), name
        elif init:
            assert regs == 96 and st == ld == (8 if w != src else 0), name
        else:
            assert regs <= 72 and st == ld == 0, (name, regs, st, ld)


UPDATE_SHAPES = [(1, 4096), (3, 1001)]     # vectorised, and the scalar path


@pytest.mark.cuda
@pytest.mark.parametrize("with_out", [False, True])
@pytest.mark.parametrize("rows", [24, 8])
@pytest.mark.parametrize("g16", [False, True])
@pytest.mark.parametrize("P,ndev", UPDATE_SHAPES)
def test_cuda_chain_update_equals_plain_bitwise(P, ndev, g16, rows,
                                                with_out):
    """The update kernel against `chain_update_ref` bit for bit (f32 and
    bf16 g, gradient and flux rows, into a new tensor or `out`), v left
    unwritten, at a coupling that moves the state and at the reference's
    1e-30."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from cfd_proxy_tpu_torch.ops import update

    gen = torch.Generator("cuda").manual_seed(ndev + rows)
    v = torch.randn((P, 8, ndev), device="cuda", generator=gen)
    g = torch.randn((P, rows, ndev), device="cuda", generator=gen) * 7
    if g16:
        g = g.to(torch.bfloat16)
    v0 = v.clone()
    attr = "g16_launches" if g16 else "launches"
    for c in (0.1, 1e-30, -3.7):
        before = getattr(update.chain_update, attr)
        out = torch.full_like(v, float("nan")) if with_out else None
        got = update.chain_update(v, g, c, out=out)
        want = update.chain_update_ref(v, g, c)
        torch.cuda.synchronize()
        assert getattr(update.chain_update, attr) == before + 1
        assert got is out if with_out else got.data_ptr() != v.data_ptr()
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(v, v0)
