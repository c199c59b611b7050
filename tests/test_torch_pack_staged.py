"""The staged source pack (K4), and on the card the push path K6 and K3's
peer form share.

K4 stages each table block's own columns and its ext columns and resolves
every compact lane's W-index against them (csrc/pack_srcs.cu), as the
reference's `gather_exts` + `pack_srcs` do.  On the CPU:

- the compact W-index (`ops/plan.py::compact_widx`) and the ext lists the
  model carries resolve to `src_cols` exactly, on the JAX model's plans at
  P ∈ {1, 8} and bp ∈ {128, 256} (the trash block included);
- a plain-torch form of the staged algorithm (stage, then index) equals
  `pack_srcs_ref` bit for bit in f32 and bf16d, and the JAX model's own
  tables (its Pallas pack in interpret mode).

The `cuda`-marked tests hold the kernels to their plain versions on the
card: K4 and K4-bf16d bitwise at P=1 and P=8, at an L that is not a
multiple of the CUDA block, with EP = 0 and with the largest EP a block's
shared memory takes; K6 in every mode at payloads of one 16-byte piece to
several push blocks with uneven shares; K3's peer form (packed f32, gather
f32, packed bf16 stack) bitwise against the loopback K3; and K3-peer's
resident blocks per SM.  They import no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_pack_staged.py -m cuda
"""

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops import push
from cfd_proxy_tpu_torch.ops.plan import NV

torch.set_num_threads(1)

NVAR = 5
BF = "bfloat16"
FULL = {"src_dtype": BF, "meta_dtype": BF, "grad_dtype": BF,
        "halo_dtype": BF}
# (P, bp); at P=8 the test mesh's shards cap bp at 128
JAX_CASES = [(1, 128), (1, 256), (8, 128)]
PEER_PUSH_BLOCKS = 264   # csrc/push_common.cuh::kPeerPushBlocks


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def jax_models(mesh, gvar):
    """(P, bp, src_dtype) → (its plans in the port's arrays, var_T, the JAX
    tables per class in the compact layout); built once."""
    cache = {}

    def get(P, bp, src_dtype="float32"):
        key = (P, bp, src_dtype)
        if key not in cache:
            from cfd_proxy_tpu.models import GreenGaussPallas
            from cfd_proxy_tpu_torch.convert import (plans_from_jax,
                                                     state_from_jax)

            jm = GreenGaussPallas(partition_mesh(mesh, P, ghost_layers=1),
                                  NVAR, bp=bp, interpret=True,
                                  src_dtype=src_dtype)
            js = jm.distribute_state(gvar)
            tables = {}
            for c in ("bulk", "boundary", "interior"):
                t = np.asarray(js[f"tbl_{c}"])
                tables[c] = (t.view(np.uint16) if t.dtype.name == "bfloat16"
                             else t)
            cache[key] = (plans_from_jax(jm), state_from_jax(js), tables)
        return cache[key]

    return get


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))     # writable copy


def resolve(widx, ext_idx, block_ids, bp):
    """Device column of every compact entry: own W-index w → block_ids·bp +
    w, ext W-index bp + r → ext_idx[r]."""
    own = block_ids.astype(np.int64)[:, :, None] * bp + widx
    r = np.clip(widx.astype(np.int64) - bp, 0, max(ext_idx.shape[2] - 1, 0))
    ext = (np.take_along_axis(ext_idx.astype(np.int64), r, axis=2)
           if ext_idx.shape[2] else np.zeros_like(own))
    return np.where(widx < bp, own, ext)


def staged_pack(var_T, widx, ext_idx, block_ids, bp, src_format="f32",
                slots=None):
    """The kernel's algorithm in plain torch: stage each block's own
    columns then its ext columns, then index the staged rows by W-index
    (bf16d: minus the staged own lane, rounded to bf16)."""
    P, nb, L = widx.shape
    ndev = var_T.shape[2]
    own = block_ids.long()[:, :, None] * bp + torch.arange(bp)
    cols = torch.cat([own, ext_idx.long()], dim=2)              # (P, nb, W)
    W = cols.shape[2]
    stage = torch.gather(var_T[:, None].expand(P, nb, NV, ndev), 3,
                         cols[:, :, None].expand(P, nb, NV, W))
    got = torch.gather(stage, 3, widx.long()[:, :, None].expand(P, nb, NV, L))
    if src_format == "f32":
        return got
    lanes = torch.cat([torch.arange(int(w)) for w in slots[0] if w])
    return (got - stage[..., lanes]).to(torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_compact_widx_and_ext_lists_resolve_to_src_cols(jax_models, P, bp):
    arrays, _, _ = jax_models(P, bp)
    for c, ca in arrays["classes"].items():
        widx, ext = ca["widx"], ca["ext_idx"]
        assert widx.dtype == np.int32 and widx.shape == ca["src_cols"].shape
        assert ext.shape[:2] == ca["block_ids"].shape
        assert 0 <= widx.min() and widx.max() < bp + ext.shape[2], c
        np.testing.assert_array_equal(
            resolve(widx, ext, ca["block_ids"], bp), ca["src_cols"],
            err_msg=c)
    # the all-blocks lists end with the trash block (no real point)
    trash = arrays["ndev"] // bp - 1
    assert (arrays["classes"]["bulk"]["block_ids"][:, -1] == trash).all()


@pytest.mark.parametrize("src_format", ["f32", "bf16d"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_staged_pack_equals_plain_and_jax_bitwise(jax_models, P, bp,
                                                  src_format):
    """stage-then-index == pack_srcs_ref == the JAX model's table, every
    class, pad lanes and pad entries included."""
    arrays, var_T, tables = jax_models(
        P, bp, "float32" if src_format == "f32" else BF)
    var_T = _t(var_T)
    for c, ca in arrays["classes"].items():
        slots = _t(bs.slot_table(ca["wks"]))
        kw = dict(block_ids=_t(ca["block_ids"]), slots=slots, bp=bp)
        got = staged_pack(var_T, _t(ca["widx"]), _t(ca["ext_idx"]),
                          src_format=src_format, **kw)
        ref = bs.pack_srcs_ref(var_T, _t(ca["src_cols"]), src_format, **kw)
        assert got.dtype == ref.dtype and torch.equal(got, ref), c
        # the wrapper on CPU tensors, staged operands given: the plain form
        wrapped = bs.pack_srcs(var_T, _t(ca["src_cols"]),
                               src_format=src_format, widx=_t(ca["widx"]),
                               ext_idx=_t(ca["ext_idx"]), **kw)
        assert torch.equal(wrapped, ref), c
        want = tables[c]
        if src_format == "f32":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=c)
        else:
            np.testing.assert_array_equal(_bits(got), want, err_msg=c)


def test_model_carries_staged_operands(mesh, gvar):
    """A packed model keeps widx and ext_idx per class, and its tables equal
    the staged form of them."""
    tm = GreenGaussTorch(partition_mesh(mesh, 4, ghost_layers=1), NVAR,
                         bp=128, device="cpu")
    state = tm.distribute_state(gvar)
    for c, tbl in state["tables"].items():
        ops = tm.pack_operands(c)
        assert set(ops) == {"block_ids", "slots", "widx", "ext_idx"}
        got = staged_pack(state["var_T"], ops["widx"], ops["ext_idx"],
                          ops["block_ids"], tm.bp)
        assert torch.equal(got, tbl), c


@pytest.mark.parametrize("bp,ep,rows", [
    (128, 0, 2), (4096, 1812, 2),
    (4096, bs.PACK_SMEM // 8 - 4096, 2),        # two rows just fit
    (4096, bs.PACK_SMEM // 8 - 4092, 1),        # four floats more: one row
    (128, bs.PACK_SMEM // 4 - 128, 1)])         # the largest row
def test_pack_rows_fit_shared_memory(bp, ep, rows):
    """The pack kernel stages two variable rows per CUDA block, one where
    two do not fit a block's shared memory."""
    assert bs.pack_rows(bp, ep) == rows
    assert rows * bs._pack_stride(bp, ep) * 4 <= bs.PACK_SMEM


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def card_models(mesh, gvar):
    """P → (packed model, its state) on the card, bp 128."""
    _card()
    out = {}
    for P in (1, 8):
        m = GreenGaussTorch(partition_mesh(mesh, P, ghost_layers=1), NVAR,
                            bp=128, device="cuda")
        out[P] = (m, m.distribute_state(gvar))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("src_format", ["f32", "bf16d"])
@pytest.mark.parametrize("P", [1, 8])
def test_cuda_pack_kernel_equals_plain_on_plans(card_models, P, src_format):
    model, state = card_models[P]
    var_T = state["var_T"]
    for c, pl in model.plans.items():
        kw = dict(src_format=src_format, bp=model.bp,
                  **model.pack_operands(c))
        got = bs.pack_srcs(var_T, pl["src_cols"], **kw)
        ref = bs.pack_srcs_ref(var_T, pl["src_cols"], src_format,
                               pl["block_ids"], pl["slots"], model.bp)
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype and torch.equal(got, ref), c


def _synthetic(ep, L=333, P=2, nb=3, bp=128, nblk=8, seed=5):
    """Random staged operands on the card: L lanes in slots of widths
    (128, 128, 77), a W-index over [0, bp + ep), ep ext columns."""
    rng = np.random.default_rng(seed)
    ndev = nblk * bp
    var_T = rng.standard_normal((P, NV, ndev)).astype(np.float32)
    bids = np.sort(rng.choice(nblk, (P, nb), replace=False), axis=1)
    widx = rng.integers(0, bp + ep, (P, nb, L)).astype(np.int32)
    ext = rng.integers(0, ndev, (P, nb, ep)).astype(np.int32)
    cols = resolve(widx, ext, bids, bp).astype(np.int32)
    wks = (128, 128, L - 256)
    dev = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in (
        ("var_T", var_T), ("block_ids", bids.astype(np.int32)),
        ("widx", widx), ("ext_idx", ext), ("src_cols", cols),
        ("slots", bs.slot_table(wks)))}
    return dev, bp


@pytest.mark.cuda
@pytest.mark.parametrize("src_format", ["f32", "bf16d"])
@pytest.mark.parametrize("ep", [0, 128, "largest"])
def test_cuda_pack_kernel_synthetic_shapes(src_format, ep):
    """L = 333 (not a multiple of the CUDA block), EP = 0, and the largest
    EP whose staged row still fits one block's shared memory (the wrapper
    halves the rows it stages until they fit)."""
    _card()
    if ep == "largest":
        ep = bs.PACK_SMEM // 4 - 128
    d, bp = _synthetic(ep)
    kw = dict(src_format=src_format, block_ids=d["block_ids"],
              slots=d["slots"], bp=bp)
    got = bs.pack_srcs(d["var_T"], d["src_cols"], widx=d["widx"],
                       ext_idx=d["ext_idx"], **kw)
    ref = bs.pack_srcs_ref(d["var_T"], d["src_cols"], src_format,
                           d["block_ids"], d["slots"], bp)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_pack_kernel_refuses_a_row_past_shared_memory():
    _card()
    from cfd_proxy_tpu_torch.utils.errors import CheckError

    d, bp = _synthetic(bs.PACK_SMEM // 4 - 124, L=256)
    with pytest.raises(CheckError, match="shared memory"):
        bs.pack_srcs(d["var_T"], d["src_cols"], block_ids=d["block_ids"],
                     bp=bp, widx=d["widx"], ext_idx=d["ext_idx"])


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [16, 2032, 2064, 8208, 18448,
                                    24 * 4 * 1283])
@pytest.mark.parametrize("mode", push.MODES)
def test_cuda_push_phases_odd_payloads(mode, nbytes):
    """K6 per mode, bitwise against its plain version, at payloads that are
    no whole number of a block's four-load strides (and one that splits over
    several blocks with uneven shares)."""
    _card()
    from cfd_proxy_tpu_torch.parallel.transport import Loopback
    from cfd_proxy_tpu_torch.tools.icibench import make_transport

    nph = 2
    lanes = nbytes // 4
    peer = make_transport(1, nph, 1, lanes, "cuda", None)
    plain = Loopback(np.zeros((1, nph), np.int32), "cuda")
    send = torch.randn((1, nph, 1, lanes), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(nbytes))
    try:
        for _ in range(2):
            got = push.push_phases(send, peer, mode)
            want = push.push_phases_ref(send, plain, mode)
            torch.cuda.synchronize()
            if mode in ("full", "nobar"):
                assert torch.equal(got, want)
            else:       # phase 0 copied locally; the rest as it was
                assert torch.equal(got[:, 0], want[:, 0])
            send = send + 1.0
    finally:
        peer.close()


@pytest.fixture(scope="module")
def card_p4(mesh, gvar):
    """Four-shard models on the card for K3's peer form: packed f32, gather
    f32 (bp 128) and the packed full bf16 stack, with their states."""
    _card()
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    out = {}
    for name, opts in (("packed", {}), ("gather", {"kernel": "gather"}),
                       ("bf16", FULL)):
        m = GreenGaussTorch(parts, NVAR, bp=128, device="cuda", **opts)
        out[name] = (m, m.distribute_state(gvar))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "gather", "bf16"])
def test_cuda_overlap_peer_equals_loopback_bitwise(card_p4, form):
    """K3's peer form against the loopback K3 on the same operands: the
    interior sweep and the pushed buffers bit for bit, over three launches
    on one transport."""
    from cfd_proxy_tpu_torch.parallel.transport import Peer

    model, state = card_p4[form]
    fused = (bs.sweep_blocks_overlap_gather if form == "gather"
             else bs.sweep_blocks_overlap)
    args = (state["var_T"], *model._operands("interior", state["tables"]))
    peer = Peer(model.dsts.numpy(), model.srcs.numpy(), rows=model.rows,
                s_max=model.s_max, dtype=model.halo_t, device="cuda")
    try:
        for i in range(3):
            init = model.step(state, "nocomm") * (i + 1)
            send = model._pack(init, model.pack_scale, model.halo_t)
            g_peer, r_peer = fused(*args, init.clone(), send, None, None,
                                   peer=peer)
            g_loop, r_loop = fused(*args, init.clone(), send, model.dsts,
                                   model.srcs)
            torch.cuda.synchronize()
            assert torch.equal(g_peer, g_loop)
            assert torch.equal(r_peer, r_loop)
    finally:
        peer.close()


@pytest.mark.cuda
def test_cuda_peer_form_keeps_its_resident_blocks():
    """K3's peer form keeps the blocks per SM its launch bounds ask for
    (`min_blocks`, read from the instance: the packed forms' kMinBlocks,
    f32 and bf16 stack; the gather form's direct body under gg,
    sweep_common.cuh::kDirectMinBlocks, fewer: two lanes a thread).  Any
    of them holds the peer push's residency argument
    (csrc/push_common.cuh, why no launch can deadlock on itself): the
    signal block and every push block, at most kPeerPushBlocks (264), are
    resident at once beside sweep blocks, so no push block waits for a
    slot behind the sweep; fewer slots would only delay the sweep blocks,
    since every wait is for a block 0 that is resident first."""
    _card()
    from cfd_proxy_tpu_torch.ops import _cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for flags in ((0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 1, 1)):
        info = _cuda.kernel_info("cfd_overlap_peer_info", *flags)
        assert info["min_blocks"] >= 1, (flags, info)
        assert info["blocks_per_sm"] >= info["min_blocks"], (flags, info)
        assert info["blocks_per_sm"] * sms > 1 + PEER_PUSH_BLOCKS, (flags,
                                                                    info)
