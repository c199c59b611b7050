"""The gather sweep's staged body: K2 and K3's gather form stage each
listed entry's [own ‖ live ext] table in shared memory (csrc/
sweep_common.cuh::sweep_entry_staged) where `gather_body` picks it (K3's
flux form keeps the direct body).

On the CPU:

- the live ext counts the port carries (`ext_counts`, derived from the
  W-indices) equal the reference plans' `ext_cnt`, on the JAX model's
  plans at P ∈ {1, 8} and bp ∈ {128, 256} (the trash block and the pad
  entries included);
- a plain-torch form of the staged algorithm (stage own ‖ the live ext
  columns, the dead ones NaN, then index by W-index) equals
  `sweep_blocks_gather_ref` bit for bit, for gg and flux, with and without
  init, in f32 and bf16 weights and outputs, and the JAX gather kernel
  (`sweep_blocks(..., packed=False, interpret=True)`) within 1e-6 of
  max|ref| (f32) or one bf16 ulp plus that (bf16 outputs);
- the fixed body rule and the shared-memory fit at the 96³ benchmark
  shapes, from the numbers alone, and the fused flux form's direct body.

The `cuda`-marked tests hold every K2 instance and every K3-gather instance
(loopback and peer) to its plain version under both bodies, with pad
entries, zero-width slots, EP = 128 and the largest EP the rule stages; the
staged body against the direct one and K3-gather-peer against the loopback
K3-gather bit for bit; and the resident blocks per SM of the staged
instances.  They import no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gather_staged.py -m cuda
"""

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops.plan import NV

torch.set_num_threads(1)

NVAR = 5
BF = "bfloat16"
TOL = 1e-6          # f32 kernels vs plain and the reference: FMA contraction
# (P, bp); at P=8 the test mesh's shards cap bp at 128
JAX_CASES = [(1, 128), (1, 256), (8, 128)]
CLASSES = ("bulk", "boundary", "interior")
# (w16, o16): f32 or bf16 weights, f32 or bf16 output
PRECISIONS = [(False, False), (True, False), (False, True), (True, True)]
STATIC_SMEM = bs.MAX_SLOTS * 4            # the kernels' slot-width table
SM_SMEM = 227 * 1024                      # what an H100 block may take
# an H100 SM's shared memory, and what the runtime reserves per CUDA block
SM_TOTAL, BLOCK_RESERVED = 228 * 1024, 1024


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def jax_gather(mesh, gvar):
    """(P, bp, meta_dtype) → (JAX gather model, its state, its plans in the
    port's arrays, the reference's own BlockPlans in build order); built
    once.  The plans are recorded as the JAX model builds them."""
    cache = {}

    def get(P, bp, meta="float32"):
        key = (P, bp, meta)
        if key not in cache:
            import cfd_proxy_tpu.models.gradients_pallas as gp
            from cfd_proxy_tpu_torch.convert import plans_from_jax

            raw, build = [], gp.build_block_plan

            def record(*a, **kw):
                raw.append(build(*a, **kw))
                return raw[-1]

            gp.build_block_plan = record
            try:
                jm = gp.GreenGaussPallas(
                    partition_mesh(mesh, P, ghost_layers=1), NVAR, bp=bp,
                    interpret=True, kernel="gather", meta_dtype=meta)
            finally:
                gp.build_block_plan = build
            cache[key] = (jm, jm.distribute_state(gvar), plans_from_jax(jm),
                          raw)
        return cache[key]

    return get


def _t(a):
    if isinstance(a, torch.Tensor):
        return a
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))     # writable copy


def staged_sweep(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                 ext_cnt, init=None, op="gg", out_dtype=None):
    """The staged body's algorithm in plain torch: each entry's table is
    its own columns, then its first ext_cnt ext columns — the dead ones NaN,
    which a live lane must never read — every slot lane's sources are
    indexed from it by W-index, and the sweep's arithmetic follows
    (`_sweep_plain`, the plain versions' own)."""
    P, nb, _, ep = exts.shape
    live = torch.arange(ep) < ext_cnt.long()[:, :, None]     # (P, nb, EP)
    ext = torch.where(live[:, :, None], exts,
                      torch.full_like(exts, float("nan")))

    def terms(k, w, off, own):
        tbl = torch.cat([own, ext], dim=3)
        idx = slot_idx[:, :, k, None, :w].long().expand(P, nb, NV, w)
        return torch.gather(tbl, 3, idx), slot_w[:, :, k, :, :w]

    return bs._sweep_plain(var_T, scale, block_ids, slots, init, terms, op,
                           out_dtype=bs._out_dtype(init, out_dtype))


def _port_args(arrays, var_T, cls, w16):
    """(var_T, exts, slot_idx, slot_w, scale, block_ids, slots) of a class
    of JAX-model arrays, and its live ext counts, as the port loads them."""
    ca = arrays["classes"][cls]
    sidx = _t(ca["slot_idx"])
    slot_w = _t(ca["slot_w"])
    assert slot_w.dtype == (torch.bfloat16 if w16 else torch.float32)
    exts = bs.gather_exts(var_T, _t(ca["ext_idx"]))
    args = (var_T, exts, sidx, slot_w, _t(ca["scale"]), _t(ca["block_ids"]),
            _t(bs.slot_table(ca["wks"])))
    return args, torch.from_numpy(bs.ext_counts(ca["slot_idx"],
                                                int(arrays["bp"])))


def _init(P, rows, ndev, dtype, seed=8):
    x = np.random.default_rng(seed).standard_normal((P, rows, ndev))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _assert_close(got, want, what=""):
    """f32 within TOL of max|want|; bf16 elementwise within one bf16 ulp
    plus TOL of max|want|."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    w = want.float()
    scale = float(w.abs().max())
    assert scale > 0, what
    err = (got.float() - w).abs()
    bound = (bs.bf16_ulp(w) if got.dtype == torch.bfloat16 else 0) + \
        TOL * scale
    assert bool((err <= bound).all()), (what, float(err.max()))


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_ext_counts_equal_reference_ext_cnt(jax_gather, P, bp):
    """The live ext count per entry, derived from the W-indices, is the
    reference plan's ext_cnt, padded as the reference pads it; a port model
    loaded from the same arrays carries it."""
    from cfd_proxy_tpu.models.gradients_pallas import (_pad_blocks,
                                                       _pad_plan_dims)

    jm, _, arrays, raw = jax_gather(P, bp)
    tm = GreenGaussTorch.from_arrays(jm.parts, NVAR, arrays, device="cpu")
    trash = jm.layout.ndev // bp - 1
    assert len(raw) == 3 * P
    for i, c in enumerate(CLASSES):
        ep, ks, nb = jm._dims[c]
        want = np.stack([
            _pad_blocks(_pad_plan_dims(raw[3 * d + i], ep, ks), nb,
                        trash).ext_cnt for d in range(P)])
        got = bs.ext_counts(arrays["classes"][c]["slot_idx"], bp)
        assert got.dtype == np.int32 and got.shape == (P, nb), c
        np.testing.assert_array_equal(got, want, err_msg=c)
        np.testing.assert_array_equal(tm.plans[c]["ext_cnt"].numpy(), want,
                                      err_msg=c)
        assert want.max() <= ep and (c != "bulk" or want.max() > 0), c


@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_staged_form_equals_plain_bitwise(jax_gather, P, bp, op, w16, o16):
    """Stage own ‖ live ext, index by W-index == sweep_blocks_gather_ref,
    every class, with and without init; the wrapper on CPU tensors, given
    the counts, is the plain version."""
    jm, js, arrays, _ = jax_gather(P, bp, BF if w16 else "float32")
    from cfd_proxy_tpu_torch.convert import state_from_jax

    var_T = _t(state_from_jax(js))
    odt = torch.bfloat16 if o16 else torch.float32
    for c in CLASSES:
        args, cnt = _port_args(arrays, var_T, c, w16)
        for seeded in (False, True):
            init = (_init(P, bs.out_rows(op), var_T.shape[2], odt)
                    if seeded else None)

            def run(fn, **kw):
                return fn(*args, init=None if init is None else init.clone(),
                          op=op, out_dtype=odt, **kw)

            got = run(staged_sweep, ext_cnt=cnt)
            ref = run(bs.sweep_blocks_gather_ref)
            assert got.dtype == odt and torch.equal(got, ref), (c, seeded)
            assert torch.equal(run(bs.sweep_blocks_gather, ext_cnt=cnt),
                               ref), (c, seeded)


@pytest.mark.parametrize("w16o16", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_staged_form_matches_jax_gather_kernel(jax_gather, P, bp, op,
                                               w16o16):
    """The staged form against the reference's gather kernel in interpret
    mode, shard by shard: the bulk plan without init, the interior plan
    with a random init; f32, or bf16 weights and output."""
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep
    from cfd_proxy_tpu_torch.convert import state_from_jax

    jm, js, arrays, _ = jax_gather(P, bp, BF if w16o16 else "float32")
    var_np = state_from_jax(js)
    var_T = _t(var_np)
    odt, jdt = ((torch.bfloat16, jnp.bfloat16) if w16o16
                else (torch.float32, jnp.float32))
    rows = bs.out_rows(op)
    for c, seeded in (("bulk", False), ("interior", True)):
        ep, ks, nb = jm._dims[c]
        init = _init(P, rows, var_T.shape[2], odt) if seeded else None
        ref = []
        for d in range(P):
            pa = {k: jnp.asarray(np.asarray(v)[d])
                  for k, v in jm._plans_dev[c].items()}
            pa["exts"] = jnp.asarray(np.asarray(js[f"tbl_{c}"])[d])
            ini = (None if init is None else
                   jnp.asarray(init[d].float().numpy()).astype(jdt))
            ref.append(_t(np.asarray(jax_sweep(
                jnp.asarray(var_np[d]), pa, bp=bp, ep=ep, kslots=ks,
                nblocks=nb, interpret=True, packed=False, wks=jm._wks[c],
                op=op, init=ini, out_dtype=jdt))))
        args, cnt = _port_args(arrays, var_T, c, w16o16)
        got = staged_sweep(*args, cnt, init=init, op=op, out_dtype=odt)
        _assert_close(got, torch.stack(ref), c)


def test_model_carries_ext_counts(mesh, gvar):
    """A gather model built by the port keeps each class's live ext counts
    (at most EP, from its own W-indices), and its steps equal the staged
    form of its plans."""
    tm = GreenGaussTorch(partition_mesh(mesh, 4, ghost_layers=1), NVAR,
                         bp=128, kernel="gather", device="cpu")
    state = tm.distribute_state(gvar)
    for c, pl in tm.plans.items():
        cnt = pl["ext_cnt"]
        ep = pl["ext_idx"].shape[2]
        assert cnt.dtype == torch.int32 and cnt.shape == pl["block_ids"].shape
        np.testing.assert_array_equal(
            cnt.numpy(), bs.ext_counts(pl["slot_idx"].numpy(), tm.bp))
        assert int(cnt.max()) <= ep and int(cnt.min()) >= 0
        assert tm._gather_kw(c) == {"ext_cnt": cnt}
    args = (state["var_T"], *tm._operands("bulk", state["tables"]))
    assert torch.equal(tm.step(state, "nocomm"),
                       staged_sweep(*args, tm.plans["bulk"]["ext_cnt"]))


def test_ext_counts_of_an_entry_without_ext_columns():
    """An entry whose slots name only own columns (or nothing: a pad entry)
    counts 0; one naming ext column r counts r + 1."""
    sidx = np.zeros((1, 3, 2, 128), np.int32)
    sidx[0, 1, 0, 5] = 127
    sidx[0, 2, 1, 7] = 128 + 9
    np.testing.assert_array_equal(bs.ext_counts(sidx, 128), [[0, 0, 10]])
    assert bs.ext_counts(np.zeros((2, 0, 1, 128), np.int32), 128).shape \
        == (2, 0)


def test_gather_wrappers_check_ext_counts():
    """ext_cnt must be a contiguous (P, nb) int32 tensor on the sweep's
    device."""
    from cfd_proxy_tpu_torch.utils.errors import CheckError

    rng = np.random.default_rng(3)
    P, nb, K, bp, ep = 1, 2, 2, 128, 128
    args = (torch.randn(P, NV, nb * bp), torch.randn(P, nb, NV, ep),
            torch.from_numpy(rng.integers(0, bp + ep, (P, nb, K, bp))
                             .astype(np.int32)),
            torch.randn(P, nb, K, 3, bp), torch.randn(P, nb, 1, bp),
            torch.tensor([[0, 1]], dtype=torch.int32),
            torch.from_numpy(bs.slot_table((bp, 64))))
    full = torch.full((P, nb), ep, dtype=torch.int32)
    assert torch.equal(bs.sweep_blocks_gather(*args, ext_cnt=full),
                       bs.sweep_blocks_gather_ref(*args))
    for bad in (full.long(), full[:, :1].contiguous(), full.reshape(-1)):
        with pytest.raises(CheckError, match="ext_cnt"):
            bs.sweep_blocks_gather(*args, ext_cnt=bad)


# (bp, EP, body): the 96³ plans at bp 512 (one shard EP 512, eight shards
# EP 1024 and 1280), at the AUTO block size (4096, EP 1920) and at bp 8192,
# the card tests' bp 128, and the rule's edges
RULE_CASES = [
    (512, 512, "staged"), (512, 1024, "staged"), (512, 1280, "staged"),
    (4096, 1920, "staged"), (8192, 2560, "direct"), (128, 128, "staged"),
    (512, bs.GATHER_STAGE_MAX // 32 - 512, "staged"),
    (512, bs.GATHER_STAGE_MAX // 32 - 508, "direct"),
    (128, 130, "direct"), (126, 128, "direct")]


@pytest.mark.parametrize("bp,ep,body", RULE_CASES)
def test_gather_body_rule(bp, ep, body):
    """The fixed rule: staged where bp and EP allow 16-byte loads and the
    table fits one CUDA block's shared memory, else direct."""
    assert bs.staged_bytes(bp, ep) == NV * (bp + ep) * 4
    assert bs.gather_body(bp, ep) == body
    fits = bs.staged_bytes(bp, ep) + STATIC_SMEM <= SM_SMEM
    assert fits or body == "direct"


@pytest.mark.parametrize("bp,ep", [(512, 1024), (128, 128), (8192, 2560)])
def test_fused_flux_keeps_the_direct_body(bp, ep):
    """K3's gather form follows the rule in gg; its flux form keeps the
    direct body, which the staged one did not beat; K2 follows the rule in
    both ops."""
    rule = bs.gather_body(bp, ep)
    assert bs.gather_body(bp, ep, "gg", fused=True) == rule
    assert bs.gather_body(bp, ep, "flux") == rule
    assert bs.gather_body(bp, ep, "flux", fused=True) == "direct"


def test_staged_table_sizes_at_the_benchmark_plans():
    """32 KB at one shard, 48 and 56 KB at eight (bp 512): room for six,
    four and three CUDA blocks per SM; 188 KB at the AUTO block size: one."""
    sizes = [bs.staged_bytes(512, ep) for ep in (512, 1024, 1280)]
    assert [b // 1024 for b in sizes] == [32, 48, 56]
    per_sm = [SM_TOTAL // (b + STATIC_SMEM + BLOCK_RESERVED) for b in sizes]
    assert per_sm == [6, 4, 3]
    auto = bs.staged_bytes(4096, 1920)
    assert auto // 1024 == 188
    assert SM_TOTAL // (auto + STATIC_SMEM + BLOCK_RESERVED) == 1


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture
def body(request, monkeypatch):
    """Force the gather wrappers onto one body (the rule's own choice is
    tested above)."""
    name = request.param
    monkeypatch.setattr(bs, "gather_body", lambda *args, **kw: name)
    return name


@pytest.fixture(scope="module")
def card_gather(mesh, gvar):
    """(meta dtype, op) → a four-shard gather model on the card (bp 128)
    and its state."""
    _card()
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    cache = {}

    def get(w16, op):
        if (w16, op) not in cache:
            m = GreenGaussTorch(parts, NVAR, bp=128, kernel="gather", op=op,
                                meta_dtype=BF if w16 else "float32",
                                device="cuda")
            cache[(w16, op)] = (m, m.distribute_state(gvar))
        return cache[(w16, op)]

    return get


def _counter(op, init, w16, o16, body, peer=False):
    """The count attribute of a gather instance under `body`."""
    return ("peer_" * peer + "flux_" * (op == "flux") + "init_" * init
            + bs._tag(w16, False, o16) + "direct_" * (body == "direct")
            + "launches")


@pytest.mark.cuda
@pytest.mark.parametrize("body", bs.GATHER_BODIES, indirect=True)
@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_cuda_k2_instances_both_bodies(card_gather, body, op, init, w16,
                                       o16):
    """Every K2 instance under each body against its plain version, on the
    bulk plan (no init) and the padded boundary list (init), counted under
    its body's name."""
    m, state = card_gather(w16, op)
    cls = "boundary" if init else "bulk"
    args = (state["var_T"], *m._operands(cls, state["tables"]))
    odt = torch.bfloat16 if o16 else torch.float32
    seed = (_init(len(m.parts), m.rows, m.ndev, odt).cuda() if init
            else None)
    attr = _counter(op, init, w16, o16, body)
    before = getattr(bs.sweep_blocks_gather, attr)
    kw = dict(op=op, out_dtype=odt)
    got = bs.sweep_blocks_gather(
        *args, init=None if seed is None else seed.clone(),
        ext_cnt=m.plans[cls]["ext_cnt"], **kw)
    ref = bs.sweep_blocks_gather_ref(
        *args, init=None if seed is None else seed.clone(), **kw)
    torch.cuda.synchronize()
    assert getattr(bs.sweep_blocks_gather, attr) == before + 1
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("body", bs.GATHER_BODIES, indirect=True)
@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("peer", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_cuda_k3_gather_instances_both_bodies(card_gather, body, op, peer,
                                              w16, o16):
    """Every K3-gather instance, loopback and peer form, under each body
    against its plain version: the interior sweep within the bounds above,
    the pushed buffers bitwise."""
    from cfd_proxy_tpu_torch.parallel.transport import Peer

    m, state = card_gather(w16, op)
    args = (state["var_T"], *m._operands("interior", state["tables"]))
    odt = torch.bfloat16 if o16 else torch.float32
    init = _init(len(m.parts), m.rows, m.ndev, odt).cuda()
    send = m._pack(init, m.pack_scale)
    attr = _counter(op, False, w16, o16, body, peer)
    before = getattr(bs.sweep_blocks_overlap_gather, attr)
    kw = {"ext_cnt": m.plans["interior"]["ext_cnt"]}
    tr = (Peer(m.dsts.numpy(), m.srcs.numpy(), rows=m.rows, s_max=m.s_max,
               dtype=send.dtype, device="cuda") if peer else None)
    try:
        g, r = bs.sweep_blocks_overlap_gather(
            *args, init.clone(), send, m.dsts, m.srcs, op=op, peer=tr, **kw)
        g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
            *args, init.clone(), send, m.dsts, m.srcs, op=op)
        torch.cuda.synchronize()
        assert getattr(bs.sweep_blocks_overlap_gather, attr) == before + 1
        _assert_close(g, g_ref)
        assert torch.equal(r, r_ref)
    finally:
        if tr is not None:
            tr.close()


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_cuda_staged_equals_direct_bitwise(card_gather, monkeypatch, op,
                                           init):
    """The two bodies compute the same values in the same order: equal bit
    for bit on the same plan (K2, and K3-gather's sweep)."""
    m, state = card_gather(False, op)
    out = {}
    for name in bs.GATHER_BODIES:
        monkeypatch.setattr(bs, "gather_body",
                            lambda *args, n=name, **kw: n)
        for cls in CLASSES:
            args = (state["var_T"], *m._operands(cls, state["tables"]))
            seed = (_init(len(m.parts), m.rows, m.ndev, torch.float32).cuda()
                    if init else None)
            out[name, cls] = bs.sweep_blocks_gather(
                *args, init=seed, op=op, ext_cnt=m.plans[cls]["ext_cnt"])
        args = (state["var_T"], *m._operands("interior", state["tables"]))
        seed = _init(len(m.parts), m.rows, m.ndev, torch.float32).cuda()
        out[name, "fused"] = bs.sweep_blocks_overlap_gather(
            *args, seed, m._pack(seed, m.pack_scale), m.dsts, m.srcs, op=op,
            ext_cnt=m.plans["interior"]["ext_cnt"])[0]
    torch.cuda.synchronize()
    for key in (*CLASSES, "fused"):
        assert torch.equal(out["staged", key], out["direct", key]), key


def _synthetic(ep, live, P=2, bp=128, nblk=6, seed=9):
    """Random gather operands on the card: entries (0, 2, 3, 3) per shard —
    the last a pad entry — slots of widths (128, 0, 128, 64) (one of zero
    width), per-entry live ext counts `live` (P, 4), every W-index below
    bp + its entry's count, the last slot's lanes pads (W-index 0, zero
    weight)."""
    rng = np.random.default_rng(seed)
    nb, K, ndev = 4, 4, nblk * bp
    live = np.asarray(live, np.int32)
    sidx = (rng.random((P, nb, K, bp))
            * (bp + live[:, :, None, None])).astype(np.int32)
    sw = rng.standard_normal((P, nb, K, 3, bp)).astype(np.float32)
    sidx[:, :, -1], sw[:, :, -1] = 0, 0.0
    bids = np.tile(np.array([0, 2, 3, 3], np.int32), (P, 1))
    ops = {"var_T": rng.standard_normal((P, NV, ndev)),
           "exts": rng.standard_normal((P, nb, NV, ep)),
           "slot_idx": sidx, "slot_w": sw,
           "scale": rng.standard_normal((P, nb, 1, bp)),
           "block_ids": bids, "slots": bs.slot_table((128, 0, 128, 64))}
    dev = {k: torch.from_numpy(np.ascontiguousarray(
        v if v.dtype != np.float64 else v.astype(np.float32))).cuda()
        for k, v in ops.items()}
    args = tuple(dev[k] for k in ("var_T", "exts", "slot_idx", "slot_w",
                                  "scale", "block_ids", "slots"))
    return args, torch.from_numpy(live).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("body", bs.GATHER_BODIES, indirect=True)
@pytest.mark.parametrize("ep", [128, "largest"])
def test_cuda_synthetic_pad_entries_and_widths(body, ep):
    """Pad entries, a zero-width slot, live counts from 0 to EP, at EP 128
    and at the largest EP the rule stages at bp 128; K2 with and without
    init and K3-gather, each against its plain version."""
    _card()
    if ep == "largest":
        ep = bs.GATHER_STAGE_MAX // 32 - 128
        assert bs.staged_bytes(128, ep) == bs.GATHER_STAGE_MAX
    live = [[0, ep, 7, 7], [ep // 2, 1, ep, ep]]
    args, cnt = _synthetic(ep, live)
    P, ndev = args[0].shape[0], args[0].shape[2]
    got = bs.sweep_blocks_gather(*args, ext_cnt=cnt)
    _assert_close(got, bs.sweep_blocks_gather_ref(*args))
    init = _init(P, 3 * NV, ndev, torch.float32).cuda()
    got = bs.sweep_blocks_gather(*args, init=init.clone(), ext_cnt=cnt)
    _assert_close(got, bs.sweep_blocks_gather_ref(*args, init=init.clone()))
    send = torch.randn((P, 2, 3 * NV, 8), device="cuda")
    dsts = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    g, r = bs.sweep_blocks_overlap_gather(*args, init.clone(), send, dsts,
                                          dsts, ext_cnt=cnt)
    g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
        *args, init.clone(), send, dsts, dsts)
    torch.cuda.synchronize()
    _assert_close(g, g_ref)
    assert torch.equal(r, r_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("w16", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_cuda_overlap_gather_peer_equals_loopback_bitwise(card_gather, op,
                                                          w16):
    """K3-gather's peer form against its loopback form on the same
    operands, the body the rule picks: the interior sweep and the pushed
    buffers bit for bit, over three launches on one transport."""
    from cfd_proxy_tpu_torch.parallel.transport import Peer

    m, state = card_gather(w16, op)
    body = bs.gather_body(m.bp, m.plans["interior"]["ext_idx"].shape[2], op,
                          fused=True)
    assert body == ("staged" if op == "gg" else "direct")
    args = (state["var_T"], *m._operands("interior", state["tables"]))
    kw = {"ext_cnt": m.plans["interior"]["ext_cnt"], "op": op}
    peer = Peer(m.dsts.numpy(), m.srcs.numpy(), rows=m.rows, s_max=m.s_max,
                dtype=torch.float32, device="cuda")
    try:
        for i in range(3):
            init = m.step(state, "nocomm") * (i + 1)
            send = m._pack(init, m.pack_scale)
            g_peer, r_peer = bs.sweep_blocks_overlap_gather(
                *args, init.clone(), send, None, None, peer=peer, **kw)
            g_loop, r_loop = bs.sweep_blocks_overlap_gather(
                *args, init.clone(), send, m.dsts, m.srcs, **kw)
            torch.cuda.synchronize()
            assert torch.equal(g_peer, g_loop)
            assert torch.equal(r_peer, r_loop)
    finally:
        peer.close()


@pytest.mark.cuda
@pytest.mark.parametrize("ep", [512, 1024, 1280])
def test_cuda_staged_resident_blocks(ep):
    """At the 96³ plans' tables (bp 512): K2's staged instances keep three
    CUDA blocks per SM at least, the fused gather instances (loopback and
    peer, f32 and bf16) as many as their table admits, and no instance
    spills more than the direct fused body (80 bytes)."""
    _card()
    from cfd_proxy_tpu_torch.ops import _cuda

    smem = bs.staged_bytes(512, ep)
    admit = min(SM_TOTAL // (smem + STATIC_SMEM + BLOCK_RESERVED), 4)
    for acc in (0, 1):
        for op in (0, 1):
            for w16, o16 in PRECISIONS:
                info = _cuda.kernel_info("cfd_sweep_gather_info", 1, acc, op,
                                         int(w16), int(o16), smem)
                assert info["blocks_per_sm"] >= 2, (acc, op, w16, o16, info)
                assert info["local_bytes"] <= 80, info
    for peer in (0, 1):
        for op in (0, 1):
            for w16, o16 in PRECISIONS:
                info = _cuda.kernel_info("cfd_overlap_gather_info", peer, 1,
                                         op, int(w16), int(o16), smem)
                assert info["blocks_per_sm"] >= admit, (peer, op, w16, info)
                assert info["local_bytes"] <= 80, info
