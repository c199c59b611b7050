"""The gather sweep's direct body: where no CUDA block's shared memory
holds the entry's table (or bp or EP is not a multiple of 4), K2 and K3's
gather form sweep kernel-sized chunks of an entry's lanes, two lanes 32
apart a thread, each thread's live slots one stream of items fetched two
ahead (csrc/sweep_common.cuh::sweep_chunk_direct), and read each slot
lane's sources from a point-major table of the entry's [own ‖ live ext]
columns that the wrapper builds in device memory first (`gather_table`,
csrc/sweep_gather.cu::cfd_gather_table), or, `direct_sources` "columns",
from var_T and exts as they lie.

On the CPU:

- the table's plain version (`gather_table_ref`) is the reference's block
  table [own ‖ exts] (`_block_compute`, blocksweep.py:391, on the JAX
  model's own `gather_exts` tables) point-major, bit for bit, on the JAX
  model's plans at P ∈ {1, 8}; `table_written` names each listed entry's
  own and live ext columns and no pad entry's;
- the direct body's item streams (`direct_items`: each CUDA block's lanes,
  each thread's lanes l and l + 32, slots live in its first lane, fetched
  two ahead) add every live (lane, slot) pair once, in slot order, and
  store every lane below bp once, at bp that are and are not multiples
  of 4, 32 and the block's 256 lanes, with odd, zero and non-monotone
  widths;
- a plain-torch form of the algorithm (`direct_sweep`: the table, its
  unwritten columns NaN, indexed by W-index) equals
  `sweep_blocks_gather_ref` bit for bit and the reference's gather kernel
  in interpret mode within 1e-6 of max|ref| (f32) or one bf16 ulp plus
  that (bf16 outputs), gg and flux, with and without init, f32 or bf16
  weights and outputs;
- the wrappers' choice: `gather_body` and `direct_sources` at the plans
  the rule keeps on the direct body, and no table built on CPU tensors.

The `cuda`-marked tests hold the table kernel to its plain version on the
columns it writes, every K2 and K3-gather direct instance (loopback and
peer) under both source layouts to its plain version and to each other
bit for bit, at bp that are not multiples of 4, and read each direct
instance's spills (none).  They import no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gather_direct.py -m cuda
"""

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops.plan import NV

torch.set_num_threads(1)

NVAR = 5
BF = "bfloat16"
TOL = 1e-6          # f32 kernels vs plain and the reference: FMA contraction
JAX_CASES = [(1, 128), (1, 256), (8, 128)]
CLASSES = ("bulk", "boundary", "interior")
PRECISIONS = [(False, False), (True, False), (False, True), (True, True)]
# the direct body's CUDA block, lanes a thread and fetch depth
# (csrc/sweep_common.cuh::kThreads, kDirectLanes, kDirectAhead)
THREADS, LANES, AHEAD = 128, 2, 2
CHUNK = THREADS * LANES


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def jax_gather(mesh, gvar):
    """(P, bp, meta_dtype) → (JAX gather model in interpret mode, its
    state, its plans in the port's arrays); built once."""
    cache = {}

    def get(P, bp, meta="float32"):
        key = (P, bp, meta)
        if key not in cache:
            import cfd_proxy_tpu.models.gradients_pallas as gp
            from cfd_proxy_tpu_torch.convert import plans_from_jax

            jm = gp.GreenGaussPallas(
                partition_mesh(mesh, P, ghost_layers=1), NVAR, bp=bp,
                interpret=True, kernel="gather", meta_dtype=meta)
            cache[key] = (jm, jm.distribute_state(gvar), plans_from_jax(jm))
        return cache[key]

    return get


def _t(a):
    if isinstance(a, torch.Tensor):
        return a
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))     # writable copy


def _port_args(arrays, var_T, cls):
    """(var_T, exts, slot_idx, slot_w, scale, block_ids, slots) of a class
    of JAX-model arrays, and its live ext counts, as the port loads them."""
    ca = arrays["classes"][cls]
    exts = bs.gather_exts(var_T, _t(ca["ext_idx"]))
    args = (var_T, exts, _t(ca["slot_idx"]), _t(ca["slot_w"]),
            _t(ca["scale"]), _t(ca["block_ids"]),
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


def direct_lane(lo, j):
    """The first lane of group position j of the direct body's CUDA block
    whose lanes start at lo: lanes l and l + 32 of run j // 32 of 64."""
    return lo + (j // 32) * 32 * LANES + j % 32


def direct_items(bp, widths, threads=THREADS, ahead=AHEAD):
    """The direct body's item streams as sweep_chunk_direct walks them:
    each CUDA block (lanes [lo, hi), CHUNK a block), each thread's groups
    (`direct_lane`) in order, each group's slots live in its first lane in
    slot order (one empty item for a group with none), fetched `ahead`
    items before they compute.  Returns the events of every thread in
    order: ("add", lane, k) where a lane adds slot k's terms, ("store",
    lane) where it writes its output."""
    K = len(widths)

    def live_from(lane, k):
        while k < K and lane >= widths[k]:
            k += 1
        return k

    events = []
    for lo in range(0, bp, CHUNK):
        hi = min(lo + CHUNK, bp)
        for t in range(threads):
            cur = {"j": t}
            cur["k"] = live_from(direct_lane(lo, t), 0)

            def fetch():
                lane = direct_lane(lo, cur["j"])
                item = (lane, cur["k"])
                if lane >= hi:
                    return item
                if cur["k"] < K:
                    cur["k"] = live_from(lane, cur["k"] + 1)
                    if cur["k"] < K:
                        return item
                cur["j"] += threads
                cur["k"] = live_from(direct_lane(lo, cur["j"]), 0)
                return item

            q = [fetch() for _ in range(ahead)]
            lane = q[0][0]
            if lane >= hi:
                continue
            while True:
                q.append(fetch())
                k = q[0][1]
                if k < K:
                    live = min(widths[k], hi)
                    events += [("add", lane + 32 * u, k)
                               for u in range(LANES)
                               if u == 0 or lane + 32 * u < live]
                if q[1][0] != lane:
                    events += [("store", lane + 32 * u) for u in range(LANES)
                               if lane + 32 * u < hi]
                    lane = q[1][0]
                    if lane >= hi:
                        break
                q.pop(0)
    return events


def direct_sweep(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                 ext_cnt, init=None, op="gg", out_dtype=None):
    """The direct body's algorithm in plain torch: the entry's point-major
    table (`gather_table_ref`), the columns the kernel does not write NaN
    (which a live lane must never read), every slot lane's eight sources
    one column of it by W-index, and the sweep's arithmetic
    (`_sweep_plain`, the plain versions' own)."""
    P, nb, _, ep = exts.shape
    bp = scale.shape[-1]
    tbl = bs.gather_table_ref(var_T, exts, block_ids, bp)  # (P, nb, W, NV)
    written = bs.table_written(block_ids, bp, ep, ext_cnt)
    tbl = torch.where(written[..., None], tbl,
                      torch.full_like(tbl, float("nan")))
    seen = tbl.transpose(2, 3)                             # (P, nb, NV, W)

    def terms(k, w, off, own):
        idx = slot_idx[:, :, k, None, :w].long().expand(P, nb, NV, w)
        return torch.gather(seen, 3, idx), slot_w[:, :, k, :, :w]

    return bs._sweep_plain(var_T, scale, block_ids, slots, init, terms, op,
                           out_dtype=bs._out_dtype(init, out_dtype))


def _synthetic(ep, live, P=2, bp=128, nblk=6, seed=9, device="cpu",
               widths=None):
    """Random gather operands: entries (0, 2, 3, 3) per shard — the last a
    pad entry — slots of widths (bp, 0, bp, bp // 2) (one of zero width; or
    `widths`), per-entry live ext counts `live` (P, 4), every W-index below
    bp + its entry's count, the last slot's lanes pads (W-index 0, zero
    weight)."""
    rng = np.random.default_rng(seed)
    nb, ndev = 4, nblk * bp
    widths = widths or (bp, 0, bp, bp // 2)
    K = len(widths)
    live = np.asarray(live, np.int32)
    sidx = (rng.random((P, nb, K, bp))
            * (bp + live[:, :, None, None])).astype(np.int32)
    sw = rng.standard_normal((P, nb, K, 3, bp)).astype(np.float32)
    sidx[:, :, -1], sw[:, :, -1] = 0, 0.0
    ops = {"var_T": rng.standard_normal((P, NV, ndev)),
           "exts": rng.standard_normal((P, nb, NV, ep)),
           "slot_idx": sidx, "slot_w": sw,
           "scale": rng.standard_normal((P, nb, 1, bp)),
           "block_ids": np.tile(np.array([0, 2, 3, 3], np.int32), (P, 1)),
           "slots": bs.slot_table(widths)}
    dev = {k: torch.from_numpy(np.ascontiguousarray(
        v if v.dtype != np.float64 else v.astype(np.float32))).to(device)
        for k, v in ops.items()}
    args = tuple(dev[k] for k in ("var_T", "exts", "slot_idx", "slot_w",
                                  "scale", "block_ids", "slots"))
    return args, torch.from_numpy(live).to(device)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_table_is_the_reference_block_table(jax_gather, P, bp):
    """gather_table_ref is the reference's block table [own ‖ exts]
    (`_block_compute`'s concatenate, blocksweep.py:391, on the JAX model's
    own ext tables from its `gather_exts`) with each column's NV values
    contiguous, bit for bit, every class; on CPU tensors `gather_table`
    returns it and counts no launch."""
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import gather_exts as jax_exts
    from cfd_proxy_tpu_torch.convert import state_from_jax

    jm, js, arrays = jax_gather(P, bp)
    var_np = state_from_jax(js)
    var_T = _t(var_np)
    for c in CLASSES:
        ca = arrays["classes"][c]
        ext_idx = np.asarray(ca["ext_idx"])
        ids = np.asarray(ca["block_ids"])
        want = []
        for d in range(P):
            ext = np.asarray(jax_exts(jnp.asarray(var_np[d]),
                                      jnp.asarray(ext_idx[d])))
            own = np.stack([var_np[d][:, b * bp:(b + 1) * bp]
                            for b in ids[d]])         # (nb, NV, bp)
            tbl = np.asarray(jnp.concatenate(
                [jnp.asarray(own), jnp.asarray(ext)], axis=2))
            want.append(np.swapaxes(tbl, 1, 2))         # (nb, W, NV)
        args, cnt = _port_args(arrays, var_T, c)
        before = bs.gather_table.launches
        got = bs.gather_table(var_T, args[1], args[5], bp, ext_cnt=cnt)
        assert bs.gather_table.launches == before
        np.testing.assert_array_equal(got.numpy(), np.stack(want),
                                      err_msg=c)
        assert torch.equal(got, bs.gather_table_ref(var_T, args[1],
                                                    args[5], bp))


def test_table_written_columns():
    """table_written: own columns and the first ext_cnt ext columns of
    every entry (all EP without counts, counts clamped to [0, EP]), none
    of a pad entry."""
    ids = torch.tensor([[0, 2, 3, 3], [1, 1, 1, 1]], dtype=torch.int32)
    cnt = torch.tensor([[0, 5, 9, 9], [-1, 3, 3, 3]], dtype=torch.int32)
    w = bs.table_written(ids, 4, 8, cnt)
    assert w.shape == (2, 4, 12) and w.dtype == torch.bool
    assert w.sum(2).tolist() == [[4, 9, 12, 0], [4, 0, 0, 0]]
    assert torch.equal(w[0, 1], torch.arange(12) < 9)
    assert bs.table_written(ids, 4, 8).sum(2).tolist() == [[12, 12, 12, 0],
                                                           [12, 0, 0, 0]]


@pytest.mark.parametrize("bp,widths", [
    (128, (128, 128, 0, 64)),
    (256, (256, 0, 253, 65, 256)),            # odd widths, non-monotone
    (512, (512, 384, 512, 128, 0, 511)),
    (130, (130, 2, 0, 129)),                  # bp not a multiple of 4
    (250, (250, 250, 33, 32)),
    (8190, (8190, 8190, 4096, 8190, 31)),     # not a multiple of 4 or 32
])
def test_direct_item_stream_adds_every_live_slot_once(bp, widths):
    """Every lane below bp adds exactly its live slots (lane < widths[k]),
    in slot order, then stores once; no lane at or past bp is touched."""
    events = direct_items(bp, list(widths))
    adds, stores = {}, {}
    for i, e in enumerate(events):
        if e[0] == "add":
            assert e[1] not in stores, e            # no add after the store
            adds.setdefault(e[1], []).append(e[2])
        else:
            assert e[1] not in stores, e
            stores[e[1]] = i
    assert sorted(stores) == list(range(bp))
    for lane in range(bp):
        assert adds.get(lane, []) == [k for k, w in enumerate(widths)
                                      if lane < w], lane


@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_direct_form_equals_plain_bitwise(jax_gather, P, bp, op, w16, o16):
    """The table indexed by W-index == sweep_blocks_gather_ref, every
    class, with and without init; the wrapper on CPU tensors is the plain
    version and builds no table, whichever sources it is given."""
    from cfd_proxy_tpu_torch.convert import state_from_jax

    jm, js, arrays = jax_gather(P, bp, BF if w16 else "float32")
    var_T = _t(state_from_jax(js))
    odt = torch.bfloat16 if o16 else torch.float32
    before = bs.gather_table.launches
    for c in CLASSES:
        args, cnt = _port_args(arrays, var_T, c)
        for seeded in (False, True):
            init = (_init(P, bs.out_rows(op), var_T.shape[2], odt)
                    if seeded else None)

            def run(fn, **kw):
                return fn(*args, init=None if init is None else init.clone(),
                          op=op, out_dtype=odt, **kw)

            got = run(direct_sweep, ext_cnt=cnt)
            ref = run(bs.sweep_blocks_gather_ref)
            assert got.dtype == odt and torch.equal(got, ref), (c, seeded)
            for sources in bs.DIRECT_SOURCES:
                assert torch.equal(run(bs.sweep_blocks_gather, ext_cnt=cnt,
                                       sources=sources), ref), (c, seeded)
    assert bs.gather_table.launches == before


@pytest.mark.parametrize("w16o16", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_direct_form_matches_jax_gather_kernel(jax_gather, P, bp, op,
                                               w16o16):
    """The direct form against the reference's gather kernel in interpret
    mode, shard by shard: the bulk plan without init, the boundary and
    interior plans with a random init; f32, or bf16 weights and output."""
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep
    from cfd_proxy_tpu_torch.convert import state_from_jax

    jm, js, arrays = jax_gather(P, bp, BF if w16o16 else "float32")
    var_np = state_from_jax(js)
    var_T = _t(var_np)
    odt, jdt = ((torch.bfloat16, jnp.bfloat16) if w16o16
                else (torch.float32, jnp.float32))
    rows = bs.out_rows(op)
    for c, seeded in (("bulk", False), ("boundary", True),
                      ("interior", True)):
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
        args, cnt = _port_args(arrays, var_T, c)
        got = direct_sweep(*args, cnt, init=init, op=op, out_dtype=odt)
        _assert_close(got, torch.stack(ref), c)


@pytest.mark.parametrize("bp", [128, 130, 250])
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_direct_form_synthetic_plans(bp, op):
    """Pad entries, a zero-width slot, odd widths, live counts from 0 to
    EP, at bp that are and are not multiples of 4: the direct form bit for
    bit the plain version, with and without init."""
    ep = 132
    args, cnt = _synthetic(ep, [[0, ep, 7, 7], [ep // 2, 1, ep, ep]], bp=bp,
                           widths=(bp, 0, bp - 3, 65, bp // 2))
    P, ndev = args[0].shape[0], args[0].shape[2]
    for init in (None, _init(P, bs.out_rows(op), ndev, torch.float32)):
        got = direct_sweep(*args, cnt, init=None if init is None
                           else init.clone(), op=op)
        ref = bs.sweep_blocks_gather_ref(
            *args, init=None if init is None else init.clone(), op=op)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("bp,ep,op,fused,body,sources", [
    (8192, 16768, "flux", False, "direct", "table"),  # two-shard 96³ bulk
    (8192, 10496, "flux", True, "direct", "table"),   # its interior, K3
    (8192, 10496, "gg", True, "quad", None),
    (512, 1024, "flux", True, "direct", "columns"),   # the fused flux form
    (512, 1280, "flux", False, "staged", None),
    (8192, 24576, "gg", False, "direct", "table"),    # past a quarter table
    (8190, 2688, "gg", False, "direct", "table"),     # bp not a multiple of 4
    (130, 132, "gg", False, "direct", "columns"),
    (4096, 1922, "gg", False, "direct", "table"),     # EP not a multiple of 4
])
def test_wrapper_choice_of_body(bp, ep, op, fused, body, sources):
    """The body the wrappers launch at the plans the rule keeps on the
    direct body (and beside them), and a plan's choice of the direct
    body's sources: the point-major table where the column-major table
    passes GATHER_STAGE_PAIR, unless the plan reads it less than
    DIRECT_TABLE_LANES lanes a column (a boundary plan of pad lanes)."""
    assert bs.gather_body(bp, ep, op, fused) == body
    if body == "direct":
        assert bs.direct_sources(bp, ep, 2.5) == sources
        assert bs.direct_sources(bp, ep, bs.DIRECT_TABLE_LANES) == sources
        assert bs.direct_sources(bp, ep, 0.4) == "columns"
        big = bs.staged_bytes(bp, ep) > bs.GATHER_STAGE_PAIR
        assert (sources == "table") == big


@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_lanes_per_column_counts_real_lanes(jax_gather, P, bp):
    """table_lanes_per_column: the nonzero-weight lanes within each slot's
    prefix, over the listed entries, per column the table holds (own and
    live ext), recounted from the reference's plan arrays; a port model
    makes each class's choice of sources from it where it loads the plan,
    keeps it beside the ext counts and hands it to the gather sweeps."""
    from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch

    jm, _, arrays = jax_gather(P, bp)
    tm = GreenGaussTorch.from_arrays(jm.parts, NVAR, arrays, device="cpu")
    for c in CLASSES:
        ca = arrays["classes"][c]
        sw = np.asarray(ca["slot_w"], np.float32)
        ids = np.asarray(ca["block_ids"])
        wks = [int(w) for w in ca["wks"]]
        cnt = bs.ext_counts(np.asarray(ca["slot_idx"]), bp)
        first = np.ones(ids.shape, bool)
        first[:, 1:] = ids[:, 1:] != ids[:, :-1]
        real = sum(int((sw[p, b, k, :, :w] != 0).any(axis=0).sum())
                   for p, b in zip(*np.nonzero(first))
                   for k, w in enumerate(wks))
        want = real / (int(first.sum()) * bp + int(cnt[first].sum()))
        got = bs.table_lanes_per_column(_t(sw), _t(ids), wks,
                                        torch.from_numpy(cnt))
        assert got == pytest.approx(want, rel=1e-12), c
        choice = bs.direct_sources(bp, int(ca["ep"]), want)
        assert tm.sources[c] == choice, c
        assert tm._gather_kw(c)["sources"] == choice, c


def test_gather_wrappers_check_sources():
    """Both gather wrappers take the direct body's sources as "columns"
    (their default) or "table", and refuse anything else."""
    from cfd_proxy_tpu_torch.utils.errors import CheckError

    args, cnt = _synthetic(128, [[0, 128, 7, 7], [64, 1, 128, 128]])
    P, ndev = args[0].shape[0], args[0].shape[2]
    init = _init(P, bs.out_rows("gg"), ndev, torch.float32)
    send = torch.zeros((P, 2, bs.out_rows("gg"), 8))
    dsts = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    calls = (lambda **kw: bs.sweep_blocks_gather(*args, ext_cnt=cnt, **kw),
             lambda **kw: bs.sweep_blocks_overlap_gather(
                 *args, init.clone(), send, dsts, dsts, ext_cnt=cnt,
                 **kw)[0])
    for call in calls:
        want = call()
        assert torch.equal(call(sources="table"), want)
        for bad in ("rows", None):
            with pytest.raises(CheckError, match="sources"):
                call(sources=bad)


def test_gather_table_checks_its_operands():
    """gather_table refuses operands of the wrong dtype or shape."""
    args, cnt = _synthetic(128, [[0, 128, 7, 7], [64, 1, 128, 128]])
    var_T, exts, *_, block_ids, _ = args
    with pytest.raises(Exception, match="exts"):
        bs.gather_table(var_T, exts.double(), block_ids, 128)
    with pytest.raises(Exception, match="block_ids"):
        bs.gather_table(var_T, exts, block_ids[:1], 128)
    with pytest.raises(Exception, match="ext_cnt"):
        bs.gather_table(var_T, exts, block_ids, 128, ext_cnt=cnt.long())


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture
def direct(monkeypatch):
    """Force the gather wrappers onto the direct body."""
    monkeypatch.setattr(bs, "gather_body", lambda *args, **kw: "direct")


def _counter(op, init, w16, o16, peer=False):
    return ("peer_" * peer + "flux_" * (op == "flux") + "init_" * init
            + bs._tag(w16, False, o16) + "direct_launches")


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [128, 8190])
def test_cuda_table_equals_plain_on_written_columns(bp):
    """The table kernel writes every listed entry's own and live ext
    columns as the plain version has them, bit for bit, and counts one
    launch (pad entries, an entry without ext columns, bp not a multiple
    of 4)."""
    _card()
    ep = 260
    args, cnt = _synthetic(ep, [[0, ep, 7, 7], [ep // 2, 1, ep, ep]], bp=bp,
                           device="cuda")
    var_T, exts, *_, block_ids, _ = args
    before = bs.gather_table.launches
    got = bs.gather_table(var_T, exts, block_ids, bp, ext_cnt=cnt)
    torch.cuda.synchronize()
    assert bs.gather_table.launches == before + 1
    want = bs.gather_table_ref(var_T, exts, block_ids, bp)
    mask = bs.table_written(block_ids, bp, ep, cnt).cuda()
    assert torch.equal(got[mask], want[mask])
    got = bs.gather_table(var_T, exts, block_ids, bp)      # all EP columns
    mask = bs.table_written(block_ids, bp, ep).cuda()
    assert torch.equal(got[mask], want[mask])


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [128, 130, 1000, 8190])
@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_cuda_direct_layouts_equal_plain_and_each_other(direct, bp, op, w16,
                                                        o16):
    """Every K2 direct instance (with and without init) and K3-gather's
    (loopback and peer) under both source layouts: within the bounds of
    the plain version, the two layouts bit for bit, each launch counted
    under its direct name and the table build once where it reads the
    table; bp not a multiple of 4 included."""
    from cfd_proxy_tpu_torch.parallel.transport import Peer

    _card()
    ep = 132
    args, cnt = _synthetic(ep, [[0, ep, 7, 7], [ep // 2, 1, ep, ep]], bp=bp,
                           device="cuda", widths=(bp, 0, bp - 3, 65, bp // 2))
    args = (*args[:3], args[3].to(torch.bfloat16) if w16 else args[3],
            *args[4:])
    P, ndev = args[0].shape[0], args[0].shape[2]
    odt = torch.bfloat16 if o16 else torch.float32
    rows = bs.out_rows(op)
    init = _init(P, rows, ndev, odt).cuda()
    send = torch.randn((P, 2, rows, 8), device="cuda").to(odt)
    dsts = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    tr = Peer(dsts.numpy(), dsts.numpy(), rows=rows, s_max=8, dtype=odt,
              device="cuda")
    try:
        out = {}
        for mode in ("table", "columns"):
            k2 = bs.sweep_blocks_gather
            k3 = bs.sweep_blocks_overlap_gather
            kw = {"op": op, "ext_cnt": cnt, "sources": mode}
            calls = {
                (k2, False, False): lambda: k2(*args, out_dtype=odt, **kw),
                (k2, True, False): lambda: k2(*args, init=init.clone(),
                                              **kw),
                (k3, False, False): lambda: k3(*args, init.clone(), send,
                                               dsts, dsts, **kw)[0],
                (k3, False, True): lambda: k3(*args, init.clone(), send,
                                              None, None, peer=tr,
                                              **kw)[0]}
            for (fn, seeded, peer), run in calls.items():
                attr = _counter(op, seeded, w16, o16, peer)
                before = getattr(fn, attr), bs.gather_table.launches
                out[mode, fn.__name__, seeded, peer] = run()
                torch.cuda.synchronize()
                assert getattr(fn, attr) == before[0] + 1, attr
                assert (bs.gather_table.launches
                        == before[1] + (mode == "table")), (attr, mode)
        refs = {
            ("sweep_blocks_gather", False, False):
                bs.sweep_blocks_gather_ref(*args, op=op, out_dtype=odt),
            ("sweep_blocks_gather", True, False):
                bs.sweep_blocks_gather_ref(*args, init=init.clone(), op=op)}
        g_ref, _ = bs.sweep_blocks_overlap_gather_ref(
            *args, init.clone(), send, dsts, dsts, op=op)
        for peer in (False, True):
            refs["sweep_blocks_overlap_gather", False, peer] = g_ref
        for key, ref in refs.items():
            _assert_close(out[("table", *key)], ref, key)
            assert torch.equal(out[("table", *key)],
                               out[("columns", *key)]), key
    finally:
        tr.close()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_cuda_direct_table_at_the_two_shard_ep(direct, op):
    """At bp 8192 with the two-shard 96³ bulk EP (16768: a quarter table
    passes a block under flux), K2 and K3-gather direct from the table bit
    for bit the column-major reads, and K2 within the plain version's
    bounds."""
    _card()
    bp, ep = 8192, 16768
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           device="cuda")
    init = _init(1, bs.out_rows(op), args[0].shape[2], torch.float32).cuda()
    send = torch.randn((1, 1, bs.out_rows(op), 8), device="cuda")
    dsts = torch.zeros((1, 1), dtype=torch.int32)
    out = {}
    for mode in ("table", "columns"):
        kw = {"op": op, "ext_cnt": cnt, "sources": mode}
        out[mode] = (bs.sweep_blocks_gather(*args, **kw),
                     bs.sweep_blocks_overlap_gather(
                         *args, init.clone(), send, dsts, dsts, **kw)[0])
    torch.cuda.synchronize()
    _assert_close(out["table"][0], bs.sweep_blocks_gather_ref(*args, op=op))
    for a, b in zip(out["table"], out["columns"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fused,peer", [(False, False), (True, False),
                                        (True, True)])   # K2 has no peer
def test_cuda_direct_instances_spill_nothing(fused, peer):
    """Every direct instance (K2 with and without init, K3-gather loopback
    and peer; gg and flux; f32 and bf16 weights and outputs) keeps its
    values in registers: no local memory; the table kernel too."""
    from cfd_proxy_tpu_torch.ops import _cuda

    _card()
    code = bs.GATHER_BODY_CODES["direct"]
    for op in (0, 1):
        for w16 in (0, 1):
            for o16 in (0, 1):
                for acc in ((0,) if fused else (0, 1)):
                    f = (_cuda.kernel_info("cfd_overlap_gather_info",
                                           int(peer), code, op, w16, o16, 0,
                                           128) if fused else
                         _cuda.kernel_info("cfd_sweep_gather_info", code,
                                           acc, op, w16, o16, 0, 128))
                    assert f["local_bytes"] == 0, (op, w16, o16, acc, f)
                    assert f["blocks_per_sm"] >= 4, f
    assert _cuda.kernel_info("cfd_gather_table_info")["local_bytes"] == 0
