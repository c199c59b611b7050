"""The gather sweep's staged, cluster and quad bodies: K2 and K3's gather
form stage each listed entry's [own ‖ live ext] table in shared memory
(csrc/sweep_common.cuh::sweep_entry_staged) where `gather_body` picks it
(K3's flux form keeps the direct body there), split it over a cluster of
two CUDA blocks, one float4 plane each (sweep_entry_cluster), where it
passes two blocks an SM but half of it fits one, and over a cluster of
four, two variables each (sweep_entry_quad), where half passes a block but
a quarter fits; K3's cluster launches pad their push region to whole
clusters (csrc/sweep_overlap.cu).

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
- so does a plain-torch form of the cluster algorithm (block r stages
  plane r at the kernel's offsets and sweeps its 64-lane runs of lanes,
  two neighbouring lanes a thread, reading its own plane and its
  peer's), on the JAX plans and on synthetic plans with pad entries and
  entries without ext columns at bp 128 and at the 96³ one-shard plan's
  bp 8192, and with odd slot widths that split a lane pair, at bp 128,
  196 and 8132 (the last two end in a 4-lane run tail); the two blocks'
  lanes split every slot prefix in half;
- so does a plain-torch form of K3-gather's cluster launch, grid and
  all (`fused_cluster_grid`: the push region padded to whole clusters,
  each CUDA block's (entry, rank) or push chunk, the pieces the first
  128 threads of a push block copy, in the loopback and the peer form),
  against
  `sweep_blocks_overlap_gather_ref`, grad and recv bit for bit, on the JAX
  plans and on synthetic plans at bp 4096 / EP 1920 and bp 8192 / EP 2688,
  and against the JAX fused kernel in interpret mode;
- so does a plain-torch form of the quad algorithm (`quad_sweep`: block
  r stages variables 2r and 2r+1; under gg it sweeps every lane for its
  six rows from its own plane, the other variables NaN; under flux it
  sweeps every fourth 64-lane run through all four planes), on the JAX
  plans in every precision and on synthetic plans at bp 8192 with the
  two-shard 96³ plans' EP (10496, 16768), with odd widths that split a
  lane group; the four blocks' lanes (every lane in each under gg, a
  quarter of every prefix under flux) and item streams; K3-gather's quad
  launch (`fused_quad`: the push region padded to whole clusters of four,
  one to three pad blocks) against `sweep_blocks_overlap_gather_ref`;
- the fixed body rule at both edges of each body, the cluster's and quad
  body's thread counts and the shared-memory fit at the 96³ benchmark
  shapes, from the numbers alone, and the fused kernel's bodies.

The `cuda`-marked tests hold every K2 and every K3-gather instance
(loopback and peer) under all four bodies to its plain version, with pad
entries, zero-width slots, EP = 128 and the largest EP the rule stages;
the bodies against each other and K3-gather-peer against the loopback
K3-gather bit for bit; every K2 and K3-gather instance on the cluster body
at bp 8192, both thread counts (K3-gather loopback and peer), also with
lane pairs split by odd widths and at bp 8132, against the direct body
bit for bit; every K2 and K3-gather instance on the quad body at bp 8192
with the two-shard EP, both thread counts, against the direct body bit for
bit; operands off a lane group refused; peer cluster and quad launches
whose push blocks outnumber the SMs; and the resident blocks per SM of the
staged, cluster and quad instances.  They import no JAX:

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


def straddle_widths(bp):
    """Slot widths (bp, 0, bp - 3, 65): two odd widths, each ending inside
    a lane pair of the cluster body (lanes bp - 4, bp - 3 and 64, 65: the
    first lane live, the second not)."""
    return (bp, 0, bp - 3, 65)


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


# the cluster body's CUDA blocks, lanes a thread and lane runs
# (csrc/sweep_common.cuh::kClusterCtas, kClusterPair, kClusterRun)
CTAS, PAIR = 2, 2
RUN = 32 * PAIR


def cluster_pairs(bp, rank, threads):
    """The first lane of each pair CUDA block `rank` of a cluster sweeps,
    per thread in the kernel's order: pair position j = t, t + threads, ...
    of thread t is lanes l and l + 1, l = ((j // 32)·CTAS + rank)·RUN +
    (j % 32)·PAIR, until l passes bp (a multiple of 4, so a pair never
    straddles it)."""
    out = []
    for t in range(threads):
        firsts, j = [], t
        while (lane := cluster_pairs_lane(j, rank)) < bp:
            firsts.append(lane)
            j += threads
        out.append(firsts)
    return out


def cluster_lanes(bp, rank, threads):
    """Every lane CUDA block `rank` sweeps, thread by thread in the
    kernel's order (`cluster_pairs`, both lanes of each pair)."""
    return [lane + h for firsts in cluster_pairs(bp, rank, threads)
            for lane in firsts for h in range(PAIR)]


# items of a thread's stream fetched ahead of the one it computes in the
# cluster body (csrc/sweep_common.cuh::kClusterAhead)
AHEAD = 2


def cluster_items(bp, widths, rank, threads, ahead=AHEAD):
    """The cluster body's item stream, as sweep_pairs_cluster walks it in
    each thread of CUDA block `rank`: the thread's pairs (`cluster_pairs`)
    in order, each pair's slots live in its first lane in slot order (one
    empty item for a pair with none), fetched `ahead` items before they
    compute.  Returns the events of every thread in order: ("add", lane, k)
    where a lane adds slot k's terms, ("store", lane) where it writes its
    output."""
    return lane_items(bp, widths, lambda j: cluster_pairs_lane(j, rank),
                      PAIR, threads, ahead)


def lane_items(bp, widths, lane_of, group, threads, ahead=AHEAD):
    """The item stream of a body whose threads sweep groups of `group`
    neighbouring lanes, group position j of a thread starting at lane
    lane_of(j) (sweep_pairs_cluster, sweep_items_quad): `cluster_items`'
    events, a group entering slot k where its first lane is live and each
    further lane adding only where it is live too."""
    K = len(widths)

    def live_from(lane, k):
        while k < K and lane >= widths[k]:
            k += 1
        return k

    events = []
    for t in range(threads):
        cur = {"j": t}
        cur["k"] = live_from(lane_of(cur["j"]), 0)

        def fetch():
            lane = lane_of(cur["j"])
            item = (lane, cur["k"])
            if lane >= bp:
                return item
            if cur["k"] < K:
                cur["k"] = live_from(lane, cur["k"] + 1)
                if cur["k"] < K:
                    return item
            cur["j"] += threads
            cur["k"] = live_from(lane_of(cur["j"]), 0)
            return item

        q = [fetch() for _ in range(ahead)]
        lane = q[0][0]
        if lane >= bp:
            continue
        while True:
            q.append(fetch())
            k = q[0][1]
            if k < K:
                events += [("add", lane + u, k) for u in range(group)
                           if u == 0 or lane + u < widths[k]]
            if q[1][0] != lane:
                events += [("store", lane + u) for u in range(group)]
                lane = q[1][0]
                if lane >= bp:
                    break
            q.pop(0)
    return events


def cluster_pairs_lane(j, rank):
    """The first lane of pair position j of CUDA block `rank`
    (csrc/sweep_common.cuh::cluster_lane)."""
    return ((j // 32) * CTAS + rank) * RUN + (j % 32) * PAIR


def cluster_planes(var_T, exts, block_ids, ext_cnt, bp):
    """What each CUDA block of the cluster stages for every listed entry:
    plane r (P, nb, 4, bp + EP) holds rows 4r..4r+3 of var_T's own columns
    and of the entry's first ext_cnt ext columns rounded up to whole
    quads, read at the kernel's flat offsets ((p·NV + 4r)·ndev + base, and
    (g·NV + 4r)·EP); the columns it does not stage are NaN."""
    P, nb, _, ep = exts.shape
    ndev = var_T.shape[2]
    flat_v, flat_e = var_T.reshape(-1), exts.reshape(-1)
    planes = torch.full((CTAS, P, nb, 4, bp + ep), float("nan"))
    for r in range(CTAS):
        for p in range(P):
            for b in range(nb):
                g = p * nb + b
                base = int(block_ids[p, b]) * bp
                quads = (min(max(int(ext_cnt[p, b]), 0), ep) + 3) // 4
                for u in range(4):
                    row = (p * NV + 4 * r + u) * ndev + base
                    planes[r, p, b, u, :bp] = flat_v[row:row + bp]
                    row = (g * NV + 4 * r + u) * ep
                    planes[r, p, b, u, bp:bp + 4 * quads] = \
                        flat_e[row:row + 4 * quads]
    return planes


def cluster_sweep(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                  ext_cnt, init=None, op="gg", out_dtype=None, threads=256):
    """The cluster body's algorithm in plain torch: block r of each entry's
    cluster stages plane r (`cluster_planes`) and sweeps the lanes
    `cluster_lanes` gives it, resolving each W-index into its own plane
    (local) and the other block's (peer): variables 0-3 from plane 0, 4-7
    from plane 1, whichever block holds it.  Each block's sweep runs the
    plain versions' arithmetic (`_sweep_plain`) on the table as it sees it;
    a lane's result is taken from the block that owns it."""
    P, nb, K, bp = slot_idx.shape
    planes = cluster_planes(var_T, exts, block_ids, ext_cnt, bp)
    outs = []
    for rank in range(CTAS):
        local, peer = planes[rank], planes[rank ^ 1]
        lo, hi = (local, peer) if rank == 0 else (peer, local)
        seen = torch.cat([lo, hi], dim=2)           # (P, nb, NV, bp + EP)

        def terms(k, w, off, own, seen=seen):
            idx = slot_idx[:, :, k, None, :w].long().expand(P, nb, NV, w)
            return torch.gather(seen, 3, idx), slot_w[:, :, k, :, :w]

        outs.append(bs._sweep_plain(
            var_T, scale, block_ids, slots,
            None if init is None else init.clone(), terms, op,
            out_dtype=bs._out_dtype(init, out_dtype)))
    owner = torch.zeros(bp, dtype=torch.long)
    owner[cluster_lanes(bp, 1, threads)] = 1
    lane_of_col = torch.arange(var_T.shape[2]) % bp
    return torch.where(owner[lane_of_col] == 0, outs[0], outs[1])


# the quad body's CUDA blocks and lanes a thread per op
# (csrc/sweep_common.cuh::kQuadCtas, kQuadLanesGG, kQuadLanesFlux)
QUAD = 4
QUAD_LANES = {"gg": 4, "flux": 2}


def quad_lane(j, rank, op):
    """The first lane of lane group j of CUDA block `rank` of a quad
    cluster (QuadGG::lane, QuadFlux::lane): gg sweeps every lane in every
    block, groups of four; flux splits the lanes, run (j // 32)·QUAD + rank
    of the entry's runs of 32 groups of two."""
    L = QUAD_LANES[op]
    if op == "gg":
        return L * j
    return ((j // 32) * QUAD + rank) * (32 * L) + (j % 32) * L


def quad_lanes(bp, rank, op, threads):
    """Every lane CUDA block `rank` of a quad cluster sweeps, thread by
    thread in the kernel's order (group positions t, t + threads, ...)."""
    L, out = QUAD_LANES[op], []
    for t in range(threads):
        j = t
        while (lane := quad_lane(j, rank, op)) < bp:
            out += range(lane, lane + L)
            j += threads
    return out


def quad_planes(var_T, exts, block_ids, ext_cnt, bp):
    """What each CUDA block of a quad cluster stages for every listed
    entry: plane r (P, nb, 2, bp + EP) holds rows 2r and 2r+1 of var_T's
    own columns and of the entry's first ext_cnt ext columns rounded up to
    whole quads, read at the kernel's flat offsets ((p·NV + 2r)·ndev +
    base, and (g·NV + 2r)·EP); the columns it does not stage are NaN."""
    P, nb, _, ep = exts.shape
    ndev = var_T.shape[2]
    flat_v, flat_e = var_T.reshape(-1), exts.reshape(-1)
    planes = torch.full((QUAD, P, nb, 2, bp + ep), float("nan"))
    for r in range(QUAD):
        for p in range(P):
            for b in range(nb):
                g = p * nb + b
                base = int(block_ids[p, b]) * bp
                quads = (min(max(int(ext_cnt[p, b]), 0), ep) + 3) // 4
                for u in range(2):
                    row = (p * NV + 2 * r + u) * ndev + base
                    planes[r, p, b, u, :bp] = flat_v[row:row + bp]
                    row = (g * NV + 2 * r + u) * ep
                    planes[r, p, b, u, bp:bp + 4 * quads] = \
                        flat_e[row:row + 4 * quads]
    return planes


def quad_sweep(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
               ext_cnt, init=None, op="gg", out_dtype=None, threads=512):
    """The quad body's algorithm in plain torch: block r of each entry's
    cluster stages plane r (`quad_planes`).  gg: block r sees its own
    plane alone (the other six variables NaN, which its rows never read),
    sweeps every lane and owns the rows d·NV + 2r + u.  flux: every block
    sees the four planes (its own and, through distributed shared memory,
    the other three), sweeps the lanes `quad_lanes` gives it and owns
    them.  Each block runs the plain versions' arithmetic (`_sweep_plain`)
    on the table as it sees it; an output element is taken from the block
    that owns it."""
    P, nb, K, bp = slot_idx.shape
    planes = quad_planes(var_T, exts, block_ids, ext_cnt, bp)
    ndev = var_T.shape[2]
    rows = bs.out_rows(op)
    odt = bs._out_dtype(init, out_dtype)
    out = None
    for rank in range(QUAD):
        if op == "gg":
            seen = torch.full((P, nb, NV, bp + exts.shape[3]), float("nan"))
            seen[:, :, 2 * rank:2 * rank + 2] = planes[rank]
        else:
            seen = torch.cat(list(planes), dim=2)     # (P, nb, NV, bp + EP)

        def terms(k, w, off, own, seen=seen):
            idx = slot_idx[:, :, k, None, :w].long().expand(P, nb, NV, w)
            return torch.gather(seen, 3, idx), slot_w[:, :, k, :, :w]

        res = bs._sweep_plain(var_T, scale, block_ids, slots,
                              None if init is None else init.clone(), terms,
                              op, out_dtype=odt)
        own = torch.zeros((rows, ndev), dtype=torch.bool)
        if op == "gg":
            for d in range(3):
                own[d * NV + 2 * rank:d * NV + 2 * rank + 2] = True
        else:
            mine = torch.zeros(bp, dtype=torch.bool)
            mine[quad_lanes(bp, rank, op, threads)] = True
            own[:] = mine[torch.arange(ndev) % bp]
        out = res if out is None else torch.where(own, res, out)
    return out


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
        assert tm.sources[c] in bs.DIRECT_SOURCES
        assert tm._gather_kw(c) == {"ext_cnt": cnt, "sources": tm.sources[c]}
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
# EP 1024 and 1280), at the AUTO block size (4096, EP 1920: one staged
# block per SM) and at bp 8192 (EP 2688 at one shard; at two shards 16768
# bulk and boundary, 10496 interior), the card tests' bp 128, and the
# rule's edges: the largest table two blocks of an SM hold, the largest
# half-table and the largest quarter-table one block holds
PAIR_MAX = bs.GATHER_STAGE_PAIR // 32           # columns of the largest
HALF_MAX = 2 * (bs.GATHER_STAGE_MAX // 32)
QUAD_MAX = 4 * (bs.GATHER_STAGE_MAX // 32)
RULE_CASES = [
    (512, 512, "staged"), (512, 1024, "staged"), (512, 1280, "staged"),
    (4096, 1920, "cluster"), (8192, 2560, "cluster"), (128, 128, "staged"),
    (8192, 2688, "cluster"),
    (512, PAIR_MAX - 512, "staged"), (512, PAIR_MAX - 508, "cluster"),
    (512, HALF_MAX - 512, "cluster"), (512, HALF_MAX - 508, "quad"),
    (8192, 16768, "quad"), (8192, 10496, "quad"),
    (512, QUAD_MAX - 512, "quad"), (512, QUAD_MAX - 508, "direct"),
    (8190, 2688, "direct"), (8192, 2686, "direct"),
    (8192, 16766, "direct"), (128, 130, "direct"), (126, 128, "direct")]


@pytest.mark.parametrize("bp,ep,body", RULE_CASES)
def test_gather_body_rule(bp, ep, body):
    """The fixed rule, where bp and EP allow 16-byte loads: staged where
    two staged blocks fit one SM's shared memory, else cluster where half
    the table fits one block, else quad where a quarter does (op gg); else
    direct.  K3's gather form follows it (its flux form keeps the direct
    body where the rule says staged); flux keeps the direct body where it
    says quad, in K2 and K3."""
    assert bs.staged_bytes(bp, ep) == NV * (bp + ep) * 4
    assert bs.cluster_bytes(bp, ep) == NV * (bp + ep) * 2
    assert bs.quad_bytes(bp, ep) == NV * (bp + ep)
    assert bs.gather_body(bp, ep) == body
    assert bs.gather_body(bp, ep, "gg", fused=True) == body
    assert bs.gather_body(bp, ep, "flux", fused=True) == \
        ("direct" if body in ("staged", "quad") else body)
    assert bs.gather_body(bp, ep, "flux") == \
        ("direct" if body == "quad" else body)
    aligned = bp % 4 == 0 and ep % 4 == 0
    pair = 2 * (bs.staged_bytes(bp, ep) + STATIC_SMEM + BLOCK_RESERVED) \
        <= SM_TOTAL
    half = bs.cluster_bytes(bp, ep) + STATIC_SMEM <= SM_SMEM
    quarter = bs.quad_bytes(bp, ep) + STATIC_SMEM <= SM_SMEM
    assert (body == "staged") == (pair and aligned)
    assert (body == "cluster") == (half and aligned and not pair)
    assert (body == "quad") == (quarter and aligned and not half)
    if body == "quad":        # one block an SM, where the rule picks it:
        # 512 threads, or fewer where bp has fewer 128-lane runs
        assert 2 * (bs.quad_bytes(bp, ep) + STATIC_SMEM + BLOCK_RESERVED) \
            > SM_TOTAL
        assert bs.quad_threads(bp, ep) == max(128, min(512, 32 * -(-bp
                                                                 // 128)))
    if body == "cluster":     # 512 threads an SM: one block of 512 or two
        per_sm = SM_TOTAL // (bs.cluster_bytes(bp, ep) + STATIC_SMEM
                              + BLOCK_RESERVED)
        assert bs.cluster_threads(bp, ep) == max(
            128, min(512 // min(per_sm, 2), 32 * -(-bp // 128)))


@pytest.mark.parametrize("bp,ep", [(512, 1024), (128, 128), (8192, 2560),
                                   (4096, 1920)])
def test_fused_flux_keeps_the_direct_body(bp, ep):
    """K3's gather form takes K2's rule in its gg form: staged where two
    staged blocks fit an SM, else the cluster body (one staged block per
    SM at bp 4096 no more); its flux form keeps the direct body where the
    rule says staged, which the staged one did not beat at bp 512, and
    takes the cluster body past it; K2 follows the rule in both ops."""
    rule = bs.gather_body(bp, ep)
    pair = bs.staged_bytes(bp, ep) <= bs.GATHER_STAGE_PAIR
    assert rule == ("staged" if pair else "cluster")
    assert bs.gather_body(bp, ep, "gg", fused=True) == rule
    assert bs.gather_body(bp, ep, "flux") == rule
    assert bs.gather_body(bp, ep, "flux", fused=True) == \
        ("direct" if pair else "cluster")
    assert set(bs.GATHER_BODIES) == {"staged", "cluster", "quad", "direct"}


@pytest.mark.parametrize("bp,ep", [(8192, 16768), (8192, 10496),
                                   (512, QUAD_MAX - 512)])
def test_flux_keeps_the_direct_body_past_half_a_block(bp, ep):
    """Where half the table passes a block and a quarter fits, gg (K2 and
    K3-gather) takes the quad body and flux keeps the direct body, in K2
    and K3: its quad form, which splits the lanes and reads three of its
    four planes through distributed shared memory, took 0.99-1.39x the
    direct body's time at the two-shard 96³ plans at bp 8192 (H100)."""
    assert bs.gather_body(bp, ep) == "quad"
    assert bs.gather_body(bp, ep, "gg", fused=True) == "quad"
    assert bs.gather_body(bp, ep, "flux") == "direct"
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
    # bp 8192 (EP 2688): 340 KB passes one block; each cluster half, 170
    # KB, takes one block per SM
    large = bs.cluster_bytes(8192, 2688)
    assert bs.staged_bytes(8192, 2688) // 1024 == 340 and large // 1024 == 170
    assert SM_TOTAL // (large + STATIC_SMEM + BLOCK_RESERVED) == 1
    # two shards at bp 8192 (EP 16768 and 10496): half the table (390 and
    # 292 KB) passes one block, each quad quarter (195 and 146 KB) takes one
    # block per SM
    for ep, kb in ((16768, 195), (10496, 146)):
        assert bs.cluster_bytes(8192, ep) > bs.GATHER_STAGE_MAX
        quarter = bs.quad_bytes(8192, ep)
        assert quarter // 1024 == kb
        assert SM_TOTAL // (quarter + STATIC_SMEM + BLOCK_RESERVED) == 1


@pytest.mark.parametrize("threads", [256, 512])
@pytest.mark.parametrize("bp", [128, 196, 512, 4096, 8192])
def test_cluster_lanes_split_every_prefix(bp, threads):
    """The two CUDA blocks of a cluster sweep every lane of the entry once
    between them, half of every 128-lane-aligned prefix each (the slot
    widths are multiples of 128), a thread two neighbouring lanes and a
    warp's 32 threads one run of 64 consecutive lanes at each step; bp 196
    ends in an odd run tail (lanes 192-195, the fourth run: block 1's)."""
    lanes = [cluster_lanes(bp, r, threads) for r in range(CTAS)]
    assert sorted(lanes[0] + lanes[1]) == list(range(bp))
    for w in range(2 * RUN, bp + 1, 2 * RUN):
        for r in range(CTAS):
            assert sum(lane < w for lane in lanes[r]) == w // 2, (w, r)
    tail = bp % RUN
    if tail:
        assert set(range(bp - tail, bp)) <= set(lanes[(bp // RUN) % CTAS])
    for r in range(CTAS):
        pairs = cluster_pairs(bp, r, threads)
        assert pairs[0][0] == r * RUN
        for step in range(max(map(len, pairs))):
            for w in range(0, threads, 32):
                warp = [p[step] for p in pairs[w:w + 32] if len(p) > step]
                if warp:
                    assert warp[0] % RUN == 0 and (warp[0] // RUN) % CTAS == r
                    assert warp == list(range(warp[0], warp[0] + PAIR
                                              * len(warp), PAIR))


@pytest.mark.parametrize("ahead", [1, AHEAD, 3])
@pytest.mark.parametrize("threads", [256, 512])
@pytest.mark.parametrize("bp,widths", [
    (128, (128, 0, 128, 64)), (128, straddle_widths(128)),
    (196, straddle_widths(196)), (8192, (8192, 0, 8192, 4096, 2048)),
    (8132, straddle_widths(8132))])
def test_cluster_item_stream_adds_every_live_slot_once(bp, widths, threads,
                                                       ahead):
    """The cluster body's item stream, fetched 1-3 items ahead across pair
    boundaries: every lane adds slot k exactly where it is live (lane <
    widths[k]: a pair split by an odd width adds the first lane's terms
    alone), in slot order, and writes its output once, after its last add;
    a lane without a live slot still writes it."""
    adds, stores = {}, {}
    for rank in range(CTAS):
        for n, ev in enumerate(cluster_items(bp, widths, rank, threads,
                                             ahead)):
            if ev[0] == "add":
                assert ev[1] not in stores, ev
                adds.setdefault(ev[1], []).append(ev[2])
            else:
                assert ev[1] not in stores, ev
                stores[ev[1]] = n
    assert sorted(stores) == list(range(bp))
    for lane in range(bp):
        want = [k for k, w in enumerate(widths) if lane < w]
        assert adds.get(lane, []) == want, lane


@pytest.mark.parametrize("w16,o16", [(False, False), (True, True)])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_cluster_form_equals_plain_bitwise(jax_gather, P, bp, op, w16, o16):
    """Two blocks each staging one plane, each sweeping its lanes through
    its own plane and its peer's == sweep_blocks_gather_ref bit for bit,
    every class of the JAX model's plans, with and without init."""
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

            got = run(cluster_sweep, ext_cnt=cnt)
            ref = run(bs.sweep_blocks_gather_ref)
            assert got.dtype == odt and torch.equal(got, ref), (c, seeded)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("bp,ep,straddle", [
    (128, 128, False), (8192, 2688, False), (128, 128, True),
    (196, 132, True), (8132, 2688, True)])
def test_cluster_form_synthetic_plans(bp, ep, straddle, op, init):
    """The cluster form on synthetic plans with pad entries, a zero-width
    slot and entries without ext columns (live count 0) or with all EP,
    at bp 128 and at the 96³ one-shard plan's bp 8192 and EP 2688, both
    thread counts: bit for bit the plain version; and with odd slot widths
    that split a lane pair (`straddle_widths`), at bp 128 and at bp 196
    and 8132, whose last run of lanes is a 4-lane tail."""
    live = [[0, ep, 7, 7]] if bp > 196 else [[0, ep, 7, 7], [ep // 2, 0, ep,
                                                             ep]]
    args, cnt = _synthetic(ep, live, P=len(live), bp=bp, device="cpu",
                           widths=straddle_widths(bp) if straddle else None)
    P, ndev = args[0].shape[0], args[0].shape[2]
    seed = _init(P, bs.out_rows(op), ndev, torch.float32) if init else None
    ref = bs.sweep_blocks_gather_ref(
        *args, init=None if seed is None else seed.clone(), op=op)
    assert float(ref.abs().max()) > 0
    for threads in (256, 512):
        got = cluster_sweep(*args, cnt, init=None if seed is None
                            else seed.clone(), op=op, threads=threads)
        assert torch.equal(got, ref), threads


@pytest.mark.parametrize("threads", [256, 512])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("bp", [128, 196, 512, 8192, 8132])
def test_quad_lanes_split_every_prefix(bp, op, threads):
    """The quad cluster's four CUDA blocks: under gg each sweeps every lane
    of the entry once (its own six rows), a warp 128 consecutive lanes at
    each step; under flux they sweep every lane once between them, a
    quarter of every 256-lane-aligned prefix each (the slot widths are
    multiples of 128: every 128-aligned prefix is split as evenly as runs
    of 64 allow), a warp one run of 64 lanes at each step; bp 196 and 8132
    end in a 4-lane tail."""
    lanes = [quad_lanes(bp, r, op, threads) for r in range(QUAD)]
    L = QUAD_LANES[op]
    if op == "gg":
        for r in range(QUAD):
            assert sorted(lanes[r]) == list(range(bp)), r
    else:
        assert sorted(sum(lanes, [])) == list(range(bp))
        run = 32 * L
        for w in range(QUAD * run, bp + 1, QUAD * run):
            for r in range(QUAD):
                assert sum(lane < w for lane in lanes[r]) == w // QUAD, (w, r)
        for w in range(128, bp + 1, 128):    # every prefix a slot can have
            got = [sum(lane < w for lane in lanes[r]) for r in range(QUAD)]
            assert sum(got) == w and max(got) - min(got) <= run, (w, got)
        if bp % run:
            assert set(range(bp - bp % run, bp)) <= set(
                lanes[(bp // run) % QUAD])
    for r in range(QUAD):
        for w in range(0, threads, 32):      # a warp's groups, step by step
            step = 0
            while True:
                firsts = [quad_lane(t + step * threads, r, op)
                          for t in range(w, w + 32)]
                firsts = [f for f in firsts if f < bp]
                if not firsts:
                    break
                assert firsts == list(range(firsts[0], firsts[0]
                                            + L * len(firsts), L))
                step += 1


@pytest.mark.parametrize("ahead", [1, AHEAD, 3])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("bp,widths", [
    (128, (128, 0, 128, 64)), (128, straddle_widths(128)),
    (196, straddle_widths(196)), (8192, (8192, 0, 8192, 4096, 2048)),
    (8132, straddle_widths(8132))])
def test_quad_item_stream_adds_every_live_slot_once(bp, widths, op, ahead):
    """The quad body's item stream (sweep_items_quad: groups of four lanes
    under gg, pairs under flux), fetched 1-3 items ahead across group
    boundaries: in each block that owns a lane (every block under gg, one
    under flux) the lane adds slot k exactly where it is live, a group
    split by an odd width adding its live lanes alone, in slot order, and
    writes its output once, after its last add; a lane without a live slot
    still writes it."""
    threads = 512
    owners = range(QUAD) if op == "gg" else [None]
    for owner in owners:
        adds, stores = {}, {}
        for rank in (range(QUAD) if owner is None else [owner]):
            events = lane_items(bp, widths,
                                lambda j, r=rank: quad_lane(j, r, op),
                                QUAD_LANES[op], threads, ahead)
            for n, ev in enumerate(events):
                assert ev[1] not in stores, ev
                if ev[0] == "add":
                    adds.setdefault(ev[1], []).append(ev[2])
                else:
                    stores[ev[1]] = n
        assert sorted(stores) == list(range(bp))
        for lane in range(bp):
            want = [k for k, w in enumerate(widths) if lane < w]
            assert adds.get(lane, []) == want, (owner, lane)


@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_quad_form_equals_plain_bitwise(jax_gather, P, bp, op, w16, o16):
    """Four blocks each staging two variables (gg: each sweeping its six
    rows from its own plane; flux: each sweeping its quarter of the lanes
    through all four planes) == sweep_blocks_gather_ref bit for bit, every
    class of the JAX model's plans, with and without init; the plain
    version is held to the JAX gather kernel in interpret mode by
    test_staged_form_matches_jax_gather_kernel."""
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

            got = run(quad_sweep, ext_cnt=cnt)
            ref = run(bs.sweep_blocks_gather_ref)
            assert got.dtype == odt and torch.equal(got, ref), (c, seeded)


# (EP, straddle) of the synthetic quad plans at bp 8192: the two-shard 96³
# plans' interior EP (10496) and bulk / boundary EP (16768), and odd widths
# that split a lane group (`straddle_widths`)
QUAD_SYNTH = [(10496, False), (16768, False), (16768, True)]


@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("ep,straddle", QUAD_SYNTH)
def test_quad_form_synthetic_plans(ep, straddle, op, init, w16, o16):
    """The quad form on synthetic plans at bp 8192 with the two-shard 96³
    plans' EP, where the rule picks it (one shard, a pad entry, a
    zero-width slot, live counts 0 to EP), with odd widths that split a
    lane group, every precision, with and without init: bit for bit the
    plain version, at 256 and 512 threads."""
    bp = 8192
    assert bs.gather_body(bp, ep) == "quad"
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           device="cpu",
                           widths=straddle_widths(bp) if straddle else None)
    if w16:
        args = (*args[:3], args[3].bfloat16(), *args[4:])
    odt = torch.bfloat16 if o16 else torch.float32
    seed = (_init(1, bs.out_rows(op), args[0].shape[2], odt) if init
            else None)
    ref = bs.sweep_blocks_gather_ref(
        *args, init=None if seed is None else seed.clone(), op=op,
        out_dtype=odt)
    assert float(ref.float().abs().max()) > 0
    for threads in (256, 512):
        got = quad_sweep(*args, cnt, init=None if seed is None
                         else seed.clone(), op=op, out_dtype=odt,
                         threads=threads)
        assert got.dtype == odt and torch.equal(got, ref), threads


# K3's push (csrc/sweep_overlap.cu, csrc/push_common.cuh): 16-byte pieces,
# copied by a push block's first 128 threads (kPushThreads; the cluster
# form's wider blocks leave the rest idle), four a thread in the loopback
# form; the peer form's least pieces a block and most push blocks a launch
# (kPushMinPieces, kPeerPushBlocks)
PIECE, PUSH_THREADS, PEER_MIN_PIECES, PEER_MAX_BLOCKS = 16, 128, 128 * 4, 264
PUSH_CHUNK = 4 * PUSH_THREADS                  # the loopback form's chunk


def fused_cluster_grid(P, nb, nph, seg, peer, ctas=CTAS):
    """The CUDA blocks of one cluster launch of K3's gather form (clusters
    of `ctas` blocks: the cluster body's two, the quad body's four), in
    index order: ("signal",) (the peer form's block 0), ("push", pk, c)
    (chunk c of flat (shard, phase) pk), ("pad",) up to whole clusters,
    then ("sweep", g, rank) for the blocks at region + i: entry
    g = i // ctas and the block's rank in its cluster, which the hardware
    gives as blockIdx.x % ctas.  The loopback form cuts each buffer into
    chunks of PUSH_CHUNK pieces; the peer form keeps `peer_chunks` (at
    least 512 pieces a block, at most 264 blocks), which every rank
    computes alike.  Returns (blocks, region, chunks)."""
    if peer:
        npk = P * nph
        chunks = min(-(-seg // PEER_MIN_PIECES),
                     max(1, PEER_MAX_BLOCKS // npk)) if seg and npk else 0
        blocks = [("signal",)]
    else:
        chunks = -(-seg // PUSH_CHUNK)
        blocks = []
    blocks += [("push", b // chunks, b % chunks)
               for b in range(P * nph * chunks)]
    while len(blocks) % ctas:
        blocks.append(("pad",))
    region = len(blocks)
    blocks += [("sweep", (b - region) // ctas, b % ctas)
               for b in range(region, region + ctas * P * nb)]
    return blocks, region, chunks


def push_pieces(c, chunks, seg, peer):
    """The pieces of its buffer push chunk c copies, thread by thread in
    the kernel's order, T = PUSH_THREADS: the loopback form's threads
    t < T take lo + t, lo + t + T, ... below lo + PUSH_CHUNK
    (lo = c·PUSH_CHUNK); the peer form's (copy_share) c·T + t, then
    strides of chunks·T."""
    T = PUSH_THREADS
    out = []
    for t in range(T):
        if peer:
            out.extend(range(c * T + t, seg, chunks * T))
        else:
            lo = c * PUSH_CHUNK
            out.extend(range(lo + t, min(lo + PUSH_CHUNK, seg), T))
    return out


def fused_cluster(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                  init, sendbufs, dsts, ext_cnt, op="gg", threads=256,
                  peer=False):
    """K3-gather's cluster launch in plain torch, block by block of
    `fused_cluster_grid`: the push blocks copy their pieces of sendbufs
    (P, nph, rows, s_max) to recv[dsts[p, k], k], each piece once; every
    (entry, rank) of the sweep is one block, in a cluster with its
    partner; each block sweeps its rank's lanes (`cluster_lanes`) through
    its plane and its peer's (`cluster_sweep`'s algorithm) onto init.
    Returns (grad, recv)."""
    P, nb, K, bp = slot_idx.shape
    nph = sendbufs.shape[1]
    # the buffers as 16-byte pieces (four int32 words each)
    words = sendbufs.contiguous().view(torch.int32).reshape(P * nph, -1, 4)
    seg = words.shape[1]
    blocks, region, chunks = fused_cluster_grid(P, nb, nph, seg, peer)
    assert region % CTAS == 0
    for c0 in range(0, len(blocks), CTAS):          # no mixed cluster
        assert len({b[0] == "sweep" for b in blocks[c0:c0 + CTAS]}) == 1
    recv = torch.zeros_like(words)
    written = torch.zeros(recv.shape[:2], dtype=torch.long)
    for b in blocks[:region]:
        if b[0] != "push":
            continue
        pk, c = b[1], b[2]
        to = int(dsts[pk // nph, pk % nph]) * nph + pk % nph
        idx = torch.tensor(push_pieces(c, chunks, seg, peer),
                           dtype=torch.long)
        recv[to, idx] = words[pk, idx]
        written[to, idx] += 1
    assert bool((written == 1).all())
    # the sweep: each (entry, rank) once, each rank's lanes from its own
    # block's view of the planes
    swept = [(b[1], b[2]) for b in blocks[region:]]
    assert sorted(swept) == [(g, r) for g in range(P * nb)
                             for r in range(CTAS)]
    planes = cluster_planes(var_T, exts, block_ids, ext_cnt, bp)
    grad = init.clone()
    for rank in range(CTAS):
        local, partner = planes[rank], planes[rank ^ 1]
        seen = torch.cat([local, partner] if rank == 0 else [partner, local],
                         dim=2)

        def terms(k, w, off, own, seen=seen):
            idx = slot_idx[:, :, k, None, :w].long().expand(P, nb, NV, w)
            return torch.gather(seen, 3, idx), slot_w[:, :, k, :, :w]

        out = bs._sweep_plain(var_T, scale, block_ids, slots, init.clone(),
                              terms, op)
        lanes = torch.tensor(cluster_lanes(bp, rank, threads),
                             dtype=torch.long)
        for g, r in swept:
            p, e = divmod(g, nb)
            if r != rank or (e > 0 and block_ids[p, e] == block_ids[p, e - 1]):
                continue                              # a pad entry
            cols = int(block_ids[p, e]) * bp + lanes
            grad[p][:, cols] = out[p][:, cols]
    return grad, recv.view(sendbufs.dtype).reshape(sendbufs.shape)


def fused_quad(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
               init, sendbufs, dsts, ext_cnt, op="gg", threads=512,
               peer=False):
    """K3-gather's quad launch in plain torch, block by block of
    `fused_cluster_grid` with clusters of four: the push blocks copy their
    pieces as in `fused_cluster`, no cluster mixes push and sweep blocks,
    every (entry, rank) of the sweep is one block, and the sweep is the
    quad body's (`quad_sweep`) onto init.  Returns (grad, recv)."""
    P, nb = slot_idx.shape[:2]
    nph = sendbufs.shape[1]
    words = sendbufs.contiguous().view(torch.int32).reshape(P * nph, -1, 4)
    seg = words.shape[1]
    blocks, region, chunks = fused_cluster_grid(P, nb, nph, seg, peer, QUAD)
    assert region % QUAD == 0
    for c0 in range(0, len(blocks), QUAD):
        assert len({b[0] == "sweep" for b in blocks[c0:c0 + QUAD]}) == 1
    recv = torch.zeros_like(words)
    written = torch.zeros(recv.shape[:2], dtype=torch.long)
    for b in blocks[:region]:
        if b[0] != "push":
            continue
        pk, c = b[1], b[2]
        to = int(dsts[pk // nph, pk % nph]) * nph + pk % nph
        idx = torch.tensor(push_pieces(c, chunks, seg, peer),
                           dtype=torch.long)
        recv[to, idx] = words[pk, idx]
        written[to, idx] += 1
    assert bool((written == 1).all())
    swept = sorted((b[1], b[2]) for b in blocks[region:])
    assert swept == [(g, r) for g in range(P * nb) for r in range(QUAD)]
    grad = quad_sweep(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                      ext_cnt, init=init.clone(), op=op, threads=threads)
    return grad, recv.view(sendbufs.dtype).reshape(sendbufs.shape)


def _push_operands(P, rows, dtype, s_max=1000, nph=2, seed=5):
    """Random send buffers (P, nph, rows, s_max) and a push map whose
    phase k sends shard p to (p + k + 1) mod P."""
    rng = np.random.default_rng(seed)
    send = torch.from_numpy(rng.standard_normal(
        (P, nph, rows, s_max)).astype(np.float32)).to(dtype)
    dsts = torch.tensor([[(p + k + 1) % P for k in range(nph)]
                         for p in range(P)], dtype=torch.int32)
    srcs = torch.tensor([[(p - k - 1) % P for k in range(nph)]
                         for p in range(P)], dtype=torch.int32)
    return send, dsts, srcs


def _fused_cases(args, cnt, init, send, dsts, srcs, op, bp, ep):
    """fused_cluster at the rule's threads, loopback and peer-shaped, each
    bit for bit the plain version, grad and recv."""
    g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
        *args, init.clone(), send, dsts, srcs, op=op)
    threads = bs.cluster_threads(bp, ep)
    for peer in (False, True):
        g, r = fused_cluster(*args, init, send, dsts, cnt, op=op,
                             threads=threads, peer=peer)
        assert g.dtype == g_ref.dtype and torch.equal(g, g_ref), peer
        assert torch.equal(r, r_ref), peer


@pytest.mark.parametrize("w16o16", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("P,bp", JAX_CASES)
def test_fused_cluster_form_equals_plain_bitwise(jax_gather, P, bp, op,
                                                 w16o16):
    """K3-gather's cluster launch, grid and push included, on the JAX
    model's interior plans with a random init and two push phases: grad
    and recv bit for bit the plain version, with the loopback form's
    chunks and the peer form's."""
    jm, js, arrays, _ = jax_gather(P, bp, BF if w16o16 else "float32")
    from cfd_proxy_tpu_torch.convert import state_from_jax

    var_T = _t(state_from_jax(js))
    odt = torch.bfloat16 if w16o16 else torch.float32
    args, cnt = _port_args(arrays, var_T, "interior", w16o16)
    rows = bs.out_rows(op)
    init = _init(P, rows, var_T.shape[2], odt)
    send, dsts, srcs = _push_operands(P, rows, odt)
    _fused_cases(args, cnt, init, send, dsts, srcs, op, bp,
                 args[1].shape[3])


@pytest.mark.parametrize("w16o16", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("bp,ep", [(4096, 1920), (8192, 2688), (4096, 5760)])
def test_fused_cluster_form_synthetic_plans(bp, ep, op, w16o16):
    """The same on synthetic plans at the one-shard 96³ interior plans' AUTO
    bp 4096 (EP 1920: 256 threads, two blocks an SM) and bp 8192 (EP 2688:
    512 threads) and the two-shard one at bp 4096 (EP 5760: 512 threads),
    with a pad entry, a zero-width slot and live counts 0 to EP."""
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           device="cpu")
    odt = torch.bfloat16 if w16o16 else torch.float32
    if w16o16:
        args = (*args[:3], args[3].bfloat16(), *args[4:])
    assert bs.gather_body(bp, ep, op, fused=True) == "cluster"
    rows = bs.out_rows(op)
    init = _init(1, rows, args[0].shape[2], odt)
    send, dsts, srcs = _push_operands(1, rows, odt, s_max=1064)
    _fused_cases(args, cnt, init, send, dsts, srcs, op, bp, ep)


@pytest.mark.parametrize("w16o16", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("ep", [10496, 16768])
def test_fused_quad_form_synthetic_plans(ep, op, w16o16):
    """K3-gather's quad launch, grid and push included, on synthetic plans
    at bp 8192 with the two-shard 96³ plans' EP (a pad entry, a zero-width
    slot, live counts 0 to EP), loopback and peer-shaped: grad and recv
    bit for bit the plain version."""
    bp = 8192
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           device="cpu")
    odt = torch.bfloat16 if w16o16 else torch.float32
    if w16o16:
        args = (*args[:3], args[3].bfloat16(), *args[4:])
    assert bs.gather_body(bp, ep, op, fused=True) == \
        ("quad" if op == "gg" else "direct")
    rows = bs.out_rows(op)
    init = _init(1, rows, args[0].shape[2], odt)
    send, dsts, srcs = _push_operands(1, rows, odt, s_max=1064)
    g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
        *args, init.clone(), send, dsts, srcs, op=op)
    for peer in (False, True):
        g, r = fused_quad(*args, init, send, dsts, cnt, op=op,
                          threads=bs.quad_threads(bp, ep), peer=peer)
        assert g.dtype == g_ref.dtype and torch.equal(g, g_ref), peer
        assert torch.equal(r, r_ref), peer


def test_fused_quad_grid_pads_the_push_region():
    """The quad launch pads its push region to whole clusters of four (one
    to three pad blocks), so no cluster holds a push block and a sweep
    block; the push chunks stay the one-block forms'; the sweep blocks are
    four per entry, ranks 0-3 in order."""
    for peer in (False, True):
        for seg in (5000, 512 * 3, 512 * 4, 512 * 5, 512 * 7):
            blocks, region, chunks = fused_cluster_grid(2, 3, 1, seg, peer,
                                                        QUAD)
            pushes = sum(b[0] == "push" for b in blocks)
            pads = sum(b[0] == "pad" for b in blocks)
            assert region % QUAD == 0 and pads < QUAD
            assert region == pushes + peer + pads
            assert chunks == -(-seg // 512)
            assert [b[0] for b in blocks[region:]] == ["sweep"] * 24
            assert [b[2] for b in blocks[region:]] == [0, 1, 2, 3] * 6
    blocks, region, _ = fused_cluster_grid(1, 1, 1, 512 * 3, True, QUAD)
    assert [b[0] for b in blocks[:region]] == ["signal", "push", "push",
                                                "push"]
    blocks, region, _ = fused_cluster_grid(1, 1, 1, 512 * 4, True, QUAD)
    assert [b[0] for b in blocks[:region]] == [
        "signal", "push", "push", "push", "push", "pad", "pad", "pad"]


def test_fused_cluster_grid_pads_the_push_region():
    """An odd push region gets one pad block, so no cluster holds a push
    block and a sweep block; the push chunks are the one-block forms'
    (ceil(5000 / 512) = 10 in both forms), whatever the cluster's
    threads."""
    for peer in (False, True):
        blocks, region, chunks = fused_cluster_grid(2, 3, 1, 5000, peer)
        pushes = sum(b[0] == "push" for b in blocks)
        assert region % CTAS == 0
        assert region == pushes + peer + (pushes + peer) % CTAS
        assert [b[0] for b in blocks[region:]] == ["sweep"] * 12
        assert chunks == 10
    blocks, region, _ = fused_cluster_grid(1, 1, 1, 512 * 3, True)
    assert [b[0] for b in blocks[:region]] == ["signal", "push", "push",
                                                "push"]


def test_fused_cluster_form_matches_jax_overlap_kernel():
    """K3-gather's cluster launch against the reference's fused kernel in
    its gather form (sweep_blocks_overlap, interpret mode, under shard_map
    on a one-device mesh) at bp 1024, the largest its interpret mode takes
    (the reference model caps it there: cfd_proxy_tpu/models/
    gradients_pallas.py:314): one shard of a 16 x 12 x 11 mesh, three
    blocks, two self-send phases of random payloads.  grad within 1e-6 of
    max|plain|, recv bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec
    from cfd_proxy_tpu.models import GreenGaussPallas
    from cfd_proxy_tpu.models.gradients_pallas import AXIS, _shard_map
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks_overlap
    from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax

    big = generate_mesh(16, 12, 11, jitter=0.05, diag_frac=0.25,
                        shuffle=True, seed=43)
    jm = GreenGaussPallas(partition_mesh(big, 1, ghost_layers=1), NVAR,
                          bp=1024, interpret=True, force_rdma=True,
                          kernel="gather")
    assert jm.bp == 1024
    js = jm.distribute_state(make_state(big.npoint, NVAR, seed=19),
                             schedules=["overlap"])
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
    var_T = _t(state_from_jax(js))
    args, cnt = _port_args(plans_from_jax(jm), var_T, "interior", False)
    g, r = fused_cluster(*args, _t(init), _t(send), _t(dsts), cnt,
                         threads=bs.cluster_threads(jm.bp, ep))
    scale = np.abs(g_ref).max()
    assert scale > 0
    assert np.abs(g.numpy() - g_ref).max() <= TOL * scale
    np.testing.assert_array_equal(r.numpy(), r_ref)


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
            + bs._tag(w16, False, o16) + bs._BODY_TAGS[body] + "launches")


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
    """The bodies compute the same values in the same order: equal bit for
    bit on the same plan (K2 and K3-gather's sweep under all three)."""
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
        assert torch.equal(out["cluster", key], out["direct", key]), key
        assert torch.equal(out["quad", key], out["direct", key]), key


def _synthetic(ep, live, P=2, bp=128, nblk=6, seed=9, device="cuda",
               widths=None):
    """Random gather operands on `device`: entries (0, 2, 3, 3) per shard —
    the last a pad entry — slots of widths (bp, 0, bp, bp/2) (one of zero
    width; or `widths`), per-entry live ext counts `live` (P, 4), every
    W-index below bp + its entry's count, the last slot's lanes pads
    (W-index 0, zero weight)."""
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
           "block_ids": bids,
           "slots": bs.slot_table(widths or (bp, 0, bp, bp // 2))}
    dev = {k: torch.from_numpy(np.ascontiguousarray(
        v if v.dtype != np.float64 else v.astype(np.float32))).to(device)
        for k, v in ops.items()}
    args = tuple(dev[k] for k in ("var_T", "exts", "slot_idx", "slot_w",
                                  "scale", "block_ids", "slots"))
    return args, torch.from_numpy(live).to(device)


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
                                         int(w16), int(o16), smem, 0)
                assert info["blocks_per_sm"] >= 2, (acc, op, w16, o16, info)
                assert info["local_bytes"] <= 80, info
    for peer in (0, 1):
        for op in (0, 1):
            for w16, o16 in PRECISIONS:
                info = _cuda.kernel_info("cfd_overlap_gather_info", peer, 1,
                                         op, int(w16), int(o16), smem, 0)
                assert info["blocks_per_sm"] >= admit, (peer, op, w16, info)
                assert info["local_bytes"] <= 80, info


# (bp, straddle) of the card's cluster cases: the 96³ one-shard plan's bp
# 8192, with its widths and with odd widths that split a lane pair
# (`straddle_widths`), and bp 8132, whose last run of lanes is a 4-lane tail
CLUSTER_CARD_CASES = [(8192, False), (8192, True), (8132, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("bp,straddle", CLUSTER_CARD_CASES)
def test_cuda_cluster_equals_direct_bitwise_at_bp_8192(monkeypatch, bp,
                                                       straddle, op, init,
                                                       w16, o16):
    """Every K2 instance on the cluster body, at both thread counts, on a
    synthetic plan at the 96³ one-shard plan's bp 8192 and EP 2688 (where
    the rule picks it; pad entry, zero-width slot, an entry without ext
    columns), also with lane pairs split by odd widths and at bp 8132 (a
    4-lane run tail): bit for bit the direct body, counted under the
    cluster tag, and within the plain version's bounds."""
    _card()
    ep = 2688
    assert bs.gather_body(bp, ep) == "cluster"
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           widths=straddle_widths(bp) if straddle else None)
    if w16:
        args = (*args[:3], args[3].bfloat16(), *args[4:])
    odt = torch.bfloat16 if o16 else torch.float32
    seed = (_init(1, bs.out_rows(op), args[0].shape[2], odt).cuda() if init
            else None)

    def run(**kw):
        return bs.sweep_blocks_gather(
            *args, init=None if seed is None else seed.clone(), op=op,
            out_dtype=odt, ext_cnt=cnt, **kw)

    attr = _counter(op, init, w16, o16, "cluster")
    before = getattr(bs.sweep_blocks_gather, attr)
    got = {}
    for threads in (256, 512):
        monkeypatch.setattr(bs, "cluster_threads", lambda *_, n=threads: n)
        got[threads] = run()
    monkeypatch.setattr(bs, "gather_body", lambda *a, **kw: "direct")
    direct = run()
    ref = bs.sweep_blocks_gather_ref(
        *args, init=None if seed is None else seed.clone(), op=op,
        out_dtype=odt)
    torch.cuda.synchronize()
    assert getattr(bs.sweep_blocks_gather, attr) == before + 2
    for threads, out in got.items():
        assert torch.equal(out, direct), threads
    _assert_close(direct, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", [2, 3, 4])
def test_cuda_cluster_refuses_operands_off_a_pair(operand):
    """The cluster body loads two lanes' W-indices, weights and scale at a
    time: a slot_idx, slot_w or scale one element off a two-element
    boundary (contiguous, at an odd storage offset) is refused before a
    launch."""
    from cfd_proxy_tpu_torch.utils.errors import CheckError

    _card()
    ep = 2688
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=8192, nblk=5)
    t = args[operand]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=t.device)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 != 0
    bad = (*args[:operand], shifted, *args[operand + 1:])
    with pytest.raises(CheckError, match="two lanes at a time"):
        bs.sweep_blocks_gather(*bad, ext_cnt=cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("bp,ep,per_sm", [(8192, 2688, 1), (4096, 1920, 2)])
def test_cuda_cluster_residency(bp, ep, per_sm):
    """At the one-shard plans' half-tables (170 KB at bp 8192, 94 KB at
    4096) every cluster instance keeps one, or two, CUDA blocks per SM at
    the rule's threads, with no spill, and the runtime can hold a cluster
    (a launch raises otherwise)."""
    _card()
    from cfd_proxy_tpu_torch.ops import _cuda

    smem = bs.cluster_bytes(bp, ep)
    threads = bs.cluster_threads(bp, ep)
    assert threads * per_sm == 512
    for acc in (0, 1):
        for op in (0, 1):
            for w16, o16 in PRECISIONS:
                info = _cuda.kernel_info(
                    "cfd_sweep_gather_info", bs.GATHER_BODY_CODES["cluster"],
                    acc, op, int(w16), int(o16), smem, threads)
                assert info["blocks_per_sm"] == per_sm, info
                assert info["active_clusters"] >= 1, info
                assert info["local_bytes"] == 0, info


def _peer(P, nph, rows, s_max, dtype):
    """A Peer transport of P shards on the card, phase k of shard p sent
    to shard p (self-sends)."""
    from cfd_proxy_tpu_torch.parallel.transport import Peer

    d = np.tile(np.arange(P, dtype=np.int32)[:, None], (1, nph))
    return Peer(d, d, rows=rows, s_max=s_max, dtype=dtype, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("peer", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("bp,straddle", CLUSTER_CARD_CASES)
def test_cuda_k3_gather_cluster_equals_direct_bitwise_at_bp_8192(
        monkeypatch, bp, straddle, op, peer, w16, o16):
    """Every K3-gather instance, loopback and peer form, on the cluster
    body at both thread counts, on the synthetic plan at bp 8192 / EP 2688
    (where the rule picks it; also with lane pairs split by odd widths and
    at bp 8132) with two pushed phases: grad and recv bit for bit the
    direct body's, counted under the cluster tag, and within the plain
    version's bounds."""
    _card()
    ep = 2688
    assert bs.gather_body(bp, ep, op, fused=True) == "cluster"
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           widths=straddle_widths(bp) if straddle else None)
    if w16:
        args = (*args[:3], args[3].bfloat16(), *args[4:])
    odt = torch.bfloat16 if o16 else torch.float32
    rows = bs.out_rows(op)
    seed = _init(1, rows, args[0].shape[2], odt).cuda()
    send = torch.randn((1, 2, rows, 1064), device="cuda").to(odt)
    dsts = torch.zeros((1, 2), dtype=torch.int32)
    tr = _peer(1, 2, rows, 1064, odt) if peer else None

    def run():
        g, r = bs.sweep_blocks_overlap_gather(
            *args, seed.clone(), send, None if peer else dsts,
            None if peer else dsts, op=op, peer=tr, ext_cnt=cnt)
        return g, r.clone()

    attr = _counter(op, False, w16, o16, "cluster", peer)
    before = getattr(bs.sweep_blocks_overlap_gather, attr)
    try:
        got = {}
        for threads in (256, 512):
            monkeypatch.setattr(bs, "cluster_threads",
                                lambda *_, n=threads: n)
            got[threads] = run()
        monkeypatch.setattr(bs, "gather_body", lambda *a, **kw: "direct")
        direct = run()
    finally:
        if tr is not None:
            tr.close()
    g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
        *args, seed.clone(), send, dsts, dsts, op=op)
    torch.cuda.synchronize()
    assert getattr(bs.sweep_blocks_overlap_gather, attr) == before + 2
    for key, (g, r) in got.items():
        assert torch.equal(g, direct[0]), key
        assert torch.equal(r, direct[1]), key
    _assert_close(direct[0], g_ref)
    assert torch.equal(direct[1], r_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bp,ep,per_sm", [(8192, 2688, 1), (4096, 1920, 2)])
def test_cuda_fused_cluster_residency(bp, ep, per_sm):
    """K3-gather's cluster instances (loopback and peer, every op and
    precision) at the one-shard plans' half-tables keep one, or two, CUDA
    blocks per SM at the rule's threads, push blocks included (they share
    the launch's block shape and shared memory), spill nothing, and the
    runtime can hold a cluster (a launch raises otherwise)."""
    _card()
    from cfd_proxy_tpu_torch.ops import _cuda

    smem = bs.cluster_bytes(bp, ep)
    threads = bs.cluster_threads(bp, ep)
    assert threads * per_sm == 512
    for peer in (0, 1):
        for op in (0, 1):
            for w16, o16 in PRECISIONS:
                info = _cuda.kernel_info(
                    "cfd_overlap_gather_info", peer,
                    bs.GATHER_BODY_CODES["cluster"], op, int(w16), int(o16),
                    smem, threads)
                assert info["blocks_per_sm"] == per_sm, (peer, op, info)
                assert info["active_clusters"] >= 1, info
                assert info["local_bytes"] == 0, (peer, op, w16, o16, info)


@pytest.mark.cuda
def test_cuda_peer_cluster_push_region_fills_the_card():
    """A peer cluster launch at bp 8192 (one CUDA block per SM) whose push
    region (the signal block and 264 push blocks, padded) outnumbers the
    card's SMs twice: every push block waits for block 0's readiness
    signal while later ones queue behind it, and the sweep clusters wait
    for free SM pairs; three launches on one transport end, and grad and
    recv equal the loopback cluster launch's bit for bit."""
    _card()
    ep = 2688
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=8192, nblk=5)
    s_max = 128 * 1024            # 24 rows: 384 K pieces a buffer, 2 phases
    send = torch.randn((1, 2, 3 * NV, s_max), device="cuda")
    dsts = torch.zeros((1, 2), dtype=torch.int32)
    init = _init(1, 3 * NV, args[0].shape[2], torch.float32).cuda()
    tr = _peer(1, 2, 3 * NV, s_max, torch.float32)
    try:
        for i in range(3):
            g_peer, r_peer = bs.sweep_blocks_overlap_gather(
                *args, init.clone() * (i + 1), send, None, None, peer=tr,
                ext_cnt=cnt)
            g_loop, r_loop = bs.sweep_blocks_overlap_gather(
                *args, init.clone() * (i + 1), send, dsts, dsts,
                ext_cnt=cnt)
            torch.cuda.synchronize()
            assert torch.equal(g_peer, g_loop), i
            assert torch.equal(r_peer, r_loop), i
    finally:
        tr.close()


@pytest.mark.cuda
@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("ep,straddle", QUAD_SYNTH)
def test_cuda_quad_equals_direct_bitwise_at_bp_8192(monkeypatch, ep,
                                                    straddle, op, init, w16,
                                                    o16):
    """Every K2 instance on the quad body (flux forced: the rule keeps it on
    direct), at 256 and 512 threads, on a synthetic plan at bp 8192 with
    the two-shard 96³ plans' EP (where the rule picks it for gg; pad entry,
    zero-width slot, an entry without ext columns), also with lane groups
    split by odd widths: bit for bit the direct body, counted under the
    quad tag, and within the plain version's bounds."""
    _card()
    bp = 8192
    assert bs.gather_body(bp, ep) == "quad"
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           widths=straddle_widths(bp) if straddle else None)
    if w16:
        args = (*args[:3], args[3].bfloat16(), *args[4:])
    odt = torch.bfloat16 if o16 else torch.float32
    seed = (_init(1, bs.out_rows(op), args[0].shape[2], odt).cuda() if init
            else None)

    def run():
        return bs.sweep_blocks_gather(
            *args, init=None if seed is None else seed.clone(), op=op,
            out_dtype=odt, ext_cnt=cnt)

    attr = _counter(op, init, w16, o16, "quad")
    before = getattr(bs.sweep_blocks_gather, attr)
    got = {}
    # flux keeps the direct body there (the rule's test): its quad form,
    # forced
    monkeypatch.setattr(bs, "gather_body", lambda *a, **kw: "quad")
    for threads in (256, 512):
        monkeypatch.setattr(bs, "quad_threads", lambda *_, n=threads: n)
        got[threads] = run()
    monkeypatch.setattr(bs, "gather_body", lambda *a, **kw: "direct")
    direct = run()
    ref = bs.sweep_blocks_gather_ref(
        *args, init=None if seed is None else seed.clone(), op=op,
        out_dtype=odt)
    torch.cuda.synchronize()
    assert getattr(bs.sweep_blocks_gather, attr) == before + 2
    for threads, out in got.items():
        assert torch.equal(out, direct), threads
    _assert_close(direct, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("w16,o16", PRECISIONS)
@pytest.mark.parametrize("peer", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("ep,straddle", QUAD_SYNTH)
def test_cuda_k3_gather_quad_equals_direct_bitwise_at_bp_8192(
        monkeypatch, ep, straddle, op, peer, w16, o16):
    """Every K3-gather instance, loopback and peer form, on the quad body
    (flux forced) at 256 and 512 threads, on the synthetic plans at bp 8192
    with the two-shard EP (also with lane groups split by odd widths) with
    two pushed phases: grad and recv bit for bit the direct body's, counted
    under the quad tag, and within the plain version's bounds."""
    _card()
    bp = 8192
    assert bs.gather_body(bp, ep, op, fused=True) == \
        ("quad" if op == "gg" else "direct")
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=bp, nblk=5,
                           widths=straddle_widths(bp) if straddle else None)
    if w16:
        args = (*args[:3], args[3].bfloat16(), *args[4:])
    odt = torch.bfloat16 if o16 else torch.float32
    rows = bs.out_rows(op)
    seed = _init(1, rows, args[0].shape[2], odt).cuda()
    send = torch.randn((1, 2, rows, 1064), device="cuda").to(odt)
    dsts = torch.zeros((1, 2), dtype=torch.int32)
    tr = _peer(1, 2, rows, 1064, odt) if peer else None

    def run():
        g, r = bs.sweep_blocks_overlap_gather(
            *args, seed.clone(), send, None if peer else dsts,
            None if peer else dsts, op=op, peer=tr, ext_cnt=cnt)
        return g, r.clone()

    attr = _counter(op, False, w16, o16, "quad", peer)
    before = getattr(bs.sweep_blocks_overlap_gather, attr)
    monkeypatch.setattr(bs, "gather_body", lambda *a, **kw: "quad")
    try:
        got = {}
        for threads in (256, 512):
            monkeypatch.setattr(bs, "quad_threads",
                                lambda *_, n=threads: n)
            got[threads] = run()
        monkeypatch.setattr(bs, "gather_body", lambda *a, **kw: "direct")
        direct = run()
    finally:
        if tr is not None:
            tr.close()
    g_ref, r_ref = bs.sweep_blocks_overlap_gather_ref(
        *args, seed.clone(), send, dsts, dsts, op=op)
    torch.cuda.synchronize()
    assert getattr(bs.sweep_blocks_overlap_gather, attr) == before + 2
    for key, (g, r) in got.items():
        assert torch.equal(g, direct[0]), key
        assert torch.equal(r, direct[1]), key
    _assert_close(direct[0], g_ref)
    assert torch.equal(direct[1], r_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("ep", [16768, 10496])
def test_cuda_quad_residency(ep):
    """At the two-shard bp 8192 plans' quarter tables (195 and 146 KB)
    every quad instance, K2 (with and without init) and K3-gather
    (loopback and peer, push blocks included), every op and precision,
    keeps one CUDA block per SM at the rule's threads, spills nothing, and
    the runtime can hold a cluster of four (a launch raises otherwise)."""
    _card()
    from cfd_proxy_tpu_torch.ops import _cuda

    bp = 8192
    smem = bs.quad_bytes(bp, ep)
    threads = bs.quad_threads(bp, ep)
    assert threads == 512
    code = bs.GATHER_BODY_CODES["quad"]
    for op in (0, 1):
        for w16, o16 in PRECISIONS:
            infos = [_cuda.kernel_info("cfd_sweep_gather_info", code, acc,
                                       op, int(w16), int(o16), smem, threads)
                     for acc in (0, 1)]
            infos += [_cuda.kernel_info("cfd_overlap_gather_info", peer,
                                        code, op, int(w16), int(o16), smem,
                                        threads) for peer in (0, 1)]
            for info in infos:
                assert info["blocks_per_sm"] == 1, (op, w16, o16, info)
                assert info["active_clusters"] >= 1, info
                assert info["local_bytes"] == 0, (op, w16, o16, info)


@pytest.mark.cuda
@pytest.mark.parametrize("op,shift", [("gg", 2), ("gg", 1), ("flux", 1)])
@pytest.mark.parametrize("operand", [2, 3, 4])
def test_cuda_quad_refuses_operands_off_a_group(monkeypatch, operand, op,
                                                shift):
    """The quad body loads four lanes' W-indices, weights and scale at a
    time under gg, two under flux (forced: the rule keeps flux on direct):
    a slot_idx, slot_w or scale `shift` elements off that boundary
    (contiguous, at an offset storage) is refused before a launch."""
    from cfd_proxy_tpu_torch.utils.errors import CheckError

    _card()
    monkeypatch.setattr(bs, "gather_body", lambda *a, **kw: "quad")
    ep = 16768
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=8192, nblk=5)
    t = args[operand]
    shifted = torch.empty(t.numel() + shift, dtype=t.dtype,
                          device=t.device)[shift:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous()
    bad = (*args[:operand], shifted, *args[operand + 1:])
    word = {"gg": "four", "flux": "two"}[op]
    with pytest.raises(CheckError, match=f"{word} lanes at a time"):
        bs.sweep_blocks_gather(*bad, op=op, ext_cnt=cnt)


@pytest.mark.cuda
def test_cuda_peer_quad_push_region_fills_the_card():
    """A peer quad launch at bp 8192 (one CUDA block per SM) whose push
    region (the signal block and 264 push blocks, padded to whole clusters
    of four) outnumbers the card's SMs twice: every push block waits for
    block 0's readiness signal while later ones queue behind it, and the
    sweep clusters wait for four free SMs of one GPC; three launches on one
    transport end, and grad and recv equal the loopback quad launch's bit
    for bit."""
    _card()
    ep = 16768
    args, cnt = _synthetic(ep, [[0, ep, 7, 7]], P=1, bp=8192, nblk=5)
    assert bs.gather_body(8192, ep, fused=True) == "quad"
    s_max = 128 * 1024            # 24 rows: 384 K pieces a buffer, 2 phases
    send = torch.randn((1, 2, 3 * NV, s_max), device="cuda")
    dsts = torch.zeros((1, 2), dtype=torch.int32)
    init = _init(1, 3 * NV, args[0].shape[2], torch.float32).cuda()
    tr = _peer(1, 2, 3 * NV, s_max, torch.float32)
    before = bs.sweep_blocks_overlap_gather.peer_quad_launches
    try:
        for i in range(3):
            g_peer, r_peer = bs.sweep_blocks_overlap_gather(
                *args, init.clone() * (i + 1), send, None, None, peer=tr,
                ext_cnt=cnt)
            g_loop, r_loop = bs.sweep_blocks_overlap_gather(
                *args, init.clone() * (i + 1), send, dsts, dsts,
                ext_cnt=cnt)
            torch.cuda.synchronize()
            assert torch.equal(g_peer, g_loop), i
            assert torch.equal(r_peer, r_loop), i
    finally:
        tr.close()
    assert bs.sweep_blocks_overlap_gather.peer_quad_launches == before + 3
