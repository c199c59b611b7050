"""Host-side block plans for the block-local sweep (NumPy).

The host half of `cfd_proxy_tpu/ops/blocksweep.py`: the port imports
nothing of the JAX package and carries its own host layer, held equal to
the originals by tests (tests/test_torch_plan.py for this module).  The
code is the original's line for line, plus
`compact_src_cols`, every compact table entry's device column (what the
pack's plain version gathers), `compact_widx`, the same entries as
W-indices into the block's own and ext columns (what the pack kernel
resolves), and the two plan-padding helpers of
`cfd_proxy_tpu/models/gradients_pallas.py` that make every shard's plan
the same shape.

Layout (everything transposed):
    var_T  (NV, npoint_dev)   — state, NV = nvar padded to 8
    grad_T (3*NV, npoint_dev) — output, row d*NV+v

Preprocessing groups the 2F directed incidences (slot = one face endpoint)
by destination point, orders each point's slots by incidence id (golden
summation order), and blocks points into BP-column groups.  Per block:
    slot_idx (K, BP)    W-index of the *other* endpoint of each slot
    slot_w   (K, 3, BP) sign × face normal (±n_f), zero on padding
    ext_idx  (EP,)      device columns outside the block that slots read
    scale    (1, BP)    1/V at owned points (volume scaling fused), 0 on pad
W-index: own columns at [0, BP), ext columns at BP + rank in ext_idx.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_proxy_tpu_torch.utils import round_up
from cfd_proxy_tpu_torch.utils.errors import check

LANE = 128
NV = 8          # padded variable count


@dataclass
class BlockPlan:
    """Host-side block metadata for one face class on one shard."""

    npoint_dev: int            # padded device point count (multiple of BP)
    bp: int                    # points per block
    ep: int                    # ext columns per block (multiple of 128)
    kslots: int                # max slots per point (uniform)
    nblocks: int               # blocks in this plan's block list
    block_ids: np.ndarray      # (nblocks,) i32 — device block index per grid step
    slot_idx: np.ndarray       # (nblocks, K, BP) i32 — W-index of other endpoint
    slot_w: np.ndarray         # (nblocks, K, 3, BP) f32 — ± normals
    ext_idx: np.ndarray        # (nblocks, EP) i32 — device columns to gather
    scale: np.ndarray          # (nblocks, 1, BP) f32 — 1/V (fused), 0 on pad
    ext_cnt: np.ndarray | None = None  # (nblocks,) i32 — REAL ext columns per
                               # block (≤ EP, which is the max padded up)


def build_block_plan(
    faces: np.ndarray,         # (F, 2) device point columns
    normals: np.ndarray,       # (F, 3)
    npoint_dev: int,           # multiple of bp
    inv_scale: np.ndarray,     # (npoint_dev,) — 1/V at owned, 0 elsewhere
    *,
    bp: int = 256,
    face_sel: np.ndarray | None = None,   # bool (F,) — restrict to a face class
    all_blocks: bool = False,  # keep every block in the grid even if empty
    pads: tuple[int, int] | None = None,  # (ep, kslots) forced paddings
    dst_lt: int | None = None,  # drop slots whose DESTINATION column is
                               # >= this bound.  Used with dst_lt = nowned to
                               # drop ghost-destination slots: their sums are
                               # dead by construction (scale 0 at ghosts /
                               # overwritten by the halo unpack), and carrying
                               # them wastes stream, inflates kslots/ext
                               # lists, and blunts the compact prefix widths
                               # (the ghost region cannot be degree-sorted).
) -> BlockPlan:
    check(npoint_dev % bp == 0, "npoint_dev %d not a multiple of bp %d", npoint_dev, bp)
    check(bp % LANE == 0, "bp must be a multiple of 128")
    native = _build_block_plan_native(
        faces, normals, npoint_dev, inv_scale, bp, face_sel, all_blocks, pads,
        dst_lt,
    )
    if native is not None:
        return native
    F = faces.shape[0]
    if face_sel is None:
        fsel = np.arange(F)
    else:
        fsel = np.flatnonzero(face_sel)
    f = faces[fsel]
    n = normals[fsel]

    # directed incidences: destination point, other endpoint, ±normal, order
    dst = np.concatenate([f[:, 0], f[:, 1]])
    oth = np.concatenate([f[:, 1], f[:, 0]])
    sgn = np.concatenate([np.ones(len(f)), -np.ones(len(f))])
    w = sgn[:, None] * np.concatenate([n, n], axis=0)          # (2Fs, 3)
    inc_id = np.concatenate([2 * fsel, 2 * fsel + 1])          # golden order
    if dst_lt is not None:
        keep = dst < dst_lt
        dst, oth, w, inc_id = dst[keep], oth[keep], w[keep], inc_id[keep]

    blk = dst // bp
    nblk_total = npoint_dev // bp
    if all_blocks:
        blocks = np.arange(nblk_total)
    else:
        blocks = np.unique(blk) if blk.size else np.zeros(1, np.int64)
    nblocks = len(blocks)
    blk_pos = np.full(nblk_total, -1, np.int64)
    blk_pos[blocks] = np.arange(nblocks)

    # per-point slot assignment, slots ordered by incidence id
    order = np.lexsort((inc_id, dst))
    dst_s, oth_s, w_s = dst[order], oth[order], w[order]
    counts = np.bincount(dst_s, minlength=npoint_dev)
    kmax = int(counts.max()) if counts.size else 0
    starts = np.zeros(npoint_dev + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_of = np.arange(dst_s.size) - starts[dst_s]

    # per-block ext lists: other endpoints outside the block
    lane = dst_s % bp
    b_of = blk_pos[dst_s // bp]
    own_lo = (dst_s // bp) * bp
    is_ext = (oth_s < own_lo) | (oth_s >= own_lo + bp)

    ext_lists: list[np.ndarray] = []
    ext_max = 0
    for bi, b in enumerate(blocks):
        sel = (b_of == bi) & is_ext
        uniq = np.unique(oth_s[sel])
        ext_lists.append(uniq)
        ext_max = max(ext_max, len(uniq))
    ep = round_up(max(ext_max, 1), LANE)
    if pads is not None:
        check(pads[0] >= ep, "pads ep %d < required %d", pads[0], ep)
        check(pads[1] >= kmax, "pads kslots %d < required %d", pads[1], kmax)
        ep, kmax = pads
    kmax = max(kmax, 1)

    slot_idx = np.zeros((nblocks, kmax, bp), np.int32)
    slot_w = np.zeros((nblocks, kmax, 3, bp), np.float32)
    ext_idx = np.zeros((nblocks, ep), np.int32)
    scale = np.zeros((nblocks, 1, bp), np.float32)
    for bi, b in enumerate(blocks):
        scale[bi, 0, :] = inv_scale[b * bp : (b + 1) * bp]
        ext = ext_lists[bi]
        ext_idx[bi, : len(ext)] = ext
        sel = b_of == bi
        if not sel.any():
            continue
        o = oth_s[sel]
        # W-index: own columns at o - b*bp; ext columns at bp + rank
        local = o - b * bp
        ext_rank = np.searchsorted(ext, o)
        widx = np.where((local >= 0) & (local < bp), local, bp + ext_rank)
        slot_idx[bi, slot_of[sel], lane[sel]] = widx.astype(np.int32)
        slot_w[bi, slot_of[sel], :, lane[sel]] = w_s[sel].astype(np.float32)

    return BlockPlan(
        npoint_dev=npoint_dev, bp=bp, ep=ep, kslots=kmax, nblocks=nblocks,
        block_ids=blocks.astype(np.int32), slot_idx=slot_idx, slot_w=slot_w,
        ext_idx=ext_idx, scale=scale,
        ext_cnt=np.array([len(e) for e in ext_lists], np.int32),
    )


def prefix_widths(slot_w: np.ndarray, bp: int) -> tuple[int, ...]:
    """Static per-slot lane widths for the COMPACT packed layout.

    slot_w: host array (..., K, 3, bp).  Width of slot k = max over all
    leading dims (shards × blocks) of (last lane with a nonzero weight + 1),
    rounded up to 128 lanes.  CORRECT for any point order — a slot's active
    lanes always sit inside its prefix because per-point slot counts are
    contiguous from k=0 (a point of degree d uses slots 0..d-1, so slot k's
    active lane set shrinks monotonically with k).  The WIDTHS need not be
    monotone, though: a slot serving only zero-normal (degenerate) faces
    stores all-zero weights and can measure narrower than a later slot, so
    consumers must treat wks per-slot.  TIGHT when points are degree-sorted
    within each block (mesh/partition.py::rcb_owned_order
    degree_sort=True), which concentrates high-degree points in the leading
    lanes."""
    a = np.asarray(slot_w)
    K = a.shape[-3]
    nz = (a.reshape(-1, K, 3, bp) != 0).any(axis=2)           # (R, K, bp)
    has = nz.any(axis=2)                                      # (R, K)
    last = bp - 1 - nz[:, :, ::-1].argmax(axis=2)
    w = np.where(has, last + 1, 0).max(axis=0) if nz.shape[0] else \
        np.zeros(K, np.int64)                                 # (K,)
    w = (w + LANE - 1) // LANE * LANE
    if w.sum() == 0:
        w[0] = LANE     # degenerate all-empty class: keep one inert chunk
    return tuple(int(x) for x in w)


def compact_len(wks: tuple[int, ...]) -> int:
    return int(sum(wks))


def compact_slot_w(slot_w: np.ndarray, wks: tuple[int, ...]) -> np.ndarray:
    """(..., K, 3, bp) → (..., 3, L) prefix-compacted weights (host)."""
    K = slot_w.shape[-3]
    check(K == len(wks), "wks length %d != kslots %d", len(wks), K)
    parts = [slot_w[..., k, :, :w] for k, w in enumerate(wks) if w]
    return np.concatenate(parts, axis=-1)


def slot_src_cols(plan: BlockPlan) -> np.ndarray:
    """Resolve each slot's W-index to its DEVICE column: (nblocks, K, BP) i32.

    Own-table entries (widx < bp) live at block_base + widx; ext entries at
    ext_idx[b, widx - bp].  Padding slots resolve to some valid column — their
    zero weight kills the contribution exactly.  This is the index set the
    PACKED formulation pre-gathers at state-distribution time."""
    nb, K, bp = plan.slot_idx.shape
    base = plan.block_ids.astype(np.int64)[:, None, None] * bp
    widx = plan.slot_idx.astype(np.int64)
    own = base + widx
    ext = np.take_along_axis(
        plan.ext_idx.astype(np.int64)[:, None, :],
        np.clip(widx - bp, 0, plan.ep - 1),
        axis=2,
    )
    return np.where(widx < bp, own, ext).astype(np.int32)


def compact_src_cols(plan: BlockPlan, wks: tuple[int, ...]) -> np.ndarray:
    """(nblocks, L) i32 device column of every entry of the COMPACT packed
    table: `slot_src_cols` prefix-compacted exactly like `compact_slot_w`
    compacts the weights (slot k's first wks[k] lanes at offset
    Σ_{j<k} wks[j]; zero-width slots absent).  The pack kernel gathers
    `var_T[:, src_cols]` straight from the state — no ext tables."""
    cols = slot_src_cols(plan)
    check(cols.shape[1] == len(wks), "wks length %d != kslots %d",
          len(wks), cols.shape[1])
    parts = [cols[:, k, :w] for k, w in enumerate(wks) if w]
    return np.ascontiguousarray(np.concatenate(parts, axis=-1))


def compact_widx(plan: BlockPlan, wks: tuple[int, ...]) -> np.ndarray:
    """(nblocks, L) i32 W-index of every entry of the COMPACT packed table:
    `slot_idx` prefix-compacted exactly like `compact_slot_w` compacts the
    weights.  Own columns sit at [0, bp), ext column r at bp + r
    (`ext_idx[b, r]`), so resolving it against the block's staged columns
    gives `compact_src_cols`."""
    K = plan.slot_idx.shape[1]
    check(K == len(wks), "wks length %d != kslots %d", len(wks), K)
    parts = [plan.slot_idx[:, k, :w] for k, w in enumerate(wks) if w]
    return np.ascontiguousarray(np.concatenate(parts, axis=-1), np.int32)


def _pad_plan_dims(plan: BlockPlan, ep: int, kslots: int) -> BlockPlan:
    """Zero-pad a plan's per-block tables to uniform (ep, kslots).

    Copy of `cfd_proxy_tpu/models/gradients_pallas.py::_pad_plan_dims`
    (held equal by tests/test_torch_plan.py).  Pure padding is EQUIVALENT
    to rebuilding with pads=(ep, kslots): ext W-indices (bp+rank) depend
    only on the block's own sorted ext list, and extra slots carry zero
    weights (inert)."""
    import dataclasses

    if (plan.ep, plan.kslots) == (ep, kslots):
        return plan

    def pad(a, axis, to):
        grow = to - a.shape[axis]
        if grow == 0:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, grow)
        return np.pad(a, widths)

    return dataclasses.replace(
        plan, ep=ep, kslots=kslots,
        slot_idx=pad(plan.slot_idx, 1, kslots),
        slot_w=pad(plan.slot_w, 1, kslots),
        ext_idx=pad(plan.ext_idx, 1, ep),
    )


def _pad_blocks(plan: BlockPlan, nblocks: int, trash_block: int) -> BlockPlan:
    """Pad a compact block list to a uniform grid length with inert entries.

    Copy of `cfd_proxy_tpu/models/gradients_pallas.py::_pad_blocks`.  Pad
    entries target the dedicated TRASH block (no real points); the port's
    kernels skip every pad entry that repeats its predecessor
    (csrc/sweep_common.cuh)."""
    import dataclasses

    extra = nblocks - plan.nblocks
    if extra <= 0:
        return plan

    def pad(a, fill=0):
        shape = (extra, *a.shape[1:])
        return np.concatenate([a, np.full(shape, fill, a.dtype)], axis=0)

    return dataclasses.replace(
        plan,
        nblocks=nblocks,
        block_ids=np.concatenate(
            [plan.block_ids, np.full(extra, trash_block, np.int32)]),
        slot_idx=pad(plan.slot_idx),
        slot_w=pad(plan.slot_w),
        ext_idx=pad(plan.ext_idx),
        scale=pad(plan.scale),
        ext_cnt=(None if plan.ext_cnt is None else pad(plan.ext_cnt)),
    )


def _build_block_plan_native(faces, normals, npoint_dev, inv_scale, bp,
                             face_sel, all_blocks, pads,
                             dst_lt=None) -> BlockPlan | None:
    """Native (C++) fast path — same semantics as the NumPy construction.

    Built by the port's loader (native.py); returns None (→ NumPy
    fallback) if absent."""
    import ctypes

    from cfd_proxy_tpu_torch.native import lib, ptr

    L = lib()
    if L is None:
        return None
    faces_c = np.ascontiguousarray(faces, np.int32)
    normals_c = np.ascontiguousarray(normals, np.float64)
    F = faces_c.shape[0]
    sel = (None if face_sel is None
           else np.ascontiguousarray(face_sel, np.uint8))
    sel_p = None if sel is None else ptr(sel, ctypes.c_uint8)
    nblk_total = npoint_dev // bp
    dlt = npoint_dev if dst_lt is None else int(dst_lt)
    kmax = ctypes.c_int32(0)
    extmax = ctypes.c_int32(0)
    touched = np.zeros(nblk_total, np.uint8)
    rc = L.cfd_plan_sizes(
        ptr(faces_c, ctypes.c_int32), F, sel_p, npoint_dev, bp, dlt,
        ctypes.byref(kmax), ctypes.byref(extmax), ptr(touched, ctypes.c_uint8),
    )
    check(rc == 0, "cfd_plan_sizes failed rc=%d", rc)
    ep = round_up(max(int(extmax.value), 1), LANE)
    ks = max(int(kmax.value), 1)
    if pads is not None:
        check(pads[0] >= ep, "pads ep %d < required %d", pads[0], ep)
        check(pads[1] >= ks, "pads kslots %d < required %d", pads[1], ks)
        ep, ks = pads

    if all_blocks:
        blocks = np.arange(nblk_total)
    else:
        blocks = np.flatnonzero(touched)
        if blocks.size == 0:
            blocks = np.zeros(1, np.int64)
    # the C fill writes COMPACT rows via this map — a sparse face class on a
    # big padded shard allocates only its touched blocks, like the NumPy path
    blk_pos = np.full(nblk_total, -1, np.int32)
    blk_pos[blocks] = np.arange(len(blocks), dtype=np.int32)
    nrows = len(blocks)
    slot_idx = np.zeros((nrows, ks, bp), np.int32)
    slot_w = np.zeros((nrows, ks, 3, bp), np.float32)
    ext_idx = np.zeros((nrows, ep), np.int32)
    ext_cnt = np.zeros(nrows, np.int32)
    rc = L.cfd_plan_fill(
        ptr(faces_c, ctypes.c_int32), F, ptr(normals_c, ctypes.c_double),
        sel_p, npoint_dev, bp, dlt, ks, ep, ptr(blk_pos, ctypes.c_int32),
        ptr(slot_idx, ctypes.c_int32), ptr(slot_w, ctypes.c_float),
        ptr(ext_idx, ctypes.c_int32), ptr(ext_cnt, ctypes.c_int32),
    )
    check(rc == 0, "cfd_plan_fill failed rc=%d", rc)

    scale = np.zeros((nrows, 1, bp), np.float32)
    for bi, b in enumerate(blocks):
        scale[bi, 0, :] = inv_scale[b * bp : (b + 1) * bp]
    return BlockPlan(
        npoint_dev=npoint_dev, bp=bp, ep=ep, kslots=ks, nblocks=nrows,
        block_ids=blocks.astype(np.int32),
        slot_idx=slot_idx, slot_w=slot_w,
        ext_idx=ext_idx, scale=scale, ext_cnt=ext_cnt,
    )
