"""Block-local sweep in its two formulations, the source pack and the fused
overlap sweep — kernel wrappers, over P shards held on one device.

Counterpart of `cfd_proxy_tpu/ops/blocksweep.py` in f32, for both of its
ops: "gg" (Green-Gauss gradients, 3·NV output rows d*NV+v) and "flux" (the
PSD upwind flux of ops/flux.py in its directed-slot form, NV output rows).
The packed formulation in the COMPACT layout (`sweep_blocks`, fed by
`pack_srcs`) and the gather formulation with rectangular slot tables
(`sweep_blocks_gather`, fed by `gather_exts`), each with its fused overlap
form.  Every operand carries a leading shard axis P: the
reference runs one shard per chip under `shard_map`; here all shards sit on
one device and one launch covers them.  Each wrapper checks its inputs and
then

- on CPU tensors runs the plain PyTorch version beside it (`*_ref`), the
  version the CPU tests hold against the JAX reference;
- on CUDA tensors launches its hand-written kernel (`csrc/`) on the current
  stream, never synchronises, and raises if the launch fails.

There is no fallback from one to the other.  Each wrapper counts its kernel
launches in plain integer attributes, one per kernel instance
(`pack_srcs.launches`; `sweep_blocks.launches`, `.init_launches` for the
accumulate form, `.flux_launches` and `.flux_init_launches` for the flux
op's two; `sweep_blocks_overlap.launches` and `.flux_launches`; the same on
the gather wrappers), so a run can show which bodies its main path ran.

Compact layout (ops/plan.py): slot k of block b covers lanes [0, wks[k]) at
offset off_k = Σ_{j<k} wks[j] of the (P, nb, NV, L) source table and the
(P, nb, 3, L) weight table, L = Σ wks; zero-width slots hold no entries.  The
kernels read (wks, off) as a (2, K) int32 tensor, `slot_table(wks)`.  The
gather tables stay rectangular: slot k of block b is lanes [0, bp) of
slot_idx (P, nb, K, bp) and slot_w (P, nb, K, 3, bp), of which the sweep
reads lanes [0, wks[k]) (the reference skips the same 128-lane tiles).

Block lists are strictly ascending per shard, padded at the end with
repeats of the trash block (models/gradients.py); the kernels skip a repeat.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cfd_proxy_tpu_torch.ops.plan import NV
from cfd_proxy_tpu_torch.utils.errors import check

OPS = ("gg", "flux")   # the kernels take an op as its index here
MAX_SLOTS = 64         # slot-table capacity of the sweep kernel


def out_rows(op: str) -> int:
    """Output row count: gradients are (3, NV) planes, fluxes (NV,)."""
    return 3 * NV if op == "gg" else NV


def _check_op(op: str) -> int:
    check(op in OPS, "unknown sweep op %r (one of %s)", op, "/".join(OPS))
    return out_rows(op)


def _count(fn, init, op: str) -> None:
    """Add one to the count of the kernel instance just launched."""
    name = ("flux_" if op == "flux" else "") + \
        ("launches" if init is None else "init_launches")
    setattr(fn, name, getattr(fn, name) + 1)


def slot_table(wks) -> np.ndarray:
    """(2, K) int32: per-slot prefix width and compact lane offset
    (exclusive prefix sum of the widths; a zero-width slot adds nothing)."""
    w = np.asarray(wks, np.int64)
    off = np.concatenate([[0], np.cumsum(w)[:-1]])
    return np.stack([w, off]).astype(np.int32)


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    check(isinstance(t, torch.Tensor), "%s must be a tensor", name)
    # one comparison: the wrappers sit on the step's host path
    got = (t.dtype, t.dim(), t.device, t.is_contiguous())
    want = (dtype, ndim, device, True)
    check(got == want, "%s: (dtype, dims, device, contiguous) %s, expected "
          "%s", name, got, want)


def _shape(t: torch.Tensor, name: str, want: tuple) -> None:
    check(tuple(t.shape) == want, "%s shape %s, expected %s", name,
          tuple(t.shape), want)


def _device_kind(t: torch.Tensor) -> str:
    check(t.device.type in ("cpu", "cuda"),
          "unsupported device %s (cpu runs the plain version, cuda the "
          "kernel)", t.device)
    return t.device.type


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------------------ pack

def pack_srcs_ref(var_T: torch.Tensor, src_cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the pack:
    out[p, b, v, j] = var_T[p, v, src_cols[p, b, j]]."""
    P, nb, L = src_cols.shape
    idx = src_cols.reshape(P, 1, nb * L).long().expand(P, NV, nb * L)
    g = torch.gather(var_T, 2, idx)                          # (P, NV, nb*L)
    return g.reshape(P, NV, nb, L).permute(0, 2, 1, 3).contiguous()


def gather_exts(var_T: torch.Tensor, ext_idx: torch.Tensor) -> torch.Tensor:
    """(P, NV, ndev) f32 × (P, nb, EP) int → (P, nb, NV, EP) f32: each
    block's ext columns, the table the gather sweep reads beside the
    block's own columns.  Counterpart of
    `cfd_proxy_tpu.ops.blocksweep.gather_exts`, which is a plain XLA take
    outside any kernel; here one torch gather on either device, written
    straight into the table's layout (an int64 index is used as it is)."""
    P, nb, ep = ext_idx.shape
    nv, ndev = var_T.shape[1:]
    return torch.gather(var_T[:, None].expand(P, nb, nv, ndev), 3,
                        ext_idx.long()[:, :, None].expand(P, nb, nv, ep))


def pack_srcs(var_T: torch.Tensor, src_cols: torch.Tensor) -> torch.Tensor:
    """(P, NV, ndev) f32 × (P, nb, L) i32 → (P, nb, NV, L) f32 packed source
    table.

    Counterpart of `cfd_proxy_tpu.ops.blocksweep.pack_srcs` (compact, f32)
    fed by `gather_exts`: `src_cols` (ops/plan.py::compact_src_cols) already
    resolves every slot to its device column.  Kernel: csrc/pack_srcs.cu."""
    dev = var_T.device
    _expect(var_T, "var_T", torch.float32, 3, dev)
    _expect(src_cols, "src_cols", torch.int32, 3, dev)
    P, nb, L = src_cols.shape
    _shape(var_T, "var_T", (P, NV, var_T.shape[2]))
    if _device_kind(var_T) == "cpu":
        return pack_srcs_ref(var_T, src_cols)
    from cfd_proxy_tpu_torch.ops import _cuda

    out = torch.empty((P, nb, NV, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_pack_srcs(
            var_T.data_ptr(), var_T.shape[2], src_cols.data_ptr(), P, nb, L,
            out.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "pack_srcs")
    pack_srcs.launches += 1
    return out


pack_srcs.launches = 0


# ----------------------------------------------------------------- sweep

def _slot_contrib(op, own, src, wk):
    """One slot's terms over lanes [0, w): own and src (P, nb, NV, w),
    weights wk (P, nb, 3, w) → (P, nb, rows, w), in the reference body's
    operation order.

    gg: avg = 0.5·(own + src); w ⊗ avg, row d*NV+v.
    flux (the directed-slot form of ops/flux.py): udw = own[:3]·w,
    uow = src[:3]·w, a = max(|udw|, |uow|);
    0.5·(udw·own + uow·src) − 0.5·a·(src − own)."""
    P, nb, _, w = own.shape
    if op == "gg":
        avg = 0.5 * (own + src)
        return (wk[:, :, :, None, :] * avg[:, :, None]).reshape(P, nb, -1, w)
    udw = (own[:, :, :3] * wk).sum(2, keepdim=True)           # (P, nb, 1, w)
    uow = (src[:, :, :3] * wk).sum(2, keepdim=True)
    a = torch.maximum(udw.abs(), uow.abs())
    return 0.5 * (udw * own + uow * src) - 0.5 * a * (src - own)


def _sweep_plain(var_T, scale, block_ids, slots, init, slot_terms, op):
    """The sweep's plain body, slot by slot over all shards and blocks at
    once, in the reference body's operation order: acc = init (or 0);
    acc += slot k's terms (`_slot_contrib`); out = acc·scale.

    slot_terms(k, w, off, own) gives slot k's sources (P, nb, NV, w) and
    weights (P, nb, 3, w) over lanes [0, w); own is (P, nb, NV, bp).  With
    init, init is updated in place and returned.  An entry that repeats its
    predecessor (a pad entry) is computed but not stored, as the kernels
    skip it."""
    rows = out_rows(op)
    P, nb = block_ids.shape
    bp = scale.shape[-1]
    ndev = var_T.shape[2]
    dev = var_T.device
    lanes = torch.arange(bp, device=dev)
    flat = (block_ids.long()[:, :, None] * bp + lanes).reshape(P, 1, nb * bp)
    own = torch.gather(var_T, 2, flat.expand(P, NV, nb * bp))
    own = own.reshape(P, NV, nb, bp).permute(0, 2, 1, 3)      # (P, nb, NV, bp)
    if init is None:
        acc = torch.zeros((P, nb, rows, bp), dtype=torch.float32, device=dev)
        out = torch.zeros((P, rows, ndev + bp), dtype=torch.float32,
                          device=dev)
    else:
        acc = torch.gather(init, 2, flat.expand(P, rows, nb * bp))
        acc = acc.reshape(P, rows, nb, bp).permute(0, 2, 1, 3).clone()
        out = torch.cat([init, init.new_zeros((P, rows, bp))], 2)
    # repeats store into a scratch block past ndev, dropped below
    first = torch.ones_like(block_ids, dtype=torch.bool)
    first[:, 1:] = block_ids[:, 1:] != block_ids[:, :-1]
    store = torch.where(first, block_ids.long(), ndev // bp)
    store = (store[:, :, None] * bp + lanes).reshape(P, 1, nb * bp)
    widths, offs = slots.tolist()
    for k, (w, off) in enumerate(zip(widths, offs)):
        if w == 0:
            continue
        src, wk = slot_terms(k, w, off, own)
        acc[..., :w] = acc[..., :w] + _slot_contrib(op, own[..., :w], src, wk)
    res = acc * scale                                      # (P, nb, rows, bp)
    out.scatter_(2, store.expand(P, rows, nb * bp),
                 res.permute(0, 2, 1, 3).reshape(P, rows, nb * bp))
    if init is None:
        return out[:, :, :ndev].contiguous()
    return init.copy_(out[:, :, :ndev])


def sweep_blocks_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                     slot_w: torch.Tensor, scale: torch.Tensor,
                     block_ids: torch.Tensor, slots: torch.Tensor,
                     init: torch.Tensor | None = None,
                     op: str = "gg") -> torch.Tensor:
    """Plain version of the packed sweep (_block_compute_packed): slot k's
    sources and weights are lanes [off_k, off_k + wks[k]) of the compact
    tables."""
    return _sweep_plain(
        var_T, scale, block_ids, slots, init,
        lambda k, w, off, own: (srcs[..., off:off + w],
                                slot_w[..., off:off + w]), op)


def _check_common(var_T, scale, block_ids, slots, init, P, nb, rows):
    """Validate the operands both formulations share; returns (bp, ndev,
    K)."""
    dev = var_T.device
    _expect(var_T, "var_T", torch.float32, 3, dev)
    _expect(scale, "scale", torch.float32, 4, dev)
    _expect(block_ids, "block_ids", torch.int32, 2, dev)
    _expect(slots, "slots", torch.int32, 2, dev)
    bp = scale.shape[3]
    ndev = var_T.shape[2]
    K = slots.shape[1]
    _shape(var_T, "var_T", (P, NV, ndev))
    _shape(scale, "scale", (P, nb, 1, bp))
    _shape(block_ids, "block_ids", (P, nb))
    check(slots.shape[0] == 2 and 1 <= K <= MAX_SLOTS,
          "slots shape %s: expected (2, K) with 1 <= K <= %d",
          tuple(slots.shape), MAX_SLOTS)
    check(bp > 0 and ndev % bp == 0, "ndev %d not a multiple of bp %d",
          ndev, bp)
    if init is not None:
        # the reference aliases init to the output (blocksweep.py:588-591)
        _expect(init, "init", torch.float32, 3, dev)
        _shape(init, "init", (P, rows, ndev))
    return bp, ndev, K


def _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init, rows):
    """Validate the packed sweep's operands; returns (P, nb, L, bp, ndev,
    K)."""
    _expect(srcs, "srcs", torch.float32, 4, var_T.device)
    _expect(slot_w, "slot_w", torch.float32, 4, var_T.device)
    P, nb, _, L = srcs.shape
    bp, ndev, K = _check_common(var_T, scale, block_ids, slots, init, P, nb,
                                rows)
    _shape(srcs, "srcs", (P, nb, NV, L))
    _shape(slot_w, "slot_w", (P, nb, 3, L))
    return P, nb, L, bp, ndev, K


def _sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims):
    P, nb, L, bp, ndev, K = dims
    return (var_T.data_ptr(), ndev, srcs.data_ptr(), slot_w.data_ptr(),
            scale.data_ptr(), block_ids.data_ptr(), slots.data_ptr(), K, P,
            nb, L, bp)


def sweep_blocks(var_T: torch.Tensor, srcs: torch.Tensor,
                 slot_w: torch.Tensor, scale: torch.Tensor,
                 block_ids: torch.Tensor, slots: torch.Tensor,
                 init: torch.Tensor | None = None,
                 op: str = "gg") -> torch.Tensor:
    """Packed compact sweep → (P, rows, ndev) f32: op "gg" gives 3·NV
    gradient rows d*NV+v, op "flux" NV flux rows.

    var_T (P, NV, ndev) f32; srcs (P, nb, NV, L) f32 from `pack_srcs`;
    slot_w (P, nb, 3, L) f32; scale (P, nb, 1, bp) f32; block_ids (P, nb)
    i32; slots (2, K) i32 from `slot_table`.  Without init, columns of
    blocks the plan does not list are zero.  With init (P, rows, ndev) f32
    the sweep accumulates onto it IN PLACE and returns it — the reference
    aliases init to the output, so unlisted columns keep init's values.
    Counterpart of `cfd_proxy_tpu.ops.blocksweep.sweep_blocks(...,
    packed=True, wks=..., init=..., op=...)`.  Kernel:
    csrc/sweep_packed.cu."""
    rows = _check_op(op)
    dims = _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init,
                        rows)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                                init, op)
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = var_T.device
    P, _, _, _, ndev, _ = dims
    out = (torch.zeros((P, rows, ndev), dtype=torch.float32, device=dev)
           if init is None else init)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_packed(
            *_sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims),
            int(init is not None), OPS.index(op), out.data_ptr(),
            _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks")
    _count(sweep_blocks, init, op)
    return out


sweep_blocks.launches = 0          # gg, the zero-filled form (K1)
sweep_blocks.init_launches = 0     # gg, the accumulate form (K1-init)
sweep_blocks.flux_launches = 0     # flux, zero-filled (K1-flux)
sweep_blocks.flux_init_launches = 0   # flux, accumulate (K1-flux-init)


# ---------------------------------------------------------- gather sweep

def sweep_blocks_gather_ref(var_T: torch.Tensor, exts: torch.Tensor,
                            slot_idx: torch.Tensor, slot_w: torch.Tensor,
                            scale: torch.Tensor, block_ids: torch.Tensor,
                            slots: torch.Tensor,
                            init: torch.Tensor | None = None,
                            op: str = "gg") -> torch.Tensor:
    """Plain version of the gather sweep (_block_compute): slot k's sources
    are gathered from the block table [own ‖ exts] (P, nb, NV, bp + EP) by
    the W-index slot_idx[..., k, :w], its weights are slot_w[..., k, :, :w],
    w = wks[k]."""
    tbl = None

    def terms(k, w, off, own):
        nonlocal tbl
        if tbl is None:
            tbl = torch.cat([own, exts], dim=3)
        P, nb = slot_idx.shape[:2]
        idx = slot_idx[:, :, k, None, :w].long().expand(P, nb, NV, w)
        return torch.gather(tbl, 3, idx), slot_w[:, :, k, :, :w]

    return _sweep_plain(var_T, scale, block_ids, slots, init, terms, op)


def _check_gather(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                  init, rows):
    """Validate the gather sweep's operands; returns (P, nb, EP, bp, ndev,
    K).  The W-indices' range is checked where the plan is loaded
    (models/gradients.py), not per call."""
    dev = var_T.device
    _expect(exts, "exts", torch.float32, 4, dev)
    _expect(slot_idx, "slot_idx", torch.int32, 4, dev)
    _expect(slot_w, "slot_w", torch.float32, 5, dev)
    P, nb, _, ep = exts.shape
    bp, ndev, K = _check_common(var_T, scale, block_ids, slots, init, P, nb,
                                rows)
    _shape(exts, "exts", (P, nb, NV, ep))
    _shape(slot_idx, "slot_idx", (P, nb, K, bp))
    _shape(slot_w, "slot_w", (P, nb, K, 3, bp))
    check(ep > 0, "exts: EP must be positive")
    return P, nb, ep, bp, ndev, K


def _gather_ptrs(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                 dims):
    P, nb, ep, bp, ndev, K = dims
    return (var_T.data_ptr(), ndev, exts.data_ptr(), ep, slot_idx.data_ptr(),
            slot_w.data_ptr(), scale.data_ptr(), block_ids.data_ptr(),
            slots.data_ptr(), K, P, nb, bp)


def sweep_blocks_gather(var_T: torch.Tensor, exts: torch.Tensor,
                        slot_idx: torch.Tensor, slot_w: torch.Tensor,
                        scale: torch.Tensor, block_ids: torch.Tensor,
                        slots: torch.Tensor,
                        init: torch.Tensor | None = None,
                        op: str = "gg") -> torch.Tensor:
    """Gather-formulation sweep → (P, rows, ndev) f32, rows as in
    `sweep_blocks`.

    var_T (P, NV, ndev) f32; exts (P, nb, NV, EP) f32 from `gather_exts`;
    slot_idx (P, nb, K, bp) i32 W-indices in [0, bp + EP); slot_w
    (P, nb, K, 3, bp) f32; scale, block_ids and init as in `sweep_blocks`;
    slots (2, K) i32 from `slot_table(wks)` (only the widths are read).
    Counterpart of `cfd_proxy_tpu.ops.blocksweep.sweep_blocks(...,
    packed=False, wks=..., init=..., op=...)`.  Kernel:
    csrc/sweep_gather.cu."""
    rows = _check_op(op)
    dims = _check_gather(var_T, exts, slot_idx, slot_w, scale, block_ids,
                         slots, init, rows)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_gather_ref(var_T, exts, slot_idx, slot_w, scale,
                                       block_ids, slots, init, op)
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = var_T.device
    P, _, _, _, ndev, _ = dims
    out = (torch.zeros((P, rows, ndev), dtype=torch.float32, device=dev)
           if init is None else init)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_gather(
            *_gather_ptrs(var_T, exts, slot_idx, slot_w, scale, block_ids,
                          slots, dims),
            int(init is not None), OPS.index(op), out.data_ptr(),
            _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks_gather")
    _count(sweep_blocks_gather, init, op)
    return out


sweep_blocks_gather.launches = 0          # gg, zero-filled (K2)
sweep_blocks_gather.init_launches = 0     # gg, accumulate (K2-init)
sweep_blocks_gather.flux_launches = 0     # flux, zero-filled (K2-flux)
sweep_blocks_gather.flux_init_launches = 0   # flux, accumulate


# ------------------------------------------------------- fused overlap

def loopback(sendbufs: torch.Tensor, dsts: torch.Tensor) -> torch.Tensor:
    """The loopback transport: recv[dsts[p, k], k] = sendbufs[p, k], zeros
    where no shard sends.  sendbufs (P, nph, rows, s_max): 3·NV gradient
    rows, NV flux rows or NV state rows; dsts (P, nph) integer, on
    sendbufs' device."""
    P, nph = dsts.shape
    recv = torch.zeros_like(sendbufs)
    phase = torch.arange(nph, device=dsts.device).expand(P, nph)
    recv[dsts.long(), phase] = sendbufs
    return recv


def sweep_blocks_overlap_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                             init, sendbufs, dsts, src_devs, op="gg"):
    """Plain version of the fused kernel: the interior sweep accumulating
    onto init (in place), then the push of every shard's send buffers."""
    del src_devs                    # the push map alone moves the data
    grad = sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                            init, op)
    return grad, loopback(sendbufs, dsts.to(sendbufs.device))


def _check_push(sendbufs, dsts, src_devs, P, dev, rows):
    """Validate the push operands; returns (nph, s_max, the device copy of
    the push map)."""
    _expect(sendbufs, "sendbufs", torch.float32, 4, dev)
    cpu = torch.device("cpu")
    _expect(dsts, "dsts", torch.int32, 2, cpu)
    _expect(src_devs, "src_devs", torch.int32, 2, cpu)
    nph = dsts.shape[1]
    _shape(dsts, "dsts", (P, nph))
    _shape(src_devs, "src_devs", (P, nph))
    s_max = sendbufs.shape[3]
    _shape(sendbufs, "sendbufs", (P, nph, rows, s_max))
    check(s_max % 4 == 0 and sendbufs.data_ptr() % 16 == 0,
          "sendbufs: s_max %d must be a multiple of 4 on a 16-byte aligned "
          "base (16-byte copies)", s_max)
    dmap = _push_table(dsts.numpy().tobytes(), src_devs.numpy().tobytes(),
                       tuple(dsts.shape), str(dev))
    return nph, s_max, dmap


@lru_cache(maxsize=16)
def _push_table(dsts: bytes, src_devs: bytes, shape: tuple,
                device: str) -> torch.Tensor:
    """Check a push map once per distinct map and hold its device copy.

    Every dsts[:, k] must be a permutation of the shards and src_devs[:, k]
    its inverse: one push per receiver, so no two shards write the same
    recv buffer.  A map that fails raises (and is not cached)."""
    P, nph = shape
    d = np.frombuffer(dsts, np.int32).reshape(shape)
    s = np.frombuffer(src_devs, np.int32).reshape(shape)
    check(((d >= 0) & (d < P)).all(), "dsts outside [0, %d): %s", P,
          np.unique(d[(d < 0) | (d >= P)]).tolist())
    check((s[d, np.arange(nph)[None, :]] == np.arange(P)[:, None]).all(),
          "dsts/src_devs are not mutually inverse permutations per phase")
    return torch.from_numpy(d.copy()).to(device)


def sweep_blocks_overlap(var_T: torch.Tensor, srcs: torch.Tensor,
                         slot_w: torch.Tensor, scale: torch.Tensor,
                         block_ids: torch.Tensor, slots: torch.Tensor,
                         init: torch.Tensor, sendbufs: torch.Tensor,
                         dsts: torch.Tensor, src_devs: torch.Tensor,
                         op: str = "gg"):
    """Fused interior sweep + halo push → (grad, recv).

    The sweep operands, `init` and `op` are as in `sweep_blocks` (grad is
    init, updated in place).  sendbufs (P, nph, rows, s_max) f32 on the
    sweep's device: shard p's phase-k payload.  dsts / src_devs (P, nph)
    int32 on the CPU: the static push map (destination shard of p's phase-k
    payload, and the reference's `srcs`, its inverse); both are checked on
    the host.  recv (P, nph, rows, s_max): recv[dsts[p, k], k] =
    sendbufs[p, k].  Counterpart of
    `cfd_proxy_tpu.ops.blocksweep.sweep_blocks_overlap` (packed, compact).
    Kernel: csrc/sweep_overlap.cu."""
    check(init is not None, "sweep_blocks_overlap accumulates onto init")
    rows = _check_op(op)
    dims = _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init,
                        rows)
    dev = var_T.device
    nph, s_max, dmap = _check_push(sendbufs, dsts, src_devs, dims[0], dev,
                                   rows)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_overlap_ref(var_T, srcs, slot_w, scale,
                                        block_ids, slots, init, sendbufs,
                                        dsts, src_devs, op)
    from cfd_proxy_tpu_torch.ops import _cuda

    recv = torch.zeros_like(sendbufs)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_overlap(
            *_sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims),
            OPS.index(op), init.data_ptr(), sendbufs.data_ptr(),
            dmap.data_ptr(), nph, s_max, recv.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks_overlap")
    _count(sweep_blocks_overlap, None, op)
    return init, recv


sweep_blocks_overlap.launches = 0          # gg (K3)
sweep_blocks_overlap.flux_launches = 0     # flux (K3-flux)


def sweep_blocks_overlap_gather_ref(var_T, exts, slot_idx, slot_w, scale,
                                    block_ids, slots, init, sendbufs, dsts,
                                    src_devs, op="gg"):
    """Plain version of the fused kernel's gather form."""
    del src_devs
    grad = sweep_blocks_gather_ref(var_T, exts, slot_idx, slot_w, scale,
                                   block_ids, slots, init, op)
    return grad, loopback(sendbufs, dsts.to(sendbufs.device))


def sweep_blocks_overlap_gather(var_T: torch.Tensor, exts: torch.Tensor,
                                slot_idx: torch.Tensor, slot_w: torch.Tensor,
                                scale: torch.Tensor, block_ids: torch.Tensor,
                                slots: torch.Tensor, init: torch.Tensor,
                                sendbufs: torch.Tensor, dsts: torch.Tensor,
                                src_devs: torch.Tensor, op: str = "gg"):
    """Fused interior sweep (gather formulation) + halo push → (grad,
    recv): the sweep operands as in `sweep_blocks_gather`, the push as in
    `sweep_blocks_overlap`.  Counterpart of
    `cfd_proxy_tpu.ops.blocksweep.sweep_blocks_overlap(..., packed=False)`.
    Kernel: csrc/sweep_overlap.cu (its gather instances)."""
    check(init is not None, "sweep_blocks_overlap_gather accumulates onto "
          "init")
    rows = _check_op(op)
    dims = _check_gather(var_T, exts, slot_idx, slot_w, scale, block_ids,
                         slots, init, rows)
    dev = var_T.device
    nph, s_max, dmap = _check_push(sendbufs, dsts, src_devs, dims[0], dev,
                                   rows)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_overlap_gather_ref(
            var_T, exts, slot_idx, slot_w, scale, block_ids, slots, init,
            sendbufs, dsts, src_devs, op)
    from cfd_proxy_tpu_torch.ops import _cuda

    recv = torch.zeros_like(sendbufs)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_overlap_gather(
            *_gather_ptrs(var_T, exts, slot_idx, slot_w, scale, block_ids,
                          slots, dims),
            OPS.index(op), init.data_ptr(), sendbufs.data_ptr(),
            dmap.data_ptr(), nph, s_max, recv.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks_overlap_gather")
    _count(sweep_blocks_overlap_gather, None, op)
    return init, recv


sweep_blocks_overlap_gather.launches = 0          # gg (K3-gather)
sweep_blocks_overlap_gather.flux_launches = 0     # flux (K3-gather-flux)
