"""Block-local Green-Gauss sweep, its source pack and the fused overlap
sweep — kernel wrappers, over P shards held on one device.

Counterpart of `cfd_proxy_tpu/ops/blocksweep.py` for the packed COMPACT
layout in f32 (op "gg").  Every operand carries a leading shard axis P: the
reference runs one shard per chip under `shard_map`; here all shards sit on
one device and one launch covers them.  Each wrapper checks its inputs and
then

- on CPU tensors runs the plain PyTorch version beside it (`*_ref`), the
  version the CPU tests hold against the JAX reference;
- on CUDA tensors launches its hand-written kernel (`csrc/`) on the current
  stream, never synchronises, and raises if the launch fails.

There is no fallback from one to the other.  Each wrapper counts its kernel
launches in a plain integer attribute (`pack_srcs.launches`,
`sweep_blocks.launches` and, for the accumulate form,
`sweep_blocks.init_launches`, `sweep_blocks_overlap.launches`), so a run
can show that its main path went through the kernels.

Compact layout (ops/plan.py): slot k of block b covers lanes [0, wks[k]) at
offset off_k = Σ_{j<k} wks[j] of the (P, nb, NV, L) source table and the
(P, nb, 3, L) weight table, L = Σ wks; zero-width slots hold no entries.  The
kernels read (wks, off) as a (2, K) int32 tensor, `slot_table(wks)`.

Block lists are strictly ascending per shard, padded at the end with
repeats of the trash block (models/gradients.py); the kernels skip a repeat.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cfd_proxy_tpu.utils.errors import check
from cfd_proxy_tpu_torch.ops.plan import NV

ROWS = 3 * NV          # gradient rows d*NV+v
MAX_SLOTS = 64         # slot-table capacity of the sweep kernel


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

def sweep_blocks_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                     slot_w: torch.Tensor, scale: torch.Tensor,
                     block_ids: torch.Tensor, slots: torch.Tensor,
                     init: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the sweep, slot by slot over all shards and blocks
    at once, in the reference body's operation order
    (_block_compute_packed): acc = init (or 0); avg = 0.5·(own + src_k);
    acc += w_k ⊗ avg; out = acc·scale.  With init, init is updated in place
    and returned.  An entry that repeats its predecessor (a pad entry) is
    computed but not stored, as the kernels skip it."""
    P, nb, _, L = srcs.shape
    bp = scale.shape[-1]
    ndev = var_T.shape[2]
    dev = var_T.device
    lanes = torch.arange(bp, device=dev)
    flat = (block_ids.long()[:, :, None] * bp + lanes).reshape(P, 1, nb * bp)
    own = torch.gather(var_T, 2, flat.expand(P, NV, nb * bp))
    own = own.reshape(P, NV, nb, bp).permute(0, 2, 1, 3)      # (P, nb, NV, bp)
    if init is None:
        acc = torch.zeros((P, nb, 3, NV, bp), dtype=torch.float32, device=dev)
        out = torch.zeros((P, ROWS, ndev + bp), dtype=torch.float32,
                          device=dev)
    else:
        acc = torch.gather(init, 2, flat.expand(P, ROWS, nb * bp))
        acc = acc.reshape(P, 3, NV, nb, bp).permute(0, 3, 1, 2, 4).clone()
        out = torch.cat([init, init.new_zeros((P, ROWS, bp))], 2)
    # repeats store into a scratch block past ndev, dropped below
    first = torch.ones_like(block_ids, dtype=torch.bool)
    first[:, 1:] = block_ids[:, 1:] != block_ids[:, :-1]
    store = torch.where(first, block_ids.long(), ndev // bp)
    store = (store[:, :, None] * bp + lanes).reshape(P, 1, nb * bp)
    widths, offs = slots.tolist()
    for w, off in zip(widths, offs):
        if w == 0:
            continue
        avg = 0.5 * (own[..., :w] + srcs[..., off:off + w])   # (P, nb, NV, w)
        wk = slot_w[..., off:off + w]                          # (P, nb, 3, w)
        acc[..., :w] = acc[..., :w] + wk[:, :, :, None, :] * avg[:, :, None]
    res = acc.reshape(P, nb, ROWS, bp) * scale                 # (P, nb, 24, bp)
    out.scatter_(2, store.expand(P, ROWS, nb * bp),
                 res.permute(0, 2, 1, 3).reshape(P, ROWS, nb * bp))
    if init is None:
        return out[:, :, :ndev].contiguous()
    return init.copy_(out[:, :, :ndev])


def _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init):
    """Validate the sweep operands; returns (P, nb, L, bp, ndev, K)."""
    dev = var_T.device
    _expect(var_T, "var_T", torch.float32, 3, dev)
    _expect(srcs, "srcs", torch.float32, 4, dev)
    _expect(slot_w, "slot_w", torch.float32, 4, dev)
    _expect(scale, "scale", torch.float32, 4, dev)
    _expect(block_ids, "block_ids", torch.int32, 2, dev)
    _expect(slots, "slots", torch.int32, 2, dev)
    P, nb, _, L = srcs.shape
    bp = scale.shape[3]
    ndev = var_T.shape[2]
    K = slots.shape[1]
    _shape(var_T, "var_T", (P, NV, ndev))
    _shape(srcs, "srcs", (P, nb, NV, L))
    _shape(slot_w, "slot_w", (P, nb, 3, L))
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
        _shape(init, "init", (P, ROWS, ndev))
    return P, nb, L, bp, ndev, K


def _sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims):
    P, nb, L, bp, ndev, K = dims
    return (var_T.data_ptr(), ndev, srcs.data_ptr(), slot_w.data_ptr(),
            scale.data_ptr(), block_ids.data_ptr(), slots.data_ptr(), K, P,
            nb, L, bp)


def sweep_blocks(var_T: torch.Tensor, srcs: torch.Tensor,
                 slot_w: torch.Tensor, scale: torch.Tensor,
                 block_ids: torch.Tensor, slots: torch.Tensor,
                 init: torch.Tensor | None = None) -> torch.Tensor:
    """Packed compact Green-Gauss sweep → (P, 3·NV, ndev) f32, row d*NV+v.

    var_T (P, NV, ndev) f32; srcs (P, nb, NV, L) f32 from `pack_srcs`;
    slot_w (P, nb, 3, L) f32; scale (P, nb, 1, bp) f32; block_ids (P, nb)
    i32; slots (2, K) i32 from `slot_table`.  Without init, columns of
    blocks the plan does not list are zero.  With init (P, 3·NV, ndev) f32
    the sweep accumulates onto it IN PLACE and returns it — the reference
    aliases init to the output, so unlisted columns keep init's values.
    Counterpart of `cfd_proxy_tpu.ops.blocksweep.sweep_blocks(...,
    packed=True, wks=..., init=...)`.  Kernel: csrc/sweep_packed.cu."""
    dims = _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                                init)
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = var_T.device
    P, _, _, _, ndev, _ = dims
    out = (torch.zeros((P, ROWS, ndev), dtype=torch.float32, device=dev)
           if init is None else init)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_packed(
            *_sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims),
            int(init is not None), out.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks")
    if init is None:
        sweep_blocks.launches += 1
    else:
        sweep_blocks.init_launches += 1
    return out


sweep_blocks.launches = 0          # the zero-filled form (K1)
sweep_blocks.init_launches = 0     # the accumulate form (K1-init)


# ------------------------------------------------------- fused overlap

def loopback(sendbufs: torch.Tensor, dsts: torch.Tensor) -> torch.Tensor:
    """The loopback transport: recv[dsts[p, k], k] = sendbufs[p, k], zeros
    where no shard sends.  sendbufs (P, nph, 3·NV, s_max); dsts (P, nph)
    integer, on sendbufs' device."""
    P, nph = dsts.shape
    recv = torch.zeros_like(sendbufs)
    phase = torch.arange(nph, device=dsts.device).expand(P, nph)
    recv[dsts.long(), phase] = sendbufs
    return recv


def sweep_blocks_overlap_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                             init, sendbufs, dsts, src_devs):
    """Plain version of the fused kernel: the interior sweep accumulating
    onto init (in place), then the push of every shard's send buffers."""
    del src_devs                    # the push map alone moves the data
    grad = sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                            init)
    return grad, loopback(sendbufs, dsts.to(sendbufs.device))


def _check_push(sendbufs, dsts, src_devs, P, dev):
    _expect(sendbufs, "sendbufs", torch.float32, 4, dev)
    cpu = torch.device("cpu")
    _expect(dsts, "dsts", torch.int32, 2, cpu)
    _expect(src_devs, "src_devs", torch.int32, 2, cpu)
    nph = dsts.shape[1]
    _shape(dsts, "dsts", (P, nph))
    _shape(src_devs, "src_devs", (P, nph))
    s_max = sendbufs.shape[3]
    _shape(sendbufs, "sendbufs", (P, nph, ROWS, s_max))
    check(s_max % 4 == 0 and sendbufs.data_ptr() % 16 == 0,
          "sendbufs: s_max %d must be a multiple of 4 on a 16-byte aligned "
          "base (16-byte copies)", s_max)
    return nph, s_max


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
                         dsts: torch.Tensor, src_devs: torch.Tensor):
    """Fused interior sweep + halo push → (grad, recv).

    The sweep operands and `init` are as in `sweep_blocks` (grad is init,
    updated in place).  sendbufs (P, nph, 3·NV, s_max) f32 on the sweep's
    device: shard p's phase-k payload.  dsts / src_devs (P, nph) int32 on
    the CPU: the static push map (destination shard of p's phase-k payload,
    and the reference's `srcs`, its inverse); both are checked on the host.
    recv (P, nph, 3·NV, s_max): recv[dsts[p, k], k] = sendbufs[p, k].
    Counterpart of `cfd_proxy_tpu.ops.blocksweep.sweep_blocks_overlap`
    (packed, compact).  Kernel: csrc/sweep_overlap.cu."""
    check(init is not None, "sweep_blocks_overlap accumulates onto init")
    dims = _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init)
    dev = var_T.device
    nph, s_max = _check_push(sendbufs, dsts, src_devs, dims[0], dev)
    dmap = _push_table(dsts.numpy().tobytes(), src_devs.numpy().tobytes(),
                       tuple(dsts.shape), str(dev))
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_overlap_ref(var_T, srcs, slot_w, scale,
                                        block_ids, slots, init, sendbufs,
                                        dsts, src_devs)
    from cfd_proxy_tpu_torch.ops import _cuda

    recv = torch.zeros_like(sendbufs)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_overlap(
            *_sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims),
            init.data_ptr(), sendbufs.data_ptr(), dmap.data_ptr(), nph,
            s_max, recv.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks_overlap")
    sweep_blocks_overlap.launches += 1
    return init, recv


sweep_blocks_overlap.launches = 0
