"""Block-local Green-Gauss sweep and its source pack — kernel wrappers.

Counterpart of `cfd_proxy_tpu/ops/blocksweep.py` for the packed COMPACT
layout in f32 (op "gg", no accumulate operand).  Each wrapper checks its
inputs and then

- on CPU tensors runs the plain PyTorch version beside it (`*_ref`), the
  version the CPU tests hold against the JAX reference;
- on CUDA tensors launches its hand-written kernel (`csrc/`) on the current
  stream, never synchronises, and raises if the launch fails.

There is no fallback from one to the other.  Each wrapper counts its kernel
launches in a plain integer attribute (`sweep_blocks.launches`,
`pack_srcs.launches`), so a run can show that its main path went through the
kernels.

Compact layout (ops/plan.py): slot k of block b covers lanes [0, wks[k]) at
offset off_k = Σ_{j<k} wks[j] of the (nb, NV, L) source table and the
(nb, 3, L) weight table, L = Σ wks; zero-width slots hold no entries.  The
kernels read (wks, off) as a (2, K) int32 tensor, `slot_table(wks)`.
"""

from __future__ import annotations

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
    check(t.dtype == dtype, "%s: dtype %s, expected %s", name, t.dtype, dtype)
    check(t.dim() == ndim, "%s: %d dims, expected %d", name, t.dim(), ndim)
    check(t.device == device, "%s on %s, expected %s", name, t.device, device)
    check(t.is_contiguous(), "%s must be contiguous", name)


def _device_kind(t: torch.Tensor) -> str:
    check(t.device.type in ("cpu", "cuda"),
          "unsupported device %s (cpu runs the plain version, cuda the "
          "kernel)", t.device)
    return t.device.type


# ------------------------------------------------------------------ pack

def pack_srcs_ref(var_T: torch.Tensor, src_cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the pack: out[b, v, j] = var_T[v, src_cols[b, j]]."""
    nb, L = src_cols.shape
    g = var_T[:, src_cols.reshape(-1).long()]              # (NV, nb*L)
    return g.reshape(var_T.shape[0], nb, L).permute(1, 0, 2).contiguous()


def pack_srcs(var_T: torch.Tensor, src_cols: torch.Tensor) -> torch.Tensor:
    """(NV, ndev) f32 × (nb, L) i32 → (nb, NV, L) f32 packed source table.

    Counterpart of `cfd_proxy_tpu.ops.blocksweep.pack_srcs` (compact, f32)
    fed by `gather_exts`: `src_cols` (ops/plan.py::compact_src_cols) already
    resolves every slot to its device column.  Kernel: csrc/pack_srcs.cu."""
    dev = var_T.device
    _expect(var_T, "var_T", torch.float32, 2, dev)
    _expect(src_cols, "src_cols", torch.int32, 2, dev)
    check(var_T.shape[0] == NV, "var_T has %d rows, expected NV=%d",
          var_T.shape[0], NV)
    if _device_kind(var_T) == "cpu":
        return pack_srcs_ref(var_T, src_cols)
    from cfd_proxy_tpu_torch.ops import _cuda

    nb, L = src_cols.shape
    out = torch.empty((nb, NV, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_pack_srcs(
            var_T.data_ptr(), var_T.shape[1], src_cols.data_ptr(), nb, L,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check_launch(rc, "pack_srcs")
    pack_srcs.launches += 1
    return out


pack_srcs.launches = 0


# ----------------------------------------------------------------- sweep

def sweep_blocks_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                     slot_w: torch.Tensor, scale: torch.Tensor,
                     block_ids: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """Plain version of the sweep, slot by slot over all blocks at once, in
    the reference body's operation order (_block_compute_packed):
    avg = 0.5·(own + src_k); acc += w_k ⊗ avg; out = acc·scale."""
    nb, _, L = srcs.shape
    bp = scale.shape[-1]
    cols = (block_ids.long()[:, None] * bp
            + torch.arange(bp, device=var_T.device)[None, :])   # (nb, bp)
    own = var_T[:, cols.reshape(-1)].reshape(NV, nb, bp).permute(1, 0, 2)
    acc = torch.zeros((nb, 3, NV, bp), dtype=torch.float32,
                      device=var_T.device)
    widths, offs = slots.tolist()
    for w, off in zip(widths, offs):
        if w == 0:
            continue
        avg = 0.5 * (own[:, :, :w] + srcs[:, :, off:off + w])  # (nb, NV, w)
        wk = slot_w[:, :, off:off + w]                          # (nb, 3, w)
        acc[..., :w] = acc[..., :w] + wk[:, :, None, :] * avg[:, None, :, :]
    res = acc.reshape(nb, ROWS, bp) * scale                      # (nb, 24, bp)
    out = torch.zeros((ROWS, var_T.shape[1]), dtype=torch.float32,
                      device=var_T.device)
    out[:, cols.reshape(-1)] = res.permute(1, 0, 2).reshape(ROWS, nb * bp)
    return out


def sweep_blocks(var_T: torch.Tensor, srcs: torch.Tensor,
                 slot_w: torch.Tensor, scale: torch.Tensor,
                 block_ids: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """Packed compact Green-Gauss sweep → (3·NV, ndev) f32, row d*NV+v.

    var_T (NV, ndev) f32; srcs (nb, NV, L) f32 from `pack_srcs`; slot_w
    (nb, 3, L) f32; scale (nb, 1, bp) f32 (1/V, 0 on pad); block_ids (nb,)
    i32; slots (2, K) i32 from `slot_table`.  Columns of blocks the plan
    does not list are zero.  Counterpart of `cfd_proxy_tpu.ops.blocksweep.
    sweep_blocks(..., packed=True, wks=...)`.  Kernel: csrc/sweep_packed.cu."""
    dev = var_T.device
    _expect(var_T, "var_T", torch.float32, 2, dev)
    _expect(srcs, "srcs", torch.float32, 3, dev)
    _expect(slot_w, "slot_w", torch.float32, 3, dev)
    _expect(scale, "scale", torch.float32, 3, dev)
    _expect(block_ids, "block_ids", torch.int32, 1, dev)
    _expect(slots, "slots", torch.int32, 2, dev)
    nb, nv, L = srcs.shape
    bp = scale.shape[2]
    ndev = var_T.shape[1]
    K = slots.shape[1]
    check(var_T.shape[0] == NV and nv == NV,
          "var_T/srcs carry %d/%d rows, expected NV=%d", var_T.shape[0], nv,
          NV)
    check(tuple(slot_w.shape) == (nb, 3, L), "slot_w shape %s, expected %s",
          tuple(slot_w.shape), (nb, 3, L))
    check(tuple(scale.shape) == (nb, 1, bp), "scale shape %s, expected %s",
          tuple(scale.shape), (nb, 1, bp))
    check(block_ids.shape[0] == nb, "block_ids has %d entries, expected %d",
          block_ids.shape[0], nb)
    check(slots.shape[0] == 2 and 1 <= K <= MAX_SLOTS,
          "slots shape %s: expected (2, K) with 1 <= K <= %d",
          tuple(slots.shape), MAX_SLOTS)
    check(bp > 0 and ndev % bp == 0, "ndev %d not a multiple of bp %d",
          ndev, bp)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots)
    from cfd_proxy_tpu_torch.ops import _cuda

    out = torch.zeros((ROWS, ndev), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_packed(
            var_T.data_ptr(), ndev, srcs.data_ptr(), slot_w.data_ptr(),
            scale.data_ptr(), block_ids.data_ptr(), slots.data_ptr(), K, nb,
            L, bp, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check_launch(rc, "sweep_blocks")
    sweep_blocks.launches += 1
    return out


sweep_blocks.launches = 0
