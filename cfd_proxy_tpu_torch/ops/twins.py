"""Measurement twins of the packed sweep — kernel wrappers over P shards on
one device, for the kernel bench (tools/kbench.py).

Counterparts of the Pallas twin kernels of `cfd_proxy_tpu/tools/kbench.py`
(closures of its `main()`), which run beside K1 to tell its bytes from its
arithmetic:

- `stream_twin` — K5a, `stream_kernel` (kbench.py:269, through `call()`
  :257), and K5e, `cstream_bso_kernel` (:476, through `_cstream_fn` :496):
  K1's streams with minimal math.  Per point column of a listed block,
  over the live slots k (lane < wks[k]):
      s1 = own + Σ_k src_k;   s2 = Σ_k w_k;   out[d·NV+v] = s2[d]·s1[v]·scale
  The reference runs K5a on its rectangular (nb, K, NV, bp) table; the port
  keeps one layout, the compact one, and the rectangular layout is the
  compact table at full widths (wks = (bp,)·K, kbench's `flat`, which the
  reference measured layout-neutral).  So K5a is this function on the
  full-width table and K5e on the prefix table.  f32 tables and output
  give `stream` / `cstream_c`; bf16 source deltas and weights with a bf16
  output give `cstream_bso` (widened where read, sums f32, only the store
  rounds).  The twin adds the deltas as values: minimal math, not the
  sweep's.
- `wsum_twin` — K5b, `wsum_kernel` (:278): K1's gg math with the own term
  hoisted out of the slot loop, f32:
      acc = Σ_k w_k⊗src_k;   wsum = Σ_k w_k;   out = 0.5·(acc + wsum⊗own)·scale
  It applies the own term once per point, so it is not
  composition-exact: measurement only.
- `nv7_sweep` — K5c, `nv7_kernel` / `nv7_fn` (:300-332): K1's f32 gg math
  on 7 variable rows end to end: var_T (P, 7, ndev), srcs (P, nb, 7, L),
  out (P, 21, ndev) — the NV=8 padding dropped.

The conventions are ops/blocksweep.py's: stacked (P, ...) operands in the
compact layout with a `slot_table(wks)`; precision taken from the
operands' dtypes; a CPU tensor runs the plain version beside the wrapper
(`*_ref`), a CUDA tensor launches the kernel (csrc/kbench_twins.cu) on the
current stream or raises, with no fallback; the output is zero at the
columns of blocks the plan does not list, and a pad entry (one that repeats
its predecessor) is skipped; each instance counts its launches in a plain
integer attribute (`stream_twin.launches`,
`stream_twin.w16_d16_o16_launches`, `wsum_twin.launches`,
`nv7_sweep.launches`), listed by `launch_counters()`.
"""

from __future__ import annotations

import torch

from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops.blocksweep import BF16, F32, NV
from cfd_proxy_tpu_torch.utils.errors import check

NV7 = 7     # nv7_sweep's variable rows


def _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, nv, dtypes):
    """Validate a twin's operands (K1's layout with nv variable rows);
    returns (P, nb, L, bp, ndev, K)."""
    dev = var_T.device
    bs._expect(var_T, "var_T", F32, 3, dev)
    bs._expect(srcs, "srcs", dtypes, 4, dev)
    bs._expect(slot_w, "slot_w", dtypes, 4, dev)
    bs._expect(scale, "scale", F32, 4, dev)
    bs._expect(block_ids, "block_ids", torch.int32, 2, dev)
    bs._expect(slots, "slots", torch.int32, 2, dev)
    P, nb, _, L = srcs.shape
    bp = scale.shape[3]
    ndev = var_T.shape[2]
    K = slots.shape[1]
    bs._shape(var_T, "var_T", (P, nv, ndev))
    bs._shape(srcs, "srcs", (P, nb, nv, L))
    bs._shape(slot_w, "slot_w", (P, nb, 3, L))
    bs._shape(scale, "scale", (P, nb, 1, bp))
    bs._shape(block_ids, "block_ids", (P, nb))
    check(slots.shape[0] == 2 and 1 <= K <= bs.MAX_SLOTS,
          "slots shape %s: expected (2, K) with 1 <= K <= %d",
          tuple(slots.shape), bs.MAX_SLOTS)
    check(bp > 0 and ndev % bp == 0, "ndev %d not a multiple of bp %d",
          ndev, bp)
    return P, nb, L, bp, ndev, K


def _live_slots(slots: torch.Tensor) -> list[tuple[int, int]]:
    """(width, offset) of every slot of a slot table with lanes."""
    return [(w, off) for w, off in zip(*slots.tolist()) if w]


def _launch(fn, entry: str, args: tuple, dims: tuple, rows: int,
            out_dtype: torch.dtype, flags: tuple = (),
            tag: str = "") -> torch.Tensor:
    """Launch C entry point `entry` on the sweep operands `args` into a
    zero-filled (P, rows, ndev) output and count it under `tag`."""
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = args[0].device
    P, ndev = dims[0], dims[4]
    out = torch.zeros((P, rows, ndev), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(_cuda.lib(), entry)(*bs._sweep_ptrs(*args, dims), *flags,
                                         out.data_ptr(), bs._stream(dev))
    _cuda.check_launch(rc, fn.__name__)
    attr = tag + "launches"
    setattr(fn, attr, getattr(fn, attr) + 1)
    return out


# ---------------------------------------------------------------- stream

def stream_twin_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                    slot_w: torch.Tensor, scale: torch.Tensor,
                    block_ids: torch.Tensor, slots: torch.Tensor,
                    out_dtype: torch.dtype = F32) -> torch.Tensor:
    """Plain version of the stream twin, in the reference's operation
    order: s1 from own, then each live slot's sources added in slot order
    over its lanes; s2 likewise from 0; (s2[d]·s1[v])·scale, rounded to
    out_dtype at the store."""
    bp = scale.shape[-1]
    s1 = bs._block_cols(var_T, block_ids, bp).clone()       # (P, nb, NV, bp)
    P, nb, nv, _ = s1.shape
    s2 = torch.zeros((P, nb, 3, bp), dtype=F32, device=var_T.device)
    for w, off in _live_slots(slots):
        s1[..., :w] += srcs[..., off:off + w].float()
        s2[..., :w] += slot_w[..., off:off + w].float()
    res = (s2[:, :, :, None] * s1[:, :, None]).reshape(P, nb, 3 * nv, bp)
    return bs._store_blocks(res * scale, block_ids, var_T.shape[2],
                            out_dtype=out_dtype)


def stream_twin(var_T: torch.Tensor, srcs: torch.Tensor,
                slot_w: torch.Tensor, scale: torch.Tensor,
                block_ids: torch.Tensor, slots: torch.Tensor,
                out_dtype: torch.dtype = F32) -> torch.Tensor:
    """Stream twin (K5a, K5e) → (P, 3·NV, ndev) of out_dtype.

    var_T (P, NV, ndev) f32; srcs (P, nb, NV, L) and slot_w (P, nb, 3, L)
    from `pack_srcs` and the compact weights; scale, block_ids and slots as
    in `blocksweep.sweep_blocks`.  srcs, slot_w and the output are all f32
    (`launches`) or all bf16 (`w16_d16_o16_launches`): the two instances
    the reference runs.  Kernel: csrc/kbench_twins.cu."""
    check(srcs.dtype == slot_w.dtype == out_dtype,
          "stream_twin: srcs %s, slot_w %s and out_dtype %s must be all f32 "
          "or all bf16", srcs.dtype, slot_w.dtype, out_dtype)
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV,
                       bs.DTYPES)
    if bs._device_kind(var_T) == "cpu":
        return stream_twin_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                               out_dtype)
    bf16 = out_dtype == BF16
    return _launch(stream_twin, "cfd_stream_twin",
                   (var_T, srcs, slot_w, scale, block_ids, slots), dims,
                   3 * NV, out_dtype, (int(bf16),),
                   bs._tag(bf16, bf16, bf16))


bs._zero_counts(stream_twin, ("",), ("", bs._tag(True, True, True)))


# ------------------------------------------------------------------ wsum

def wsum_twin_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                  slot_w: torch.Tensor, scale: torch.Tensor,
                  block_ids: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """Plain version of the hoisted-own twin, in the reference's operation
    order: acc += w_k⊗src_k and wsum += w_k slot by slot; acc += wsum⊗own;
    out = (0.5·acc)·scale."""
    bp = scale.shape[-1]
    own = bs._block_cols(var_T, block_ids, bp)              # (P, nb, NV, bp)
    P, nb, nv, _ = own.shape
    acc = torch.zeros((P, nb, 3 * nv, bp), dtype=F32, device=var_T.device)
    wsum = torch.zeros((P, nb, 3, bp), dtype=F32, device=var_T.device)
    for w, off in _live_slots(slots):
        wk = slot_w[..., off:off + w]
        wsum[..., :w] += wk
        acc[..., :w] += (wk[:, :, :, None] * srcs[:, :, None, :, off:off + w]
                         ).reshape(P, nb, 3 * nv, w)
    acc = acc + (wsum[:, :, :, None] * own[:, :, None]).reshape(
        P, nb, 3 * nv, bp)
    return bs._store_blocks((0.5 * acc) * scale, block_ids, var_T.shape[2])


def wsum_twin(var_T: torch.Tensor, srcs: torch.Tensor, slot_w: torch.Tensor,
              scale: torch.Tensor, block_ids: torch.Tensor,
              slots: torch.Tensor) -> torch.Tensor:
    """Hoisted-own twin (K5b) → (P, 3·NV, ndev) f32; f32 operands laid out
    as in `stream_twin`.  Kernel: csrc/kbench_twins.cu."""
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV, F32)
    if bs._device_kind(var_T) == "cpu":
        return wsum_twin_ref(var_T, srcs, slot_w, scale, block_ids, slots)
    return _launch(wsum_twin, "cfd_wsum_twin",
                   (var_T, srcs, slot_w, scale, block_ids, slots), dims,
                   3 * NV, F32)


bs._zero_counts(wsum_twin, ("",), ("",))


# ------------------------------------------------------------------- nv7

def nv7_sweep_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                  slot_w: torch.Tensor, scale: torch.Tensor,
                  block_ids: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """Plain version of the 7-row sweep: K1's plain gg body
    (`blocksweep.sweep_blocks_ref`), which takes its row count from
    var_T."""
    return bs.sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots)


def nv7_sweep(var_T: torch.Tensor, srcs: torch.Tensor, slot_w: torch.Tensor,
              scale: torch.Tensor, block_ids: torch.Tensor,
              slots: torch.Tensor) -> torch.Tensor:
    """K1's f32 gg sweep on 7 variable rows (K5c) → (P, 21, ndev) f32
    (rows d·7+v): var_T (P, 7, ndev), srcs (P, nb, 7, L), the rest as in
    `blocksweep.sweep_blocks`.  Kernel: csrc/kbench_twins.cu."""
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV7,
                       F32)
    if bs._device_kind(var_T) == "cpu":
        return nv7_sweep_ref(var_T, srcs, slot_w, scale, block_ids, slots)
    return _launch(nv7_sweep, "cfd_nv7_sweep",
                   (var_T, srcs, slot_w, scale, block_ids, slots), dims,
                   3 * NV7, F32)


bs._zero_counts(nv7_sweep, ("",), ("",))


def launch_counters() -> dict:
    """{instance name: (wrapper, count attribute)} of the twins' kernel
    instances: "stream_twin", "stream_twin_w16_d16_o16", "wsum_twin",
    "nv7_sweep"."""
    return bs.launch_counters((stream_twin, wsum_twin, nv7_sweep))
