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

and the bench's rungs on the prefix tables (csrc/kbench_rungs.cu), each a
variation of K1's body that changes its arithmetic or its bytes:

- `bso_twin` — K5f, `_bso_kernel(hoist_own)` (:546, through `_bso_fn` :575):
  the bf16 stack (bf16 deltas δ, bf16 weights, bf16 output) with the weights
  PRE-HALVED by the host, w′ = bf16(0.5·w), and o2 = own + own:
      hoist_own False (`bso_fold`):  acc += w′_k⊗(o2 + δ_k)
      hoist_own True  (`bso_wsum`):  acc += w′_k⊗δ_k, then acc += wsum⊗o2
  with wsum (P, nb, 3, bp) f32 = 0.5·Σ_k slot_w read once per point.  The
  fold form is K1's w⊗(own + 0.5·δ) scaled through by two, which is exact:
  it equals K1-w16-d16-o16 bit for bit while no halved weight is subnormal.
  The hoisted form applies the own term once: measurement only.
- `bso_acc3_twin` — K5g, `bso_acc3_kernel` (:614): K1-w16-d16-o16's function
  with one (NV, bp) accumulator per dimension d, joined at the store.  K1's
  products in K1's order: bit for bit K1.
- `i8_sweep` — K5d, `i8_kernel` (:424, through `i8_fn` :446): K1's gg delta
  body on int8 deltas q with a per-(block, variable) step s =
  i8_scale[p, b, v, 0]: δ = f32(q)·s, avg = own + 0.5·δ; bf16 weights and
  output.  Its kernel gives each thread I8_LANES point columns (vector
  copies through a shared-memory ring), which needs bp and every slot
  width to be multiples of them (the kernel traps on a slot width that is
  not) and the operands aligned (`check_i8_lanes`).
- `flux_fact_twin` — K5h, `cflux_fact_kernel` (:691): the upwind flux
  factored, f32: udw, uow, a as K1's flux body; cu = 0.5·(udw + a), cg =
  0.5·(uow − a); acc += cu·own + cg·src.  Algebraically K1-flux.
- `stream_flux_twin` — K5i, `cstream_flux_kernel` (:743): the flux kernel's
  stream twin, f32: s1, s2 as the stream twin;
  out[v] = s1[v]·(s2[0] + s2[1] + s2[2])·scale, NV rows.

The conventions are ops/blocksweep.py's: stacked (P, ...) operands in the
compact layout with a `slot_table(wks)`; precision taken from the
operands' dtypes; a CPU tensor runs the plain version beside the wrapper
(`*_ref`), a CUDA tensor launches the kernel (csrc/kbench_twins.cu) on the
current stream or raises, with no fallback; the output is zero at the
columns of blocks the plan does not list, and a pad entry (one that repeats
its predecessor) is skipped; each instance counts its launches in a plain
integer attribute (`stream_twin.launches`,
`stream_twin.w16_d16_o16_launches`, `wsum_twin.launches`,
`nv7_sweep.launches`, `bso_twin.launches` and `bso_twin.hoist_launches`,
`bso_acc3_twin.launches`, `i8_sweep.launches`, `flux_fact_twin.launches`,
`stream_flux_twin.launches`), listed by `launch_counters()`.
"""

from __future__ import annotations

import torch

from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops.blocksweep import BF16, F32, NV
from cfd_proxy_tpu_torch.utils.errors import check

NV7 = 7     # nv7_sweep's variable rows
I8 = torch.int8
SCALE_LANES = 128   # lanes of one (block, variable) row of i8_scale
# point columns per thread of the int8 rung's kernel (csrc/kbench_rungs.cu::
# kI8Lanes), whose vector copies need every slot width and bp to be
# multiples of it
I8_LANES = 4
# the rungs of csrc/kbench_rungs.cu; the kernel takes one as its index here
RUNGS = ("fold", "fold_wsum", "acc3", "i8", "flux_fact", "stream_flux")


def _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, nv, dtypes,
                w_dtypes=None):
    """Validate a twin's operands (K1's layout with nv variable rows; srcs
    of `dtypes`, slot_w of `w_dtypes`, by default the same); returns (P, nb,
    L, bp, ndev, K)."""
    dev = var_T.device
    bs._expect(var_T, "var_T", F32, 3, dev)
    bs._expect(srcs, "srcs", dtypes, 4, dev)
    bs._expect(slot_w, "slot_w", dtypes if w_dtypes is None else w_dtypes,
               4, dev)
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


# ------------------------------------- the rungs on the prefix tables

def _rung(fn, rung: str, args: tuple, dims: tuple, rows: int,
          out_dtype: torch.dtype, extra: torch.Tensor | None = None,
          tag: str = "") -> torch.Tensor:
    """Launch rung `rung` of csrc/kbench_rungs.cu for wrapper fn."""
    return _launch(fn, "cfd_kbench_rung", args, dims, rows, out_dtype,
                   (RUNGS.index(rung),
                    None if extra is None else extra.data_ptr()), tag)


def _outer(wk: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """w⊗t: weights (P, nb, 3, w) × terms (P, nb, nv, w) → (P, nb, 3·nv, w),
    row d·nv+v."""
    P, nb, nv, w = t.shape
    return (wk[:, :, :, None] * t[:, :, None]).reshape(P, nb, 3 * nv, w)


def bso_twin_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                 slot_w: torch.Tensor, scale: torch.Tensor,
                 block_ids: torch.Tensor, slots: torch.Tensor,
                 wsum: torch.Tensor | None = None,
                 hoist_own: bool = False) -> torch.Tensor:
    """Plain version of the pre-halved bf16 stack, in the reference's
    operation order: o2 = own + own; per live slot acc += w′_k⊗(o2 + δ_k),
    or hoisted acc += w′_k⊗δ_k and once at the end acc += wsum⊗o2; out =
    bf16(acc·scale)."""
    bp = scale.shape[-1]
    own = bs._block_cols(var_T, block_ids, bp)              # (P, nb, NV, bp)
    o2 = own + own
    P, nb, nv, _ = own.shape
    acc = torch.zeros((P, nb, 3 * nv, bp), dtype=F32, device=var_T.device)
    for w, off in _live_slots(slots):
        d = srcs[..., off:off + w].float()
        t = d if hoist_own else o2[..., :w] + d
        acc[..., :w] += _outer(slot_w[..., off:off + w].float(), t)
    if hoist_own:
        acc = acc + _outer(wsum, o2)
    return bs._store_blocks(acc * scale, block_ids, var_T.shape[2],
                            out_dtype=BF16)


def bso_twin(var_T: torch.Tensor, srcs: torch.Tensor, slot_w: torch.Tensor,
             scale: torch.Tensor, block_ids: torch.Tensor,
             slots: torch.Tensor, wsum: torch.Tensor | None = None,
             hoist_own: bool = False) -> torch.Tensor:
    """The bf16 stack on pre-halved weights (K5f) → (P, 3·NV, ndev) bf16.

    var_T f32; srcs (P, nb, NV, L) bf16 deltas; slot_w (P, nb, 3, L) bf16,
    HALVED by the caller (bf16(0.5·w)); the rest as in
    `blocksweep.sweep_blocks`.  hoist_own False (`launches`): the own term
    folded into each slot.  hoist_own True (`hoist_launches`): the own term
    applied once through wsum (P, nb, 3, bp) f32 = 0.5·Σ_k slot_w, which
    only this form takes.  Kernel: csrc/kbench_rungs.cu."""
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV,
                       BF16)
    check(hoist_own == (wsum is not None),
          "bso_twin: wsum goes with hoist_own=True, and only with it")
    if hoist_own:
        bs._expect(wsum, "wsum", F32, 4, var_T.device)
        bs._shape(wsum, "wsum", (dims[0], dims[1], 3, dims[3]))
    args = (var_T, srcs, slot_w, scale, block_ids, slots)
    if bs._device_kind(var_T) == "cpu":
        return bso_twin_ref(*args, wsum, hoist_own)
    return _rung(bso_twin, "fold_wsum" if hoist_own else "fold", args, dims,
                 3 * NV, BF16, wsum, "hoist_" * hoist_own)


bs._zero_counts(bso_twin, ("",), ("", "hoist_"))


def bso_acc3_twin_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                      slot_w: torch.Tensor, scale: torch.Tensor,
                      block_ids: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """Plain version of the three-accumulator form, in the reference's
    operation order: per live slot avg = own + 0.5·δ_k, then for each d
    acc_d += w_k[d]·avg; the three joined as rows d·NV+v; out =
    bf16(acc·scale)."""
    bp = scale.shape[-1]
    own = bs._block_cols(var_T, block_ids, bp)              # (P, nb, NV, bp)
    accs = [torch.zeros_like(own) for _ in range(3)]
    for w, off in _live_slots(slots):
        avg = own[..., :w] + 0.5 * srcs[..., off:off + w].float()
        wk = slot_w[..., off:off + w].float()
        for d in range(3):
            accs[d][..., :w] += wk[:, :, d:d + 1] * avg
    return bs._store_blocks(torch.cat(accs, dim=2) * scale, block_ids,
                            var_T.shape[2], out_dtype=BF16)


def bso_acc3_twin(var_T: torch.Tensor, srcs: torch.Tensor,
                  slot_w: torch.Tensor, scale: torch.Tensor,
                  block_ids: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """K1-w16-d16-o16's function with one accumulator set per dimension
    (K5g) → (P, 3·NV, ndev) bf16; operands as that K1 instance's: bf16
    deltas and bf16 weights.  Kernel: csrc/kbench_rungs.cu."""
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV,
                       BF16)
    args = (var_T, srcs, slot_w, scale, block_ids, slots)
    if bs._device_kind(var_T) == "cpu":
        return bso_acc3_twin_ref(*args)
    return _rung(bso_acc3_twin, "acc3", args, dims, 3 * NV, BF16)


bs._zero_counts(bso_acc3_twin, ("",), ("",))


def i8_sweep_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                 slot_w: torch.Tensor, scale: torch.Tensor,
                 block_ids: torch.Tensor, slots: torch.Tensor,
                 i8_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 rung, in the reference's operation order:
    s = i8_scale[..., :1]; per live slot δ = f32(q_k)·s, avg = own + 0.5·δ,
    acc += w_k⊗avg; out = bf16(acc·scale)."""
    bp = scale.shape[-1]
    own = bs._block_cols(var_T, block_ids, bp)              # (P, nb, NV, bp)
    P, nb, nv, _ = own.shape
    acc = torch.zeros((P, nb, 3 * nv, bp), dtype=F32, device=var_T.device)
    s = i8_scale[..., :1]                                   # (P, nb, NV, 1)
    for w, off in _live_slots(slots):
        dk = srcs[..., off:off + w].float() * s
        avg = own[..., :w] + 0.5 * dk
        acc[..., :w] += _outer(slot_w[..., off:off + w].float(), avg)
    return bs._store_blocks(acc * scale, block_ids, var_T.shape[2],
                            out_dtype=BF16)


def check_i8_lanes(var_T: torch.Tensor, srcs: torch.Tensor,
                   slot_w: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise unless the int8 rung's kernel can take I8_LANES point columns
    per thread on these operands: bp a multiple of I8_LANES, and srcs
    (I8_LANES bytes), slot_w (2·I8_LANES) and the f32 var_T and scale (16)
    aligned to its vector accesses.  The slot widths stay on the card: the
    kernel traps on one that is not a multiple of I8_LANES."""
    bp = scale.shape[-1]
    check(bp % I8_LANES == 0, "i8_sweep: the %d-lane loads need bp (%d) to "
          "be a multiple of %d", I8_LANES, bp, I8_LANES)
    for t, name in ((var_T, "var_T"), (scale, "scale"), (slot_w, "slot_w"),
                    (srcs, "srcs")):
        align = {1: I8_LANES, 2: 2 * I8_LANES, 4: 16}[t.element_size()]
        check(t.data_ptr() % align == 0,
              "i8_sweep: %s must be %d-byte aligned for the %d-lane loads",
              name, align, I8_LANES)


def i8_sweep(var_T: torch.Tensor, srcs: torch.Tensor, slot_w: torch.Tensor,
             scale: torch.Tensor, block_ids: torch.Tensor,
             slots: torch.Tensor,
             i8_scale: torch.Tensor | None = None) -> torch.Tensor:
    """K1's gg delta body on int8 deltas (K5d) → (P, 3·NV, ndev) bf16.

    var_T f32; srcs (P, nb, NV, L) int8, the deltas in steps of i8_scale
    (P, nb, NV, 128) f32, of which lane 0 of each (block, variable) row is
    read; slot_w (P, nb, 3, L) bf16; the rest as in
    `blocksweep.sweep_blocks`.  Kernel: csrc/kbench_rungs.cu (I8_LANES point
    columns per thread; `check_i8_lanes` raises on operands it cannot
    take)."""
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV, I8,
                       BF16)
    check(i8_scale is not None, "i8_sweep: int8 sources need their i8_scale")
    bs._expect(i8_scale, "i8_scale", F32, 4, var_T.device)
    bs._shape(i8_scale, "i8_scale", (dims[0], dims[1], NV, SCALE_LANES))
    args = (var_T, srcs, slot_w, scale, block_ids, slots)
    if bs._device_kind(var_T) == "cpu":
        return i8_sweep_ref(*args, i8_scale)
    check_i8_lanes(var_T, srcs, slot_w, scale)
    return _rung(i8_sweep, "i8", args, dims, 3 * NV, BF16, i8_scale)


bs._zero_counts(i8_sweep, ("",), ("",))


def flux_fact_twin_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                       slot_w: torch.Tensor, scale: torch.Tensor,
                       block_ids: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
    """Plain version of the factored flux, in the reference's operation
    order: per live slot udw = Σ_d own[d]·w_k[d], uow = Σ_d src_k[d]·w_k[d],
    a = max(|udw|, |uow|), cu = 0.5·(udw + a), cg = 0.5·(uow − a),
    acc += cu·own + cg·src_k; out = acc·scale."""
    bp = scale.shape[-1]
    own = bs._block_cols(var_T, block_ids, bp)              # (P, nb, NV, bp)
    acc = torch.zeros_like(own)
    for w, off in _live_slots(slots):
        own_k, gat = own[..., :w], srcs[..., off:off + w]
        wk = slot_w[..., off:off + w]
        udw = (own_k[:, :, :3] * wk).sum(2, keepdim=True)   # (P, nb, 1, w)
        uow = (gat[:, :, :3] * wk).sum(2, keepdim=True)
        a = torch.maximum(udw.abs(), uow.abs())
        acc[..., :w] += (0.5 * (udw + a)) * own_k + (0.5 * (uow - a)) * gat
    return bs._store_blocks(acc * scale, block_ids, var_T.shape[2])


def flux_fact_twin(var_T: torch.Tensor, srcs: torch.Tensor,
                   slot_w: torch.Tensor, scale: torch.Tensor,
                   block_ids: torch.Tensor,
                   slots: torch.Tensor) -> torch.Tensor:
    """The factored upwind flux (K5h) → (P, NV, ndev) f32; f32 operands as
    `blocksweep.sweep_blocks(op="flux")` takes them.  Kernel:
    csrc/kbench_rungs.cu."""
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV, F32)
    args = (var_T, srcs, slot_w, scale, block_ids, slots)
    if bs._device_kind(var_T) == "cpu":
        return flux_fact_twin_ref(*args)
    return _rung(flux_fact_twin, "flux_fact", args, dims, NV, F32)


bs._zero_counts(flux_fact_twin, ("",), ("",))


def stream_flux_twin_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                         slot_w: torch.Tensor, scale: torch.Tensor,
                         block_ids: torch.Tensor,
                         slots: torch.Tensor) -> torch.Tensor:
    """Plain version of the flux stream twin, in the reference's operation
    order: s1 and s2 as `stream_twin_ref`;
    (s1·((s2[0] + s2[1]) + s2[2]))·scale."""
    bp = scale.shape[-1]
    s1 = bs._block_cols(var_T, block_ids, bp).clone()       # (P, nb, NV, bp)
    P, nb = s1.shape[:2]
    s2 = torch.zeros((P, nb, 3, bp), dtype=F32, device=var_T.device)
    for w, off in _live_slots(slots):
        s1[..., :w] += srcs[..., off:off + w]
        s2[..., :w] += slot_w[..., off:off + w]
    res = s1 * (s2[:, :, 0:1] + s2[:, :, 1:2] + s2[:, :, 2:3])
    return bs._store_blocks(res * scale, block_ids, var_T.shape[2])


def stream_flux_twin(var_T: torch.Tensor, srcs: torch.Tensor,
                     slot_w: torch.Tensor, scale: torch.Tensor,
                     block_ids: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """The flux kernel's stream twin (K5i) → (P, NV, ndev) f32; f32 operands
    as `flux_fact_twin`'s.  Kernel: csrc/kbench_rungs.cu."""
    dims = _check_twin(var_T, srcs, slot_w, scale, block_ids, slots, NV, F32)
    args = (var_T, srcs, slot_w, scale, block_ids, slots)
    if bs._device_kind(var_T) == "cpu":
        return stream_flux_twin_ref(*args)
    return _rung(stream_flux_twin, "stream_flux", args, dims, NV, F32)


bs._zero_counts(stream_flux_twin, ("",), ("",))


def launch_counters() -> dict:
    """{instance name: (wrapper, count attribute)} of the twins' kernel
    instances: "stream_twin", "stream_twin_w16_d16_o16", "wsum_twin",
    "nv7_sweep", "bso_twin", "bso_twin_hoist", "bso_acc3_twin", "i8_sweep",
    "flux_fact_twin", "stream_flux_twin"."""
    return bs.launch_counters((stream_twin, wsum_twin, nv7_sweep, bso_twin,
                               bso_acc3_twin, i8_sweep, flux_fact_twin,
                               stream_flux_twin))
