"""Block-local sweep in its two formulations, the source pack and the fused
overlap sweep — kernel wrappers, over P shards held on one device.

Counterpart of `cfd_proxy_tpu/ops/blocksweep.py`, for both of its ops: "gg"
(Green-Gauss gradients, 3·NV output rows d*NV+v) and "flux" (the PSD upwind
flux of ops/flux.py in its directed-slot form, NV output rows), in every
precision the reference takes.
The packed formulation in the COMPACT layout (`sweep_blocks`, fed by
`pack_srcs`) and the gather formulation with rectangular slot tables
(`sweep_blocks_gather`, fed by `gather_exts`), each with its fused overlap
form.  Every operand carries a leading shard axis P: the
reference runs one shard per chip under `shard_map`; here the shards of one
process (all of them, or one rank's share: parallel/transport.py) sit on
one device and one launch covers them.  The fused overlap wrappers push
inside one launch-private buffer (the loopback form) or, given a `Peer`
transport, to mapped addresses of this or another rank behind a readiness
barrier (the peer form).  Each wrapper checks its inputs and
then

- on CPU tensors runs the plain PyTorch version beside it (`*_ref`), the
  version the CPU tests hold against the JAX reference;
- on CUDA tensors launches its hand-written kernel (`csrc/`) on the current
  stream, never synchronises, and raises if the launch fails.

There is no fallback from one to the other.

Precision.  The state `var_T` and `scale` are f32 (`sweep_blocks` alone also
takes a bf16 state, in the one form the kernel bench's var16 variant runs:
its docstring).  Every wrapper takes the reduced-precision options of the reference from its operands' dtypes, f32
or bf16: the weights `slot_w` (meta_dtype); the packed sources `srcs`,
where bf16 means DELTAS src − own (src_format "bf16d", written by
`pack_srcs(..., src_format="bf16d")`; the gather tables stay f32); the
output, which is `init` when given, else `out_dtype` (grad_dtype; init and
out must agree, the reference aliases them); the push's `sendbufs`
(halo_dtype).  bf16 operands are widened to f32 where they are read, the
sums stay f32, and only the store rounds (to nearest even).

Launch counts.  Each wrapper counts the launches of each of its kernel
instances in a plain integer attribute, `<form><tag>launches`: form "" or
"init_" (the accumulate form), after "flux_" for the flux op and, for the
fused kernel's peer form, "peer_" before both; tag "" for
f32 operands, else "w16_" (bf16 weights), "d16_" (bf16 deltas) and "o16_"
(bf16 output), in that order (`sweep_blocks.launches`,
`sweep_blocks.flux_init_w16_d16_o16_launches`, `pack_srcs.d16_launches`);
`sweep_blocks` on a bf16 state counts in `v16_w16_d16_o16_launches`; the
gather wrappers count their direct, cluster and quad bodies after the tag
(`sweep_blocks_gather.direct_launches`, `.cluster_launches`,
`.quad_launches`; their staged body in the names without any:
`gather_body`), and the direct body's table build, which they launch
first where the plan's `sources` is "table" (`direct_sources`), counts in
`gather_table.launches`.
`launch_counters()` lists them all, so a run can show which bodies its main
path ran.

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
SRC_FORMATS = ("f32", "bf16d")   # packed source values, or bf16 deltas
MAX_SLOTS = 64         # slot-table capacity of the sweep kernel
# shared memory the pack kernel may stage rows in: an H100 block's, less
# its static slot table (csrc/pack_srcs.cu)
PACK_SMEM = 227 * 1024 - 2 * MAX_SLOTS * 4
# the gather sweep's staged body: the most shared memory its table may take,
# an H100 block's less the static slot table (csrc/sweep_gather.cu)
GATHER_STAGE_MAX = 227 * 1024 - MAX_SLOTS * 4
# the most it may take for two such blocks to fit one SM (228 KB, less 1 KB
# the runtime reserves per block)
GATHER_STAGE_PAIR = 228 * 1024 // 2 - 1024 - MAX_SLOTS * 4
GATHER_BODIES = ("staged", "cluster", "quad", "direct")
# the bodies as the kernels take them (csrc/sweep_common.cuh::Body); the
# fused kernel has all four
GATHER_BODY_CODES = {"direct": 0, "staged": 1, "cluster": 2, "quad": 3}
# where the direct body reads a slot lane's sources (`direct_sources`)
DIRECT_SOURCES = ("columns", "table")
# the direct body reads its point-major table where a plan has at least
# this many real slot lanes per table column (`direct_sources`)
DIRECT_TABLE_LANES = 1.0
# lanes a thread of the quad body loads and stores at once, per op
# (csrc/sweep_common.cuh::kQuadLanesGG, kQuadLanesFlux)
QUAD_LANES = {"gg": 4, "flux": 2}
F32, BF16 = torch.float32, torch.bfloat16
DTYPES = (F32, BF16)   # the stored types a reduced-precision operand takes


def out_rows(op: str) -> int:
    """Output row count: gradients are (3, NV) planes, fluxes (NV,)."""
    return 3 * NV if op == "gg" else NV


def _check_op(op: str) -> int:
    check(op in OPS, "unknown sweep op %r (one of %s)", op, "/".join(OPS))
    return out_rows(op)


def _tag(w16: bool = False, d16: bool = False, o16: bool = False,
         v16: bool = False) -> str:
    """The precision part of a count attribute (module docstring)."""
    return "v16_" * v16 + "w16_" * w16 + "d16_" * d16 + "o16_" * o16


# every instance's count attribute: forms × precision tags per wrapper
_SWEEP_FORMS = ("", "init_", "flux_", "flux_init_")
_FUSED_FORMS = ("", "flux_", "peer_", "peer_flux_")
_PACKED_TAGS = tuple(_tag(w, d, o) for w in (0, 1) for d in (0, 1)
                     for o in (0, 1))
_GATHER_TAGS = tuple(_tag(w, False, o) for w in (0, 1) for o in (0, 1))
# the gather wrappers count the direct, cluster and quad bodies apart:
# "<tag>direct_launches", "<tag>cluster_launches", "<tag>quad_launches"
_BODY_TAGS = {"staged": "", "cluster": "cluster_", "quad": "quad_",
              "direct": "direct_"}
_GATHER_BODY_TAGS = tuple(t + _BODY_TAGS[b] for b in GATHER_BODIES
                          for t in _GATHER_TAGS)


def _count(fn, init, op: str, tag: str = "", peer: bool = False) -> None:
    """Add one to the count of the kernel instance just launched."""
    name = "peer_" * peer + ("flux_" if op == "flux" else "") + \
        ("" if init is None else "init_") + tag + "launches"
    setattr(fn, name, getattr(fn, name) + 1)


def _zero_counts(fn, forms, tags, extra=()) -> None:
    """Give wrapper fn a zeroed count attribute per form × tag, and per name
    of `extra`."""
    fn.count_attrs = (*(f + t + "launches" for f in forms for t in tags),
                      *(e + "launches" for e in extra))
    for a in fn.count_attrs:
        setattr(fn, a, 0)


def launch_counters(wrappers: tuple = ()) -> dict:
    """{instance name: (wrapper, count attribute)} for every kernel
    instance of this module's wrappers (or of `wrappers`).  The name is the
    wrapper's, then "_flux", "_init" and the precision tag as in the
    attribute: "sweep_blocks_flux_init", "sweep_blocks_init_w16_d16_o16",
    "pack_srcs_d16"."""
    out = {}
    for fn in wrappers or (pack_srcs, sweep_blocks, sweep_blocks_gather,
                           sweep_blocks_overlap, sweep_blocks_overlap_gather,
                           gather_table):
        for a in fn.count_attrs:
            out["_".join([fn.__name__, *a.split("_")[:-1]])] = (fn, a)
    return out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each |x| (0 at x = 0): 2^(e−7)
    for |x| in [2^e, 2^(e+1)), bf16 keeping 8 significant bits.  The bound
    a bf16 output of a kernel keeps against its plain version: their f32
    sums differ by FMA contraction, which can move one across a rounding
    boundary."""
    x = x.float()
    _, e = torch.frexp(x)                     # |x| = m·2^e, m in [0.5, 1)
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 8),
                       torch.zeros_like(x))


def _out_dtype(init, out_dtype) -> torch.dtype:
    """The output's dtype: init's (the two alias, so out_dtype, when also
    given, must agree: the reference's check), else out_dtype, else f32."""
    if init is None:
        odt = F32 if out_dtype is None else out_dtype
    else:
        check(out_dtype is None or out_dtype == init.dtype,
              "init dtype %s must match out_dtype %s (aliased buffers)",
              init.dtype, out_dtype)
        odt = init.dtype
    check(odt in DTYPES, "out_dtype %s: f32 or bf16", odt)
    return odt


def slot_table(wks) -> np.ndarray:
    """(2, K) int32: per-slot prefix width and compact lane offset
    (exclusive prefix sum of the widths; a zero-width slot adds nothing)."""
    w = np.asarray(wks, np.int64)
    off = np.concatenate([[0], np.cumsum(w)[:-1]])
    return np.stack([w, off]).astype(np.int32)


def _expect(t: torch.Tensor, name: str, dtype, ndim: int,
            device: torch.device) -> None:
    """t is a contiguous tensor of ndim dims on device, of dtype (one
    dtype, or a tuple of the dtypes the kernels take)."""
    check(isinstance(t, torch.Tensor), "%s must be a tensor", name)
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    # few comparisons: the wrappers sit on the step's host path
    got = (t.dim(), t.device, t.is_contiguous())
    want = (ndim, device, True)
    check(t.dtype in dtypes and got == want, "%s: dtype %s, (dims, device, "
          "contiguous) %s, expected dtype in %s and %s", name, t.dtype, got,
          dtypes, want)


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

def _gather_cols(var_T: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """out[p, b, v, j] = var_T[p, v, cols[p, b, j]]: (P, nb, NV, L)."""
    P, nb, L = cols.shape
    idx = cols.reshape(P, 1, nb * L).long().expand(P, NV, nb * L)
    g = torch.gather(var_T, 2, idx)                          # (P, NV, nb*L)
    return g.reshape(P, NV, nb, L).permute(0, 2, 1, 3).contiguous()


def _own_cols(block_ids: torch.Tensor, slots: torch.Tensor,
              bp: int) -> torch.Tensor:
    """(P, nb, L) int64: each compact table entry's OWN column,
    block_ids[p, b]·bp + lane, lane = j − off_k for compact index j in slot
    k (the destination lane the entry's term is added to)."""
    lanes = [torch.arange(w, device=block_ids.device)
             for w in slots[0].tolist() if w]
    return block_ids.long()[:, :, None] * bp + torch.cat(lanes)


def pack_srcs_ref(var_T: torch.Tensor, src_cols: torch.Tensor,
                  src_format: str = "f32",
                  block_ids: torch.Tensor | None = None,
                  slots: torch.Tensor | None = None,
                  bp: int | None = None) -> torch.Tensor:
    """Plain version of the pack.  f32:
    out[p, b, v, j] = var_T[p, v, src_cols[p, b, j]]; bf16d: the bf16
    (round to nearest even) of that minus var_T at the entry's own column
    (`_own_cols`), the f32 difference the reference rounds."""
    g = _gather_cols(var_T, src_cols)
    if src_format == "f32":
        return g
    own = _gather_cols(var_T, _own_cols(block_ids, slots, bp))
    return (g - own).to(BF16)


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


def pack_srcs(var_T: torch.Tensor, src_cols: torch.Tensor, *,
              src_format: str = "f32", block_ids: torch.Tensor | None = None,
              slots: torch.Tensor | None = None, bp: int | None = None,
              widx: torch.Tensor | None = None,
              ext_idx: torch.Tensor | None = None) -> torch.Tensor:
    """(P, NV, ndev) f32 × (P, nb, L) i32 → (P, nb, NV, L) packed source
    table: f32 values, or (src_format "bf16d") bf16 deltas source − own.

    Counterpart of `cfd_proxy_tpu.ops.blocksweep.pack_srcs` (compact) fed by
    `gather_exts`.  `src_cols` (ops/plan.py::compact_src_cols) resolves
    every slot to its device column; the plain version gathers through it.
    The kernel (csrc/pack_srcs.cu) runs the reference's two stages instead:
    it stages each block's own columns and its ext columns `ext_idx` (P,
    nb, EP) i32 in shared memory and resolves each lane's compact W-index
    `widx` (P, nb, L) i32 (ops/plan.py::compact_widx: own columns at
    [0, bp), ext column r at bp + r) against them; both, the class's
    block_ids (P, nb) i32 and the block size bp are needed on CUDA tensors
    (their ranges are the caller's to check, once: the model does at
    set-up).  The bf16d form also needs each entry's own lane: the slot
    table slots (2, K) i32 (`slot_table(wks)`, Σ widths = L)."""
    dev = var_T.device
    _expect(var_T, "var_T", F32, 3, dev)
    _expect(src_cols, "src_cols", torch.int32, 3, dev)
    check(src_format in SRC_FORMATS, "unknown src_format %r (one of %s)",
          src_format, "/".join(SRC_FORMATS))
    P, nb, L = src_cols.shape
    ndev = var_T.shape[2]
    _shape(var_T, "var_T", (P, NV, ndev))
    delta = src_format == "bf16d"
    K = 0
    if delta:
        check(block_ids is not None and slots is not None and bp is not None,
              "the bf16d pack needs block_ids, slots and bp (each entry's "
              "own column)")
        _expect(slots, "slots", torch.int32, 2, dev)
        K = slots.shape[1]
        check(slots.shape[0] == 2 and 1 <= K <= MAX_SLOTS,
              "slots shape %s: expected (2, K) with 1 <= K <= %d",
              tuple(slots.shape), MAX_SLOTS)
    if block_ids is not None:
        _expect(block_ids, "block_ids", torch.int32, 2, dev)
        _shape(block_ids, "block_ids", (P, nb))
    if bp is not None:
        check(bp > 0 and ndev % bp == 0, "ndev %d not a multiple of bp %s",
              ndev, bp)
    if widx is not None:
        _expect(widx, "widx", torch.int32, 3, dev)
        _shape(widx, "widx", (P, nb, L))
    if ext_idx is not None:
        _expect(ext_idx, "ext_idx", torch.int32, 3, dev)
        check(tuple(ext_idx.shape[:2]) == (P, nb), "ext_idx shape %s, "
              "expected (%d, %d, EP)", tuple(ext_idx.shape), P, nb)
    if _device_kind(var_T) == "cpu":
        return pack_srcs_ref(var_T, src_cols, src_format, block_ids, slots,
                             bp)
    from cfd_proxy_tpu_torch.ops import _cuda

    check(widx is not None and ext_idx is not None and block_ids is not None
          and bp is not None, "the pack kernel stages each block's columns: "
          "it needs widx, ext_idx, block_ids and bp")
    ep = ext_idx.shape[2]
    check(bp % 4 == 0 and var_T.data_ptr() % 16 == 0, "the pack kernel "
          "loads own columns 16 bytes at a time: bp %d must be a multiple "
          "of 4 and var_T 16-byte aligned", bp)
    check(_pack_stride(bp, ep) * 4 <= PACK_SMEM, "the pack kernel stages a "
          "row of bp + EP = %d columns: more than one block's shared memory",
          bp + ep)
    rows = pack_rows(bp, ep)
    out = torch.empty((P, nb, NV, L), dtype=BF16 if delta else F32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_pack_srcs(
            var_T.data_ptr(), ndev, widx.data_ptr(), ext_idx.data_ptr(), ep,
            block_ids.data_ptr(), slots.data_ptr() if delta else None, K, bp,
            P, nb, L, int(delta), rows, out.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "pack_srcs")
    _count(pack_srcs, None, "gg", _tag(d16=delta))
    return out


def _pack_stride(bp: int, ep: int) -> int:
    """Floats per staged row (csrc/pack_srcs.cu::row_stride)."""
    return -(-(bp + ep) // 4) * 4


def pack_rows(bp: int, ep: int) -> int:
    """Variable rows the pack kernel stages per CUDA block: two (the
    fastest on an H100, PERF.md section 6), halved until they fit in
    PACK_SMEM bytes."""
    rows = 2
    while rows > 1 and rows * _pack_stride(bp, ep) * 4 > PACK_SMEM:
        rows //= 2
    return rows


_zero_counts(pack_srcs, ("",), ("", _tag(d16=True)))


# ----------------------------------------------------------------- sweep

def _slot_contrib(op, own, src, wk, delta=False):
    """One slot's terms over lanes [0, w): own and src (P, nb, NV, w),
    weights wk (P, nb, 3, w) → (P, nb, rows, w) f32, in the reference
    body's operation order.  bf16 weights and sources are widened first.

    gg: avg = 0.5·(own + src) (with bf16 deltas src − own: own + 0.5·δ);
    w ⊗ avg, row d*NV+v.
    flux (the directed-slot form of ops/flux.py): src = own + δ for deltas;
    udw = own[:3]·w, uow = src[:3]·w, a = max(|udw|, |uow|);
    0.5·(udw·own + uow·src) − 0.5·a·(src − own)."""
    P, nb, _, w = own.shape
    wk = wk.float()
    if op == "gg":
        avg = own + 0.5 * src.float() if delta else 0.5 * (own + src)
        return (wk[:, :, :, None, :] * avg[:, :, None]).reshape(P, nb, -1, w)
    if delta:
        src = own + src.float()
    udw = (own[:, :, :3] * wk).sum(2, keepdim=True)           # (P, nb, 1, w)
    uow = (src[:, :, :3] * wk).sum(2, keepdim=True)
    a = torch.maximum(udw.abs(), uow.abs())
    return 0.5 * (udw * own + uow * src) - 0.5 * a * (src - own)


def _block_cols(x: torch.Tensor, block_ids: torch.Tensor,
                bp: int) -> torch.Tensor:
    """(P, nb, R, bp): the columns of x (P, R, ndev) that each listed entry
    covers, block_ids[p, b]·bp + lane."""
    P, R = x.shape[:2]
    nb = block_ids.shape[1]
    lanes = torch.arange(bp, device=x.device)
    flat = (block_ids.long()[:, :, None] * bp + lanes).reshape(P, 1, nb * bp)
    g = torch.gather(x, 2, flat.expand(P, R, nb * bp))
    return g.reshape(P, R, nb, bp).permute(0, 2, 1, 3)


def _store_blocks(res: torch.Tensor, block_ids: torch.Tensor, ndev: int,
                  init: torch.Tensor | None = None,
                  out_dtype: torch.dtype = F32) -> torch.Tensor:
    """The sweep's store: res (P, nb, R, bp) f32 at each listed entry's
    columns of a (P, R, ndev) output, rounded to its dtype — zero
    elsewhere, or init's values with init (updated in place and returned).
    An entry that repeats its predecessor (a pad entry) is computed but not
    stored, as the kernels skip it."""
    P, nb, R, bp = res.shape
    if init is None:
        out = torch.zeros((P, R, ndev + bp), dtype=out_dtype,
                          device=res.device)
    else:
        out = torch.cat([init, init.new_zeros((P, R, bp))], 2)
    # repeats store into a scratch block past ndev, dropped below
    first = torch.ones_like(block_ids, dtype=torch.bool)
    first[:, 1:] = block_ids[:, 1:] != block_ids[:, :-1]
    store = torch.where(first, block_ids.long(), ndev // bp)
    lanes = torch.arange(bp, device=res.device)
    store = (store[:, :, None] * bp + lanes).reshape(P, 1, nb * bp)
    out.scatter_(2, store.expand(P, R, nb * bp),
                 res.permute(0, 2, 1, 3).reshape(P, R, nb * bp).to(
                     out.dtype))
    if init is None:
        return out[:, :, :ndev].contiguous()
    return init.copy_(out[:, :, :ndev])


def _sweep_plain(var_T, scale, block_ids, slots, init, slot_terms, op,
                 delta=False, out_dtype=F32):
    """The sweep's plain body, slot by slot over all shards and blocks at
    once, in the reference body's operation order: acc = init (or 0),
    widened to f32; acc += slot k's terms (`_slot_contrib`); out = acc·scale,
    rounded to the output's dtype (init's, else out_dtype) at the store
    (`_store_blocks`).

    slot_terms(k, w, off, own) gives slot k's sources (P, nb, nv, w) and
    weights (P, nb, 3, w) over lanes [0, w); own is (P, nb, nv, bp), nv =
    var_T's rows (NV, or 7 for kbench's nv7 twin); delta: the sources are
    bf16 deltas.  With init, init is updated in place and returned."""
    P, nv, ndev = var_T.shape
    nb = block_ids.shape[1]
    rows = 3 * nv if op == "gg" else nv
    bp = scale.shape[-1]
    # a bf16 state is widened first (own_ref[:].astype(f32))
    own = _block_cols(var_T, block_ids, bp).float()         # (P, nb, nv, bp)
    if init is None:
        acc = torch.zeros((P, nb, rows, bp), dtype=F32, device=var_T.device)
    else:
        acc = _block_cols(init, block_ids, bp).to(F32, copy=True)
    widths, offs = slots.tolist()
    for k, (w, off) in enumerate(zip(widths, offs)):
        if w == 0:
            continue
        src, wk = slot_terms(k, w, off, own)
        acc[..., :w] = acc[..., :w] + _slot_contrib(op, own[..., :w], src, wk,
                                                    delta)
    return _store_blocks(acc * scale, block_ids, ndev, init, out_dtype)


def sweep_blocks_ref(var_T: torch.Tensor, srcs: torch.Tensor,
                     slot_w: torch.Tensor, scale: torch.Tensor,
                     block_ids: torch.Tensor, slots: torch.Tensor,
                     init: torch.Tensor | None = None,
                     op: str = "gg",
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the packed sweep (_block_compute_packed): slot k's
    sources and weights are lanes [off_k, off_k + wks[k]) of the compact
    tables; bf16 srcs are deltas; a bf16 var_T is widened where read."""
    return _sweep_plain(
        var_T, scale, block_ids, slots, init,
        lambda k, w, off, own: (srcs[..., off:off + w],
                                slot_w[..., off:off + w]), op,
        srcs.dtype == BF16, _out_dtype(init, out_dtype))


def _check_common(var_T, scale, block_ids, slots, init, P, nb, rows,
                  var_dtypes=F32):
    """Validate the operands both formulations share; returns (bp, ndev,
    K)."""
    dev = var_T.device
    _expect(var_T, "var_T", var_dtypes, 3, dev)
    _expect(scale, "scale", F32, 4, dev)
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
        _expect(init, "init", DTYPES, 3, dev)
        _shape(init, "init", (P, rows, ndev))
    return bp, ndev, K


def _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init, rows,
                 var_dtypes=F32):
    """Validate the packed sweep's operands; returns (P, nb, L, bp, ndev,
    K)."""
    _expect(srcs, "srcs", DTYPES, 4, var_T.device)
    _expect(slot_w, "slot_w", DTYPES, 4, var_T.device)
    P, nb, _, L = srcs.shape
    bp, ndev, K = _check_common(var_T, scale, block_ids, slots, init, P, nb,
                                rows, var_dtypes)
    _shape(srcs, "srcs", (P, nb, NV, L))
    _shape(slot_w, "slot_w", (P, nb, 3, L))
    return P, nb, L, bp, ndev, K


def _sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims):
    P, nb, L, bp, ndev, K = dims
    return (var_T.data_ptr(), ndev, srcs.data_ptr(), slot_w.data_ptr(),
            scale.data_ptr(), block_ids.data_ptr(), slots.data_ptr(), K, P,
            nb, L, bp)


def _flags(*ts) -> tuple[int, ...]:
    """An entry point's dtype flags: 1 for each bf16 operand, else 0."""
    return tuple(int(t.dtype == BF16) for t in ts)


def sweep_blocks(var_T: torch.Tensor, srcs: torch.Tensor,
                 slot_w: torch.Tensor, scale: torch.Tensor,
                 block_ids: torch.Tensor, slots: torch.Tensor,
                 init: torch.Tensor | None = None,
                 op: str = "gg",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Packed compact sweep → (P, rows, ndev): op "gg" gives 3·NV gradient
    rows d*NV+v, op "flux" NV flux rows.

    var_T (P, NV, ndev) f32; srcs (P, nb, NV, L) from `pack_srcs`, f32
    values or bf16 deltas; slot_w (P, nb, 3, L) f32 or bf16; scale
    (P, nb, 1, bp) f32; block_ids (P, nb) i32; slots (2, K) i32 from
    `slot_table`.  Without init the output (out_dtype, default f32) is zero
    at the columns of blocks the plan does not list: the kernel writes
    those zeros itself, spread over its launch, into a `torch.empty`, so
    no fill of the whole output runs before it.  With init (P, rows,
    ndev) f32 or bf16 the sweep accumulates onto it IN PLACE and returns it
    — the reference aliases init to the output, so unlisted columns keep
    init's values, and out_dtype, if given, must be init's.  Counterpart of
    `cfd_proxy_tpu.ops.blocksweep.sweep_blocks(..., packed=True, wks=...,
    init=..., op=..., src_format=..., out_dtype=...)`.  Kernel:
    csrc/sweep_packed.cu.

    A bf16 var_T (the kernel bench's var16: the deltas were packed against
    the f32 of that bf16 state) is taken in the one form the bench reaches:
    op "gg" without init on bf16 weights, bf16 deltas and a bf16 output;
    any other combination is refused."""
    rows = _check_op(op)
    dims = _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init,
                        rows, DTYPES)
    odt = _out_dtype(init, out_dtype)
    v16 = var_T.dtype == BF16
    check(not v16 or (op == "gg" and init is None
                      and slot_w.dtype == srcs.dtype == odt == BF16),
          "sweep_blocks: a bf16 var_T runs op gg without init on bf16 "
          "slot_w, bf16 delta srcs and out_dtype bf16 only (got op %s, init "
          "%s, slot_w %s, srcs %s, out %s)", op,
          None if init is None else "given", slot_w.dtype, srcs.dtype, odt)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                                init, op, odt)
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = var_T.device
    P, _, _, _, ndev, _ = dims
    # the kernel zeroes the columns of unlisted blocks itself
    out = (torch.empty((P, rows, ndev), dtype=odt, device=dev)
           if init is None else init)
    flags = _flags(slot_w, srcs, out)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_packed(
            *_sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims),
            int(init is not None), OPS.index(op), *flags, int(v16),
            out.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks")
    _count(sweep_blocks, init, op, _tag(*flags, v16=v16))
    return out


# K1 (gg, zero-filled), K1-init, K1-flux, K1-flux-init, each in every
# precision, and K1 on a bf16 state in its one form
_zero_counts(sweep_blocks, _SWEEP_FORMS, _PACKED_TAGS,
             extra=(_tag(True, True, True, v16=True),))


# ---------------------------------------------------------- gather sweep

def sweep_blocks_gather_ref(var_T: torch.Tensor, exts: torch.Tensor,
                            slot_idx: torch.Tensor, slot_w: torch.Tensor,
                            scale: torch.Tensor, block_ids: torch.Tensor,
                            slots: torch.Tensor,
                            init: torch.Tensor | None = None,
                            op: str = "gg",
                            out_dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
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

    return _sweep_plain(var_T, scale, block_ids, slots, init, terms, op,
                        out_dtype=_out_dtype(init, out_dtype))


def staged_bytes(bp: int, ep: int) -> int:
    """Shared memory of the gather sweep's staged table: NV f32 values per
    column, bp own and EP ext columns (csrc/sweep_common.cuh)."""
    return NV * (bp + ep) * 4


def cluster_bytes(bp: int, ep: int) -> int:
    """Shared memory of each CUDA block of the cluster body: one of the
    staged table's two planes (csrc/sweep_common.cuh)."""
    return staged_bytes(bp, ep) // 2


def quad_bytes(bp: int, ep: int) -> int:
    """Shared memory of each CUDA block of the quad body: two of the staged
    table's eight variables, 8 B per column (csrc/sweep_common.cuh)."""
    return staged_bytes(bp, ep) // 4


def gather_body(bp: int, ep: int, op: str = "gg",
                fused: bool = False) -> str:
    """The gather sweep's body at block size bp and ext width EP (the live
    ext count's maximum, rounded up to 128 by the plan), by one fixed rule,
    where bp and EP are multiples of 4 (16-byte loads): "staged" (one CUDA
    block per listed entry stages its [own ‖ ext] table in shared memory)
    where two such blocks fit one SM (GATHER_STAGE_PAIR bytes); else
    "cluster" (two CUDA blocks per entry, each staging half the table and
    reading the other half from its peer's shared memory) where half of it
    fits one block (GATHER_STAGE_MAX); else, for op gg, "quad" (four CUDA
    blocks per entry, each staging two variables and sweeping its six
    output rows) where a quarter of it fits one block (up to about 29 000
    columns: the two-shard 96³ plans at bp 8192); else "direct" (the
    sources read from device memory, any bp).  Measured on an H100 (PERF.md
    section 6): at
    bp 512 staged 0.100 ms against cluster 0.134; at the one-shard AUTO
    plan (bp 4096, a 188 KB table, one staged block per SM) cluster 0.138
    against staged 0.185.  The fused kernel (fused: K3's gather form)
    follows the same rule, its push blocks sharing the cluster launch: at
    the one-shard interior plans cluster 0.16 ms against its one-block
    staged body's 0.33 (bp 4096) and direct 0.32 (bp 8192), flux 0.13
    against direct 0.23 and 0.29; its flux form keeps the
    direct body where the rule says staged, which did not beat it at bp
    512 (csrc/sweep_overlap.cu).  At the two-shard plans at bp 8192 the
    quad body took 0.156 ms for K2 gg against direct 0.309, 0.150 / 0.293
    for K2-init on the interior plan and 0.160 / 0.320 for K3-gather (0.118
    / 0.104 for K2-init on the boundary plan, whose lanes are mostly pads);
    flux, which splits the lanes and reads three of its four planes
    through distributed shared memory, 0.305 / 0.309 (K2), 0.305 / 0.294
    (K2-init) and 0.314 / 0.285 (K3-gather), so flux keeps the direct body
    there."""
    if bp % 4 or ep % 4:
        return "direct"
    if staged_bytes(bp, ep) <= GATHER_STAGE_PAIR:
        return "direct" if fused and op == "flux" else "staged"
    if cluster_bytes(bp, ep) <= GATHER_STAGE_MAX:
        return "cluster"
    if quad_bytes(bp, ep) <= GATHER_STAGE_MAX and op == "gg":
        return "quad"
    return "direct"


def cluster_threads(bp: int, ep: int) -> int:
    """Threads of each CUDA block of the cluster body, 512 to an SM: 512
    where one block takes an SM (bp 8192 at 96³: 0.127 ms against 0.139 at
    256) and 256 where two fit (bp 4096: 0.124 against 0.131 at 512); but
    no more warps than a block has 32-pair runs of lanes (bp / 128, two
    lanes a thread), and at least 128 threads (K3's push blocks copy with
    128): at bp 512 128 threads, where 256 left half of them idle (bp 512,
    EP 3200: 0.189 ms against 0.219 at 256; H100, PERF.md section 6)."""
    n = 256 if cluster_bytes(bp, ep) <= GATHER_STAGE_PAIR else 512
    return max(128, min(n, 32 * -(-bp // 128)))


def quad_threads(bp: int, ep: int) -> int:
    """Threads of each CUDA block of the quad body: 512, the most its
    kernels allow, where one block takes an SM (wherever the rule picks
    it: a quarter table past GATHER_STAGE_PAIR), else 256; but no more
    warps than a block has 32-lane-group runs (bp / 128, at least 128
    threads, as `cluster_threads`).  At the two-shard 96³ plans at bp 8192
    (H100, PERF.md section 6) 512 threads took 0.154 ms for K2 gg against
    0.234 at 256, and 0.66-0.72x of 256's time over the K2, K2-init and
    K3-gather plans; four lanes a thread (csrc/sweep_common.cuh::
    kQuadLanesGG) 0.65-0.80x of two's in gg and bf16."""
    n = 256 if quad_bytes(bp, ep) <= GATHER_STAGE_PAIR else 512
    return max(128, min(n, 32 * -(-bp // 128)))


def body_threads(body: str, bp: int, ep: int) -> int:
    """The threads a gather launch on `body` takes: `cluster_threads` or
    `quad_threads` (read at call time, so a test can force either); the
    other bodies ignore it."""
    return quad_threads(bp, ep) if body == "quad" else cluster_threads(bp, ep)


def ext_counts(slot_idx: np.ndarray, bp: int) -> np.ndarray:
    """(P, nb, K, bp) W-indices → (P, nb) int32 live ext columns per entry:
    the largest ext W-index + 1 − bp (0 for an entry without one).  The
    plan's ext list holds exactly the columns its slots name, in rank
    order, so this is the reference plan's `ext_cnt`; every W-index of the
    entry lies below bp + the count, so the staged body stages no more."""
    if slot_idx.size == 0:
        return np.zeros(slot_idx.shape[:2], np.int32)
    top = slot_idx.reshape(*slot_idx.shape[:2], -1).max(axis=2)
    return np.maximum(top.astype(np.int64) - bp + 1, 0).astype(np.int32)


def _check_gather(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                  init, rows, ext_cnt=None, sources="columns"):
    """Validate the gather sweep's operands; returns (P, nb, EP, bp, ndev,
    K).  The W-indices' range and the live ext counts are checked where the
    plan is loaded (models/gradients.py), not per call."""
    dev = var_T.device
    _expect(exts, "exts", F32, 4, dev)
    _expect(slot_idx, "slot_idx", torch.int32, 4, dev)
    _expect(slot_w, "slot_w", DTYPES, 5, dev)
    P, nb, _, ep = exts.shape
    bp, ndev, K = _check_common(var_T, scale, block_ids, slots, init, P, nb,
                                rows)
    _shape(exts, "exts", (P, nb, NV, ep))
    _shape(slot_idx, "slot_idx", (P, nb, K, bp))
    _shape(slot_w, "slot_w", (P, nb, K, 3, bp))
    check(ep > 0, "exts: EP must be positive")
    if ext_cnt is not None:
        _expect(ext_cnt, "ext_cnt", torch.int32, 2, dev)
        _shape(ext_cnt, "ext_cnt", (P, nb))
    check(sources in DIRECT_SOURCES, "sources %r: one of %s", sources,
          DIRECT_SOURCES)
    return P, nb, ep, bp, ndev, K


def direct_sources(bp: int, ep: int, lanes_per_column: float) -> str:
    """A gather plan's choice of where the direct body reads a slot lane's
    eight sources, made once where the plan is loaded
    (models/gradients.py keeps it beside the plan's ext counts): "table"
    (the point-major table `gather_table` builds before the sweep: two
    16-byte loads of one 32-byte sector a source) or "columns" (var_T and
    exts as they lie: eight 4-byte loads, each a sector of its own where a
    warp's W-indices scatter).  The table where the entry's column-major
    table passes GATHER_STAGE_PAIR (an SM's L1 no longer holds the sectors
    a warp's scattered loads touch) and the plan reads it enough:
    `lanes_per_column` (`table_lanes_per_column`) at least
    DIRECT_TABLE_LANES.  Measured on an H100 (PERF.md section 6 PR 20),
    direct forced: at the 96³ plans at bp 8192 the table took 0.46-0.61x
    the column-major reads' time (one and two shards, bulk and interior,
    flux and gg; 3.1-5.0 lanes a column), but 1.2-1.8x on the two-shard
    boundary plan, whose lanes are mostly pads (0.23 a column), and 1.5x
    at the eight-shard interior plan at bp 512 (a 48 KB table).
    DIRECT_TABLE_LANES only separates those two groups: no plan between
    0.23 and 3.1 lanes a column was measured, so where the two layouts
    cross is not known."""
    if staged_bytes(bp, ep) <= GATHER_STAGE_PAIR:
        return "columns"
    return "table" if lanes_per_column >= DIRECT_TABLE_LANES else "columns"


def table_lanes_per_column(slot_w: torch.Tensor, block_ids: torch.Tensor,
                           wks, ext_cnt: torch.Tensor) -> float:
    """A gather plan's real slot lanes (a nonzero weight within slot k's
    prefix [0, wks[k])) per column of the direct body's table (each listed
    entry's bp own and ext_cnt live ext columns; pad entries none): what
    the table's one-sector reads save against the bytes it costs.  On a
    48³ mesh (two shards at bp 2048, eight at bp 512) the bulk and interior
    plans read 2.3-2.9 lanes a column, the boundary plans 0.3-0.7: their
    entries are mostly pad lanes."""
    P, nb, K, _, bp = slot_w.shape
    first = torch.ones_like(block_ids, dtype=torch.bool)
    first[:, 1:] = block_ids[:, 1:] != block_ids[:, :-1]
    live = (torch.arange(bp, device=slot_w.device)
            < torch.tensor(list(wks), device=slot_w.device)[:, None])
    real = int(((slot_w != 0).any(dim=3) & live)[first].sum())
    cols = int(first.sum()) * bp + int(ext_cnt.long()[first].sum())
    return real / max(cols, 1)


def gather_table_ref(var_T: torch.Tensor, exts: torch.Tensor,
                     block_ids: torch.Tensor, bp: int) -> torch.Tensor:
    """Plain version of the direct body's table: (P, nb, bp + EP, NV) f32,
    entry (p, b)'s own columns var_T[p, :, base : base + bp] (base =
    block_ids[p, b]·bp) then its EP ext columns, each column's NV values
    contiguous.  The kernel writes only the listed entries' own and live
    ext columns (`table_written`)."""
    own = _block_cols(var_T, block_ids, bp)        # (P, nb, NV, bp)
    return torch.cat([own, exts], dim=3).transpose(2, 3).contiguous()


def table_written(block_ids: torch.Tensor, bp: int, ep: int,
                  ext_cnt: torch.Tensor | None = None) -> torch.Tensor:
    """(P, nb, bp + EP) bool: the columns of the direct body's table the
    kernel writes (and the sweep reads): every entry's own columns and its
    first ext_cnt ext columns (None: all), pad entries (a repeat of the
    entry before) none."""
    P, nb = block_ids.shape
    cnt = (torch.full((P, nb), ep, dtype=torch.int64) if ext_cnt is None
           else ext_cnt.cpu().long().clamp(0, ep))
    cols = torch.arange(bp + ep)
    w = cols[None, None, :] < (bp + cnt)[:, :, None]
    ids = block_ids.cpu()
    pad = torch.zeros((P, nb), dtype=torch.bool)
    pad[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return w & ~pad[:, :, None]


def gather_table(var_T: torch.Tensor, exts: torch.Tensor,
                 block_ids: torch.Tensor, bp: int, *,
                 ext_cnt: torch.Tensor | None = None) -> torch.Tensor:
    """The direct gather body's source table (P, nb, bp + EP, NV) f32
    (`gather_table_ref`'s layout; operands as `sweep_blocks_gather` takes
    them); on CUDA tensors only the columns `table_written` names are
    written.  It replaces no TPU kernel of its own: it is the reference's
    block table [own ‖ exts] of `_block_compute`, laid out point-major so
    that the direct sweep resolves a W-index with two 16-byte loads.
    Kernel: csrc/sweep_gather.cu (`cfd_gather_table`)."""
    dev = var_T.device
    _expect(var_T, "var_T", F32, 3, dev)
    _expect(exts, "exts", F32, 4, dev)
    _expect(block_ids, "block_ids", torch.int32, 2, dev)
    P, nb, _, ep = exts.shape
    _shape(exts, "exts", (P, nb, NV, ep))
    _shape(block_ids, "block_ids", (P, nb))
    check(var_T.shape[:2] == (P, NV), "var_T: shape %s, want (%d, %d, ndev)",
          tuple(var_T.shape), P, NV)
    check(bp > 0 and ep > 0, "gather_table: bp and EP must be positive")
    if ext_cnt is not None:
        _expect(ext_cnt, "ext_cnt", torch.int32, 2, dev)
        _shape(ext_cnt, "ext_cnt", (P, nb))
    if _device_kind(var_T) == "cpu":
        return gather_table_ref(var_T, exts, block_ids, bp)
    with torch.cuda.device(dev):
        return _launch_table(var_T, exts, block_ids, bp, ext_cnt,
                             _stream(dev))


def _launch_table(var_T, exts, block_ids, bp, ext_cnt,
                  stream: int) -> torch.Tensor:
    """`gather_table`'s launch on checked CUDA operands (the gather
    wrappers' own, which they checked already) on `stream`, inside the
    caller's device context; counted."""
    from cfd_proxy_tpu_torch.ops import _cuda

    P, nb, _, ep = exts.shape
    tbl = torch.empty((P, nb, bp + ep, NV), dtype=F32, device=var_T.device)
    rc = _cuda.lib().cfd_gather_table(
        var_T.data_ptr(), var_T.shape[2], exts.data_ptr(), ep,
        block_ids.data_ptr(), None if ext_cnt is None else ext_cnt.data_ptr(),
        P, nb, bp, tbl.data_ptr(), stream)
    _cuda.check_launch(rc, "gather_table")
    gather_table.launches += 1
    return tbl


# the table build, one instance
_zero_counts(gather_table, ("",), ("",))


def _gather_ptrs(var_T, exts, slot_idx, slot_w, scale, block_ids, slots,
                 dims, ext_cnt, op, out, stream, sources, fused=False):
    """The gather entry points' sweep operands, the live ext counts, the
    direct body's table and the body `gather_body` picks (its
    GATHER_BODY_CODES code), and the table tensor (None but for the direct
    body reading it, sources "table": launched here on `stream`, inside
    the caller's device context), which must outlive the launch; the
    staged, cluster and quad bodies load var_T and exts 16 bytes at a
    time, the cluster body two lanes' W-indices, weights, scale and output
    at a time, the quad body QUAD_LANES[op] lanes'."""
    P, nb, ep, bp, ndev, K = dims
    body = gather_body(bp, ep, op, fused)
    check(body == "direct" or (var_T.data_ptr() % 16 == 0
                               and exts.data_ptr() % 16 == 0),
          "the %s gather sweep loads var_T and exts 16 bytes at a time: "
          "both must be 16-byte aligned", body)
    lanes = {"cluster": 2, "quad": QUAD_LANES[op]}.get(body, 1)
    word = {1: "one", 2: "two", 4: "four"}[lanes]
    check(all(t.data_ptr() % (lanes * t.element_size()) == 0
              for t in (slot_idx, slot_w, scale, out)),
          "the %s gather sweep loads and stores %s lanes at a time: "
          "slot_idx, slot_w, scale and the output must be aligned to %s "
          "elements", body, word, word)
    tbl = None
    if body == "direct" and sources == "table":
        tbl = _launch_table(var_T, exts, block_ids, bp, ext_cnt, stream)
    return (var_T.data_ptr(), ndev, exts.data_ptr(), ep, slot_idx.data_ptr(),
            slot_w.data_ptr(), scale.data_ptr(), block_ids.data_ptr(),
            slots.data_ptr(), K, P, nb, bp,
            None if ext_cnt is None else ext_cnt.data_ptr(),
            None if tbl is None else tbl.data_ptr(),
            GATHER_BODY_CODES[body]), tbl


def _body_of(ptrs: tuple) -> str:
    """The body _gather_ptrs picked."""
    return {c: b for b, c in GATHER_BODY_CODES.items()}[ptrs[-1]]


def sweep_blocks_gather(var_T: torch.Tensor, exts: torch.Tensor,
                        slot_idx: torch.Tensor, slot_w: torch.Tensor,
                        scale: torch.Tensor, block_ids: torch.Tensor,
                        slots: torch.Tensor,
                        init: torch.Tensor | None = None,
                        op: str = "gg",
                        out_dtype: torch.dtype | None = None, *,
                        ext_cnt: torch.Tensor | None = None,
                        sources: str = "columns") -> torch.Tensor:
    """Gather-formulation sweep → (P, rows, ndev), rows and output dtype as
    in `sweep_blocks`.

    var_T (P, NV, ndev) f32; exts (P, nb, NV, EP) f32 from `gather_exts`;
    slot_idx (P, nb, K, bp) i32 W-indices in [0, bp + EP); slot_w
    (P, nb, K, 3, bp) f32 or bf16; scale, block_ids, init and out_dtype as
    in `sweep_blocks`; slots (2, K) i32 from `slot_table(wks)` (only the
    widths are read); ext_cnt (P, nb) i32, each entry's live ext columns
    (`ext_counts`; every W-index below bp + its count), which the staged
    and cluster bodies stage instead of all EP (None: all); sources where
    the direct body reads a slot lane's sources: "columns" (var_T and exts
    as they lie) or "table" (the point-major table `gather_table` builds
    first), the plan's choice (`direct_sources`, which a model makes where
    it loads the plan and passes here; the other bodies ignore it).  The
    kernel's
    body is `gather_body(bp, EP)`'s (the cluster body's CUDA blocks take
    `cluster_threads(bp, EP)` threads, the quad body's
    `quad_threads(bp, EP)`).  Counterpart of
    `cfd_proxy_tpu.ops.blocksweep.sweep_blocks(..., packed=False, wks=...,
    init=..., op=..., out_dtype=...)`.  Kernel: csrc/sweep_gather.cu."""
    rows = _check_op(op)
    dims = _check_gather(var_T, exts, slot_idx, slot_w, scale, block_ids,
                         slots, init, rows, ext_cnt, sources)
    odt = _out_dtype(init, out_dtype)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_gather_ref(var_T, exts, slot_idx, slot_w, scale,
                                       block_ids, slots, init, op, odt)
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = var_T.device
    P, _, ep, bp, ndev, _ = dims
    # the kernel zeroes the columns of unlisted blocks itself
    out = (torch.empty((P, rows, ndev), dtype=odt, device=dev)
           if init is None else init)
    w16, o16 = _flags(slot_w, out)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        ptrs, tbl = _gather_ptrs(var_T, exts, slot_idx, slot_w, scale,
                                 block_ids, slots, dims, ext_cnt, op, out,
                                 stream, sources)
        body = _body_of(ptrs)
        rc = _cuda.lib().cfd_sweep_gather(
            *ptrs, int(init is not None), OPS.index(op), w16, o16,
            body_threads(body, bp, ep), out.data_ptr(), stream)
    _cuda.check_launch(rc, "sweep_blocks_gather")
    _count(sweep_blocks_gather, init, op,
           _tag(w16, False, o16) + _BODY_TAGS[body])
    return out


# K2, K2-init, K2-flux, K2-flux-init, each with f32 or bf16 weights and out,
# each in its staged, cluster, quad and direct body
_zero_counts(sweep_blocks_gather, _SWEEP_FORMS, _GATHER_BODY_TAGS)


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


def _push_plain(sendbufs, dsts, transport):
    """The push's plain version: through `transport` (a `Loopback` or `Dist`
    of parallel/transport.py, which carries its own map) when given, else
    the loopback of the push map dsts."""
    if transport is not None:
        return transport.exchange(sendbufs)
    return loopback(sendbufs, dsts.to(sendbufs.device))


def sweep_blocks_overlap_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                             init, sendbufs, dsts, src_devs, op="gg",
                             transport=None):
    """Plain version of the fused kernel: the interior sweep accumulating
    onto init (in place), then the push of every shard's send buffers —
    with `transport`, of this rank's, through it (dsts and src_devs are
    then not read)."""
    del src_devs                    # the push map alone moves the data
    grad = sweep_blocks_ref(var_T, srcs, slot_w, scale, block_ids, slots,
                            init, op)
    return grad, _push_plain(sendbufs, dsts, transport)


def expect_aligned(sendbufs: torch.Tensor, name: str) -> None:
    """The push is a byte copy in 16-byte pieces, whatever the dtype."""
    s_max = sendbufs.shape[-1]
    check((s_max * sendbufs.element_size()) % 16 == 0
          and sendbufs.data_ptr() % 16 == 0 and sendbufs.is_contiguous(),
          "%s: rows of s_max %d %s elements must be a multiple of 16 "
          "bytes on a 16-byte aligned base (16-byte copies)", name, s_max,
          sendbufs.dtype)


def check_push_map(d: np.ndarray, s: np.ndarray) -> None:
    """Every d[:, k] must be a permutation of the shards and s[:, k] its
    inverse: one push per receiver, so no two shards write the same recv
    buffer."""
    P, nph = d.shape
    check(d.shape == s.shape, "dsts %s and src_devs %s differ in shape",
          d.shape, s.shape)
    check(((d >= 0) & (d < P)).all(), "dsts outside [0, %d): %s", P,
          np.unique(d[(d < 0) | (d >= P)]).tolist())
    check((s[d, np.arange(nph)[None, :]] == np.arange(P)[:, None]).all(),
          "dsts/src_devs are not mutually inverse permutations per phase")


def _check_push(sendbufs, dsts, src_devs, P, dev, rows):
    """Validate the push operands; returns (nph, s_max, the device copy of
    the push map)."""
    _expect(sendbufs, "sendbufs", DTYPES, 4, dev)
    cpu = torch.device("cpu")
    _expect(dsts, "dsts", torch.int32, 2, cpu)
    _expect(src_devs, "src_devs", torch.int32, 2, cpu)
    nph = dsts.shape[1]
    _shape(dsts, "dsts", (P, nph))
    _shape(src_devs, "src_devs", (P, nph))
    s_max = sendbufs.shape[3]
    _shape(sendbufs, "sendbufs", (P, nph, rows, s_max))
    expect_aligned(sendbufs, "sendbufs")
    dmap = _push_table(dsts.numpy().tobytes(), src_devs.numpy().tobytes(),
                       tuple(dsts.shape), str(dev))
    return nph, s_max, dmap


@lru_cache(maxsize=16)
def _push_table(dsts: bytes, src_devs: bytes, shape: tuple,
                device: str) -> torch.Tensor:
    """Check a push map (`check_push_map`) once per distinct map and hold
    its device copy.  A map that fails raises (and is not cached)."""
    d = np.frombuffer(dsts, np.int32).reshape(shape)
    check_push_map(d, np.frombuffer(src_devs, np.int32).reshape(shape))
    return torch.from_numpy(d.copy()).to(device)


# the peer push's launch modes: csrc/push_common.cuh's bit set (1 the
# readiness barrier, 2 the copy, 4 phase 0 copied locally without the copy)
PUSH_MODES = {"full": 1 | 2, "nobar": 2, "nodma": 0, "baronly": 1 | 4,
              "empty": 4}


def _check_peer(peer, sendbufs, P, dev, rows, debug) -> str:
    """Validate the peer form's push operands; returns the launch mode."""
    check(dev.type == "cuda", "the peer form pushes to mapped device "
          "memory: CUDA tensors only")
    check(debug in (None, "nobar", "nodma"), "unknown overlap debug mode %r "
          "(nobar or nodma)", debug)
    peer.check_sendbufs(sendbufs)
    check(sendbufs.shape[0] == P and sendbufs.shape[2] == rows,
          "sendbufs %s for %d shards of %d rows", tuple(sendbufs.shape), P,
          rows)
    return debug or "full"


def _peer_args(peer, sendbufs, mode: str) -> tuple:
    """The peer form's push arguments (ops/_cuda.py); the launch epochs are
    device words of the transport's exchange block, which the kernel reads
    and advances, so nothing here changes from one launch to the next."""
    return (sendbufs.data_ptr(), sendbufs.element_size(),
            peer.table.data_ptr(), peer.flags, peer.recv.data_ptr(),
            sendbufs.shape[1], sendbufs.shape[3], PUSH_MODES[mode])


def sweep_blocks_overlap(var_T: torch.Tensor, srcs: torch.Tensor,
                         slot_w: torch.Tensor, scale: torch.Tensor,
                         block_ids: torch.Tensor, slots: torch.Tensor,
                         init: torch.Tensor, sendbufs: torch.Tensor,
                         dsts: torch.Tensor | None,
                         src_devs: torch.Tensor | None,
                         op: str = "gg", peer=None, debug: str | None = None):
    """Fused interior sweep + halo push → (grad, recv).

    The sweep operands, `init` and `op` are as in `sweep_blocks` (grad is
    init, updated in place; its dtype is the output's).  sendbufs (P, nph,
    rows, s_max) f32 or bf16 (the reference's halo_dtype) on the sweep's
    device: shard p's phase-k payload.  dsts / src_devs (P, nph)
    int32 on the CPU: the static push map (destination shard of p's phase-k
    payload, and the reference's `srcs`, its inverse); both are checked on
    the host.  recv (P, nph, rows, s_max): recv[dsts[p, k], k] =
    sendbufs[p, k].

    With `peer` (a `Peer` of parallel/transport.py, CUDA only; dsts and
    src_devs are then not read: the transport holds the map) the operands
    are one rank's shards and the push goes to the transport's mapped
    addresses, in this process or another, behind the readiness barrier;
    recv is the transport's persistent buffer, valid until the next launch
    on it.  debug "nobar" / "nodma": the reference's kernel debug rungs (no
    barrier; neither barrier nor copy, recv untouched), for timing only.
    Counterpart of `cfd_proxy_tpu.ops.blocksweep.sweep_blocks_overlap`
    (packed, compact).  Kernel: csrc/sweep_overlap.cu."""
    check(init is not None, "sweep_blocks_overlap accumulates onto init")
    rows = _check_op(op)
    dims = _check_sweep(var_T, srcs, slot_w, scale, block_ids, slots, init,
                        rows)
    dev = var_T.device
    if peer is not None:
        mode = _check_peer(peer, sendbufs, dims[0], dev, rows, debug)
        from cfd_proxy_tpu_torch.ops import _cuda

        flags = _flags(slot_w, srcs, init)
        with torch.cuda.device(dev):
            rc = _cuda.lib().cfd_sweep_overlap_peer(
                *_sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots,
                             dims),
                OPS.index(op), *flags, init.data_ptr(),
                *_peer_args(peer, sendbufs, mode), _stream(dev))
        _cuda.check_launch(rc, "sweep_blocks_overlap (peer)")
        _count(sweep_blocks_overlap, None, op, _tag(*flags), peer=True)
        return init, peer.recv
    check(debug is None, "debug %r: a mode of the peer form", debug)
    nph, s_max, dmap = _check_push(sendbufs, dsts, src_devs, dims[0], dev,
                                   rows)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_overlap_ref(var_T, srcs, slot_w, scale,
                                        block_ids, slots, init, sendbufs,
                                        dsts, src_devs, op)
    from cfd_proxy_tpu_torch.ops import _cuda

    recv = torch.zeros_like(sendbufs)
    flags = _flags(slot_w, srcs, init)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_sweep_overlap(
            *_sweep_ptrs(var_T, srcs, slot_w, scale, block_ids, slots, dims),
            OPS.index(op), *flags, init.data_ptr(), sendbufs.data_ptr(),
            sendbufs.element_size(), dmap.data_ptr(), nph, s_max,
            recv.data_ptr(), _stream(dev))
    _cuda.check_launch(rc, "sweep_blocks_overlap")
    _count(sweep_blocks_overlap, None, op, _tag(*flags))
    return init, recv


# K3 and K3-flux, loopback and peer form, in every precision (the push
# moves bytes: f32 or bf16 send buffers run the same instance)
_zero_counts(sweep_blocks_overlap, _FUSED_FORMS, _PACKED_TAGS)


def sweep_blocks_overlap_gather_ref(var_T, exts, slot_idx, slot_w, scale,
                                    block_ids, slots, init, sendbufs, dsts,
                                    src_devs, op="gg", transport=None):
    """Plain version of the fused kernel's gather form."""
    del src_devs
    grad = sweep_blocks_gather_ref(var_T, exts, slot_idx, slot_w, scale,
                                   block_ids, slots, init, op)
    return grad, _push_plain(sendbufs, dsts, transport)


def sweep_blocks_overlap_gather(var_T: torch.Tensor, exts: torch.Tensor,
                                slot_idx: torch.Tensor, slot_w: torch.Tensor,
                                scale: torch.Tensor, block_ids: torch.Tensor,
                                slots: torch.Tensor, init: torch.Tensor,
                                sendbufs: torch.Tensor,
                                dsts: torch.Tensor | None,
                                src_devs: torch.Tensor | None,
                                op: str = "gg", peer=None,
                                debug: str | None = None, *,
                                ext_cnt: torch.Tensor | None = None,
                                sources: str = "columns"):
    """Fused interior sweep (gather formulation) + halo push → (grad,
    recv): the sweep operands (and `ext_cnt`, `sources`) as in
    `sweep_blocks_gather`,
    the body `gather_body(bp, EP, op, fused=True)`'s (the cluster and quad
    bodies' CUDA blocks, push blocks included, take `cluster_threads(bp,
    EP)` and `quad_threads(bp, EP)` threads, of which 128 copy in a push
    block), the push (and `peer`,
    `debug`) as in `sweep_blocks_overlap`.  Counterpart of
    `cfd_proxy_tpu.ops.blocksweep.sweep_blocks_overlap(..., packed=False)`.
    Kernel: csrc/sweep_overlap.cu (its gather instances)."""
    check(init is not None, "sweep_blocks_overlap_gather accumulates onto "
          "init")
    rows = _check_op(op)
    dims = _check_gather(var_T, exts, slot_idx, slot_w, scale, block_ids,
                         slots, init, rows, ext_cnt, sources)
    dev = var_T.device
    if peer is not None:
        mode = _check_peer(peer, sendbufs, dims[0], dev, rows, debug)
        from cfd_proxy_tpu_torch.ops import _cuda

        w16, o16 = _flags(slot_w, init)
        with torch.cuda.device(dev):
            stream = _stream(dev)
            ptrs, tbl = _gather_ptrs(var_T, exts, slot_idx, slot_w, scale,
                                     block_ids, slots, dims, ext_cnt, op,
                                     init, stream, sources, fused=True)
            body = _body_of(ptrs)
            rc = _cuda.lib().cfd_sweep_overlap_gather_peer(
                *ptrs, OPS.index(op), w16, o16,
                body_threads(body, dims[3], dims[2]), init.data_ptr(),
                *_peer_args(peer, sendbufs, mode), stream)
        _cuda.check_launch(rc, "sweep_blocks_overlap_gather (peer)")
        _count(sweep_blocks_overlap_gather, None, op,
               _tag(w16, False, o16) + _BODY_TAGS[body], peer=True)
        return init, peer.recv
    check(debug is None, "debug %r: a mode of the peer form", debug)
    nph, s_max, dmap = _check_push(sendbufs, dsts, src_devs, dims[0], dev,
                                   rows)
    if _device_kind(var_T) == "cpu":
        return sweep_blocks_overlap_gather_ref(
            var_T, exts, slot_idx, slot_w, scale, block_ids, slots, init,
            sendbufs, dsts, src_devs, op)
    from cfd_proxy_tpu_torch.ops import _cuda

    recv = torch.zeros_like(sendbufs)
    w16, o16 = _flags(slot_w, init)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        ptrs, tbl = _gather_ptrs(var_T, exts, slot_idx, slot_w, scale,
                                 block_ids, slots, dims, ext_cnt, op, init,
                                 stream, sources, fused=True)
        body = _body_of(ptrs)
        rc = _cuda.lib().cfd_sweep_overlap_gather(
            *ptrs, OPS.index(op), w16, o16,
            body_threads(body, dims[3], dims[2]), init.data_ptr(),
            sendbufs.data_ptr(), sendbufs.element_size(), dmap.data_ptr(),
            nph, s_max, recv.data_ptr(), stream)
    _cuda.check_launch(rc, "sweep_blocks_overlap_gather")
    _count(sweep_blocks_overlap_gather, None, op,
           _tag(w16, False, o16) + _BODY_TAGS[body])
    return init, recv


# K3-gather and K3-gather-flux with f32 or bf16 weights and out, loopback
# and peer form, each in its staged, cluster, quad and direct body
_zero_counts(sweep_blocks_overlap_gather, _FUSED_FORMS, _GATHER_BODY_TAGS)
