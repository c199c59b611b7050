// Per-thread body of the block sweep, shared by K1 (sweep_packed.cu), K2
// (sweep_gather.cu) and both forms of K3 (sweep_overlap.cu), for both ops.
//
// Replaces the bodies of cfd_proxy_tpu/ops/blocksweep.py::
// _block_compute_packed (K1, the packed formulation) and _block_compute
// (K2, the gather formulation), ops "gg" and "flux", with and without
// their `accumulate` operand, in every precision the reference takes.  For
// point column `col` of listed block b of shard p (lane l = col -
// block_ids[p, b]*bp), over the live slots k (l < wks[k]) with source src_k
// and weights w_k (3):
//
//   gg   (Green-Gauss, kRows = 3*NV output rows d*NV+v):
//     acc[d*NV+v] += w_k[d] * 0.5f*(own[v] + src_k[v])
//   flux (the PSD upwind flux of ops/flux.py, directed-slot form, kNV rows):
//     udw = own[0]w0 + own[1]w1 + own[2]w2;  uow = src_k[0]w0 + ... ;
//     a = max(|udw|, |uow|)
//     acc[v] += 0.5f*(udw*own[v] + uow*src_k[v]) - 0.5f*a*(src_k[v] - own[v])
//
//   acc starts at (accumulate ? out[p, r, col] : 0);
//   out[p, r, col] = scale[p, b, l] * acc[r]
//
// Reduced precision (the reference's meta_dtype, src_dtype and grad_dtype
// options).  Three element types are template parameters: the weights
// (f32 or bf16), the packed sources (f32 values, or bf16 DELTAS
// src_k - own written by K4's bf16d form) and the output, which is also
// init (f32 or bf16).  Every bf16 operand is widened to f32 as it is loaded
// (__bfloat162float, exact); the accumulators stay f32 in registers and
// only the final store rounds, round-to-nearest-even (__float2bfloat16_rn,
// as astype(bfloat16) in the reference).  With deltas d_k the reference
// rebuilds its terms in f32 (_block_compute_packed :490-497):
//
//   gg   avg = own[v] + 0.5f*d_k[v]          (not 0.5f*(own + src))
//   flux src_k[v] = own[v] + d_k[v], then the flux terms above unchanged
//
// scale stays f32 in every form, and so does the state var_T, but for one
// instance of K1 (sweep_packed.cu): the kernel bench's var16, which reads a
// bf16 state, widened as it is loaded like every other bf16 operand
// (own_ref[:].astype(f32) in the reference body).
// The two formulations differ only in where slot k's source and weights
// are read, which the `Src` policy of sweep_chunk decides:
//
// - PackedSrc (K1): the source values were gathered ahead of the sweep
//   (K4, pack_srcs.cu) into the compact (P, nb, NV, L) table; slot k's
//   sources and its (P, nb, 3, L) weights sit at lane offset off_k.
// - GatherSrc (K2): the sweep gathers each source itself from the block
//   table [own (NV, bp) ‖ exts (NV, EP)] by the W-index slot_idx[p, b, k, l]
//   (own column block*bp + i for i < bp, else ext column i - bp of the
//   entry's pre-gathered ext table), with rectangular (P, nb, K, 3, bp)
//   weights.  The reference's _masked_gather (W/128 compare-and-select
//   passes) exists because a TPU gather shuffles within one vreg; here it
//   is one indexed load per variable (of global memory in the direct body,
//   of shared memory in the staged one: below).  Pad slots hold W-index 0
//   and zero weight: they read own column 0 and add nothing (under flux
//   too: with w = 0, udw = uow = a = 0).
//
// The reference's gather kernel skips slot k for a whole 128-lane tile when
// wks[k] <= t*128; wks are multiples of 128, so the per-lane test below
// skips exactly the same (lane, slot) pairs.  Both policies feed the same
// arithmetic in the same order, so K1 and K2 agree bit for bit on the same
// plan.
//
// The Pallas kernels walk one block per grid step with the slot loop
// unrolled over static widths; here every (shard, block) entry of the plan
// runs in parallel, one thread per point column, and the slot loop reads
// (width, offset) pairs from a small table.  With `accumulate` the output
// is also the `init` operand (the reference aliases the two): each thread
// reads its own output rows and writes them back, so no column is touched
// by two threads.
//
// Pad entries.  Shards share one block-list length; a shorter list is
// padded with entries that all name the shard's trailing TRASH block
// (models/gradients_pallas.py::_pad_blocks).  Run at once, those entries
// would read and write the same columns concurrently.  Real block lists
// are strictly ascending, so a pad entry is exactly an entry equal to its
// predecessor: it is skipped, and the first entry naming the trash block
// computes it once, as the reference's sequential grid leaves it.
//
// Bound: memory.  Per point it streams own 32 B, scale 4 B, out 96 B (gg)
// or 32 B (flux) (and init as much again when accumulating) and, per live
// slot, 12 B of weights plus, packed, 32 B of sources or, gathered, a 4 B
// W-index; a gathered source is a column of the block table, which holds
// the block's own columns (read anyway) and its ext columns (read once per
// block at best); bf16 weights, deltas and outputs halve their streams (6 B
// of weights and 16 B of deltas per slot lane, 48 B or 16 B of output per
// point).  A bf16 load is one 2-byte element per thread, still coalesced
// along the point columns, in transactions half as wide: the simple form,
// not yet paired into __nv_bfloat162 loads.  The math is 24 FMAs per slot
// (gg) or ~6 + 4*8 operations (flux).  Design: the accumulators (24 gg, 8
// flux) and the 8 own values stay in registers for the whole slot loop, so
// nothing but the streams touches memory; every stream is coalesced along
// the point columns.  Slot widths are per-slot and need not be monotone (a
// slot of zero-normal faces can be narrower than a later one), so every
// slot is tested and none ends the loop; zero-width slots have no table
// entries and no offset of their own.  The operation order is the
// reference body's; nvcc's default FMA contraction moves results by a few
// ulp (under flux it can also move max(|udw|, |uow|) to the other branch
// near a tie, where the two are within those few ulp of each other, so the
// result stays continuous).
//
// The gather form has two bodies, one per CUDA block shape:
//
// - sweep_chunk with GatherSrc (the DIRECT body): one CUDA block per
//   (shard, entry, 128-lane chunk); each live slot lane reads its eight
//   sources straight from global memory through the read-only cache, eight
//   scattered 4-byte loads at stride ndev (own) or EP (ext).  A warp's load
//   of one variable touches up to 32 sectors, eight times per slot: the
//   body runs at about half of its bound (PERF.md section 6).  It needs no
//   shared memory, so it takes any bp.
// - sweep_entry_staged (the STAGED body): one CUDA block per listed
//   (shard, entry), which stages the entry's table [own (NV, bp) ‖ the live
//   ext columns (NV, ext_cnt)] in shared memory with 16-byte loads, once,
//   then walks the entry's bp lanes blockDim.x at a time and resolves every
//   slot lane's W-index there.  Each table column is read from device
//   memory once per entry, which is what the bound counts.  It needs
//   staged_bytes(bp, EP) of shared memory, so the wrappers take it only
//   where that fits with room for several CUDA blocks per SM
//   (ops/blocksweep.py::gather_body); both bodies compute the same values
//   in the same order, so they agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cfd {

constexpr int kNV = 8;            // padded variable count (ops/plan.py::NV)
constexpr int kRows = 3 * kNV;    // gg output rows d*NV+v
constexpr int kMaxSlots = 64;     // slot-table capacity (checked by the wrapper)
constexpr int kThreads = 128;

using bf16 = __nv_bfloat16;

// A stored element type from an entry point's dtype flag.
template <bool kBf16>
using Elt = std::conditional_t<kBf16, bf16, float>;

// Loads widen to f32 (exact); the store rounds to nearest even.  The f32
// overloads are the plain loads and store of the f32 instances.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
// int8 (the kernel bench's quantized deltas): a 1-byte read-only load; the
// int -> float conversion is exact.
__device__ __forceinline__ float ld(const int8_t* p) {
  return static_cast<float>(__ldg(p));
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Operands both formulations share; OutT is the output's (and init's)
// element type, VarT the state's (bf16 in K1's var16 instance only).
template <class OutT, class VarT = float>
struct SweepArgs {
  const VarT* var_T;        // (P, NV, ndev)
  int64_t ndev;
  const float* scale;       // (P, nb, bp)
  const int32_t* block_ids; // (P, nb)
  const int32_t* slots;     // (2, K) width, offset
  int K;
  int64_t nb;
  int bp;
  int64_t chunks;           // kThreads-column chunks per block
  OutT* out;                // (P, rows, ndev); also init when accumulating
};

// The sweep's arithmetic (see the header comment).
enum class Op { kGG, kFlux };

// Output rows of an op: 3*NV gradient rows or NV flux rows.
__host__ __device__ constexpr int op_rows(Op op) {
  return op == Op::kGG ? kRows : kNV;
}

// The op as the C entry points take it: its index in
// ops/blocksweep.py::OPS, 0 gg and 1 flux; any other value is refused
// before a launch.
inline bool op_ok(int op) { return op == 0 || op == 1; }

// Where slot k's values are for one lane: sources at src + v*src_stride,
// weights at w + d*w_stride.
template <class SrcT, class WT>
struct SlotPtrs {
  const SrcT* src;
  int64_t src_stride;
  const WT* w;
  int64_t w_stride;
};

// K1: the packed compact source table; SrcT bf16 holds deltas src - own
// (the reference's src_format "bf16d", packed only).
template <class WT, class SrcT>
struct PackedSrc {
  static constexpr bool kDelta = std::is_same<SrcT, bf16>::value;
  const SrcT* srcs;         // (P, nb, NV, L)
  const WT* slot_w;         // (P, nb, 3, L)
  int64_t L;

  template <class Args>
  __device__ __forceinline__ SlotPtrs<SrcT, WT> slot(
      const Args&, int64_t g, int /*k*/, int off, int lane,
      const void* /*own_blk*/) const {
    const int64_t j = static_cast<int64_t>(off) + lane;
    return {srcs + g * kNV * L + j, L, slot_w + g * 3 * L + j, L};
  }
};

// K2: gather from [own ‖ exts] by the W-index; the sources are the f32
// state (the reference refuses bf16 sources with this formulation).
template <class WT>
struct GatherSrc {
  static constexpr bool kDelta = false;
  const float* exts;        // (P, nb, NV, EP)
  const int32_t* slot_idx;  // (P, nb, K, bp) W-index in [0, bp + EP)
  const WT* slot_w;         // (P, nb, K, 3, bp)
  int64_t ep;

  template <class OutT>
  __device__ __forceinline__ SlotPtrs<float, WT> slot(
      const SweepArgs<OutT>& a, int64_t g, int k, int /*off*/, int lane,
      const float* own_blk) const {
    const int64_t row = g * a.K + k;                 // (shard, entry, slot)
    const int i = __ldg(slot_idx + row * a.bp + lane);
    const bool own = i < a.bp;
    return {own ? own_blk + i : exts + g * kNV * ep + (i - a.bp),
            own ? a.ndev : ep, slot_w + row * 3 * a.bp + lane, a.bp};
  }
};

// Grid blocks a sweep needs: one per (shard, entry, chunk).
inline int64_t sweep_grid(int64_t P, int64_t nb, int bp, int64_t* chunks) {
  *chunks = (bp + kThreads - 1) / kThreads;
  return P * nb * (*chunks);
}

// One kThreads-column chunk of one (shard, entry); `blk` in
// [0, P*nb*chunks).  The early returns are uniform over the CUDA block up
// to the barrier.
template <bool kAccumulate, Op kOp, class Src, class OutT, class VarT>
__device__ __forceinline__ void sweep_chunk(const SweepArgs<OutT, VarT>& a,
                                            const Src& s, int64_t blk) {
  constexpr int R = op_rows(kOp);
  __shared__ int s_width[kMaxSlots];
  __shared__ int s_off[kMaxSlots];
  const int64_t g = blk / a.chunks;     // flat (shard, entry) index
  const int64_t b = g % a.nb;           // entry within the shard's list
  if (b > 0 && a.block_ids[g] == a.block_ids[g - 1]) return;   // pad entry
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    s_width[k] = a.slots[k];
    s_off[k] = a.slots[a.K + k];
  }
  __syncthreads();

  const int lane = static_cast<int>((blk % a.chunks) * kThreads) +
                   static_cast<int>(threadIdx.x);
  if (lane >= a.bp) return;
  const int64_t shard = g / a.nb;
  const int64_t ndev = a.ndev;
  const int64_t base = static_cast<int64_t>(a.block_ids[g]) * a.bp;
  const int64_t col = base + lane;
  const VarT* own_p = a.var_T + shard * kNV * ndev;
  OutT* out_p = a.out + shard * R * ndev;

  float own[kNV];
#pragma unroll
  for (int v = 0; v < kNV; ++v) own[v] = ld(own_p + v * ndev + col);

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = kAccumulate ? widen(out_p[r * ndev + col]) : 0.0f;
  }

  for (int k = 0; k < a.K; ++k) {
    if (lane >= s_width[k]) continue;       // outside slot k's prefix
    const auto p = s.slot(a, g, k, s_off[k], lane, own_p + base);
    float w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = ld(p.w + d * p.w_stride);
    if constexpr (kOp == Op::kGG) {
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const float sv = ld(p.src + v * p.src_stride);
        const float avg = Src::kDelta ? own[v] + 0.5f * sv
                                      : 0.5f * (own[v] + sv);
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d * kNV + v] += w[d] * avg;
      }
    } else {
      float src[kNV];
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        src[v] = ld(p.src + v * p.src_stride);
        if constexpr (Src::kDelta) src[v] = own[v] + src[v];
      }
      const float udw = own[0] * w[0] + own[1] * w[1] + own[2] * w[2];
      const float uow = src[0] * w[0] + src[1] * w[1] + src[2] * w[2];
      const float am = fmaxf(fabsf(udw), fabsf(uow));
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        acc[v] += 0.5f * (udw * own[v] + uow * src[v]) -
                  0.5f * am * (src[v] - own[v]);
      }
    }
  }

  const float sc = __ldg(a.scale + g * a.bp + lane);
#pragma unroll
  for (int r = 0; r < R; ++r) store(out_p + r * ndev + col, acc[r] * sc);
}

// ---- The staged gather body (see the header comment).

// Dynamic shared memory of the staged body for a block table of bp own and
// ep ext columns: NV f32 values per column.
__host__ __device__ constexpr int64_t staged_bytes(int64_t bp, int64_t ep) {
  return static_cast<int64_t>(kNV) * (bp + ep) * 4;
}

// The most a staged table may take: an H100 block's 227 KB of shared
// memory less the static slot-width table (ops/blocksweep.py::
// GATHER_STAGE_MAX).
constexpr int64_t kStagedMaxSmem = 227 * 1024 - kMaxSlots * 4;

// Host side of a staged launch of `kernel`: the operands allow the body (bp
// and ep multiples of 4 for the 16-byte loads, the table within
// kStagedMaxSmem: its size into *smem), and the instance's dynamic shared
// memory limit is raised once (*raised: the launching instance's flag; past
// 48 KB in all, the static table included, a launch needs it).
template <class Kernel>
inline bool staged_launch_ok(Kernel kernel, bool* raised, int64_t bp,
                             int64_t ep, int64_t* smem) {
  *smem = staged_bytes(bp, ep);
  if (bp % 4 != 0 || ep % 4 != 0 || *smem > kStagedMaxSmem) return false;
  if (!*raised) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStagedMaxSmem) != cudaSuccess) {
      return false;
    }
    *raised = true;
  }
  return true;
}

// The staged table of one entry in shared memory, column-major in two
// planes of float4: plane h holds variables 4h..4h+3 of column i at
// s[h*W + i], so a slot lane's eight sources are two 16-byte loads, and
// neighbouring columns sit in neighbouring banks.  W = bp + EP columns, own
// columns at [0, bp), ext column r at bp + r: the W-index addresses it as
// it is.
struct StagedTable {
  float4* s;
  int W;

  // Copies `quads` groups of four columns of an NV-row table (row v at
  // src + v*stride, 16-byte aligned) to columns [col0, col0 + 4*quads):
  // eight 16-byte loads along the rows per group, transposed in registers.
  __device__ __forceinline__ void stage(const float* src, int64_t stride,
                                        int quads, int col0) const {
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      float4 r[kNV];
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        r[v] = __ldg(reinterpret_cast<const float4*>(src + v * stride) + q);
      }
      float4* lo = s + col0 + 4 * q;
      float4* hi = lo + W;
      lo[0] = make_float4(r[0].x, r[1].x, r[2].x, r[3].x);
      lo[1] = make_float4(r[0].y, r[1].y, r[2].y, r[3].y);
      lo[2] = make_float4(r[0].z, r[1].z, r[2].z, r[3].z);
      lo[3] = make_float4(r[0].w, r[1].w, r[2].w, r[3].w);
      hi[0] = make_float4(r[4].x, r[5].x, r[6].x, r[7].x);
      hi[1] = make_float4(r[4].y, r[5].y, r[6].y, r[7].y);
      hi[2] = make_float4(r[4].z, r[5].z, r[6].z, r[7].z);
      hi[3] = make_float4(r[4].w, r[5].w, r[6].w, r[7].w);
    }
  }

  __device__ __forceinline__ void load(int i, float (&x)[kNV]) const {
    const float4 a = s[i];
    const float4 b = s[W + i];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

// One listed (shard, entry) g in [0, P*nb), by one CUDA block of any size:
// stage the table, then every lane of the entry, blockDim.x at a time.
// ext_cnt (P*nb) holds each entry's live ext columns (null: all EP); a live
// lane's W-index stays below bp + ext_cnt[g] (the model derives the counts
// from the W-indices).  The early return is uniform over the CUDA block.
// The per-lane arithmetic is sweep_chunk's, in its order.
template <bool kAccumulate, Op kOp, class WT, class OutT>
__device__ __forceinline__ void sweep_entry_staged(
    const SweepArgs<OutT>& a, const GatherSrc<WT>& s, const int32_t* ext_cnt,
    int64_t g) {
  constexpr int R = op_rows(kOp);
  __shared__ int s_width[kMaxSlots];
  extern __shared__ float4 s_tbl[];
  const int64_t b = g % a.nb;
  if (b > 0 && a.block_ids[g] == a.block_ids[g - 1]) return;   // pad entry
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    s_width[k] = a.slots[k];
  }
  const int64_t shard = g / a.nb;
  const int64_t ndev = a.ndev;
  const int64_t base = static_cast<int64_t>(a.block_ids[g]) * a.bp;
  const int ep = static_cast<int>(s.ep);
  const int live = ext_cnt == nullptr ? ep : min(max(ext_cnt[g], 0), ep);
  const StagedTable t{s_tbl, a.bp + ep};
  t.stage(a.var_T + shard * kNV * ndev + base, ndev, a.bp / 4, 0);
  t.stage(s.exts + g * kNV * s.ep, s.ep, (live + 3) / 4, a.bp);
  __syncthreads();

  OutT* out_p = a.out + shard * R * ndev;
  for (int lane = threadIdx.x; lane < a.bp; lane += blockDim.x) {
    const int64_t col = base + lane;
    float own[kNV];
    t.load(lane, own);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = kAccumulate ? widen(out_p[r * ndev + col]) : 0.0f;
    }
    // the live slots in slot order; slot k's successor's W-index and
    // weights are loaded before slot k is computed, so two slots' loads are
    // in flight (the init forms 14-20 % faster on an H100)
    auto fetch = [&](int kk, int& ii, float (&ww)[3]) {
      const int64_t row = g * a.K + kk;     // (shard, entry, slot)
      ii = __ldg(s.slot_idx + row * a.bp + lane);
      const WT* wp = s.slot_w + row * 3 * a.bp + lane;
#pragma unroll
      for (int d = 0; d < 3; ++d) ww[d] = ld(wp + d * a.bp);
    };
    int k = 0;
    while (k < a.K && lane >= s_width[k]) ++k;
    int i = 0;
    float w[3] = {0.0f, 0.0f, 0.0f};
    if (k < a.K) fetch(k, i, w);
    while (k < a.K) {
      int kn = k + 1;
      while (kn < a.K && lane >= s_width[kn]) ++kn;
      int i_n = 0;
      float w_n[3] = {0.0f, 0.0f, 0.0f};
      if (kn < a.K) fetch(kn, i_n, w_n);
      float src[kNV];
      t.load(i, src);
      if constexpr (kOp == Op::kGG) {
#pragma unroll
        for (int v = 0; v < kNV; ++v) {
          const float avg = 0.5f * (own[v] + src[v]);
#pragma unroll
          for (int d = 0; d < 3; ++d) acc[d * kNV + v] += w[d] * avg;
        }
      } else {
        const float udw = own[0] * w[0] + own[1] * w[1] + own[2] * w[2];
        const float uow = src[0] * w[0] + src[1] * w[1] + src[2] * w[2];
        const float am = fmaxf(fabsf(udw), fabsf(uow));
#pragma unroll
        for (int v = 0; v < kNV; ++v) {
          acc[v] += 0.5f * (udw * own[v] + uow * src[v]) -
                    0.5f * am * (src[v] - own[v]);
        }
      }
      k = kn;
      i = i_n;
#pragma unroll
      for (int d = 0; d < 3; ++d) w[d] = w_n[d];
    }
    const float sc = __ldg(a.scale + g * a.bp + lane);
#pragma unroll
    for (int r = 0; r < R; ++r) store(out_p + r * ndev + col, acc[r] * sc);
  }
}

// The zero-filled forms of the gather sweep write the columns of the
// blocks a shard's list leaves out as zeros themselves, so the wrapper
// hands an uninitialised output.  A list is strictly ascending, then pad
// repeats: listed entry g clears the blocks after its predecessor's and
// before its own, and the last listed entry (followed by nothing or by a
// repeat of itself) also those after its own.  Lanes lane, lane + step, ...
// below bp of each such block; a pad entry clears nothing.
template <int R, class OutT>
__device__ __forceinline__ void clear_gaps(const SweepArgs<OutT>& a,
                                           int64_t g, int lane, int step) {
  const int64_t b = g % a.nb;
  const int64_t cur = a.block_ids[g];
  if (b > 0 && a.block_ids[g - 1] == cur) return;               // pad entry
  const int64_t lo = b > 0 ? a.block_ids[g - 1] + 1 : 0;
  const bool last = b == a.nb - 1 || a.block_ids[g + 1] == cur;
  const int64_t hi = last ? a.ndev / a.bp : cur + 1;
  OutT* out_p = a.out + (g / a.nb) * R * a.ndev;
  for (int64_t blk = lo; blk < hi; ++blk) {
    if (blk == cur) continue;
    for (int l = lane; l < a.bp; l += step) {
      const int64_t col = blk * a.bp + l;
#pragma unroll
      for (int r = 0; r < R; ++r) store(out_p + r * a.ndev + col, 0.0f);
    }
  }
}

// Host-side checks shared by the entry points; a bad shape never launches.
inline bool sweep_args_ok(int K, int bp, int64_t grid) {
  return K >= 1 && K <= kMaxSlots && bp > 0 && grid <= 0x7fffffffLL;
}

// Runtime flags to template arguments: with_flags(b, f) calls
// f(std::integral_constant<bool, b[0]>{}, ..., <bool, b[N-1]>{}), so an
// entry point picks its kernel instance (op, init form, element types)
// from its int arguments, and every combination is instantiated once.
template <int I, int N>
struct FlagDispatch {
  template <class F, class... Cs>
  static int run(const bool (&b)[N], F& f, Cs... cs) {
    if (b[I]) {
      return FlagDispatch<I + 1, N>::run(b, f, cs..., std::true_type{});
    }
    return FlagDispatch<I + 1, N>::run(b, f, cs..., std::false_type{});
  }
};

template <int N>
struct FlagDispatch<N, N> {
  template <class F, class... Cs>
  static int run(const bool (&)[N], F& f, Cs... cs) {
    return f(cs...);
  }
};

template <int N, class F>
inline int with_flags(const bool (&b)[N], F f) {
  return FlagDispatch<0, N>::run(b, f);
}

}  // namespace cfd
