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
// along the point columns, in transactions half as wide (the cluster body
// loads two lanes' bf16 weights as one 4-byte word).  The math is 24 FMAs
// per slot
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
// The gather form has four bodies, one per CUDA block shape:
//
// - sweep_chunk with GatherSrc (the DIRECT body): one CUDA block per
//   (shard, entry, 128-lane chunk); each live slot lane reads its eight
//   sources straight from global memory through the read-only cache, eight
//   scattered 4-byte loads at stride ndev (own) or EP (ext).  A warp's load
//   of one variable touches up to 32 sectors, eight times per slot: the
//   body ran at 21 % of its bound at bp 8192 (PERF.md section 6).  It needs
//   no shared memory, so it takes any bp (the rule keeps it for bp or EP
//   not a multiple of 4, and past a quarter table a block can hold).
// - sweep_entry_staged (the STAGED body): one CUDA block per listed
//   (shard, entry), which stages the entry's table [own (NV, bp) ‖ the live
//   ext columns (NV, ext_cnt)] in shared memory with 16-byte loads, once,
//   then walks the entry's bp lanes blockDim.x at a time and resolves every
//   slot lane's W-index there.  Each table column is read from device
//   memory once per entry, which is what the bound counts.  It needs
//   staged_bytes(bp, EP) of shared memory, so the wrappers take it only
//   where two such blocks fit one SM (ops/blocksweep.py::gather_body).
// - sweep_entry_cluster (the CLUSTER body): past that, where half the
//   table fits one CUDA block (at 96^3 AUTO's bp 4096, 188 KB, and bp
//   8192, 340 KB), a cluster of two CUDA blocks per listed entry, on two
//   SMs; block r stages plane r of
//   the staged layout (variables 4r..4r+3, 16 B per column) and sweeps
//   every other 64-lane run of the entry's lanes, two neighbouring lanes a
//   thread (sweep_pairs_cluster: one 8-byte W-index load, one float2 or
//   bf16x2 word per weight, scale and output row for both; the thread's
//   pairs one stream of items, fetched two items ahead across pairs),
//   reading its own plane from its shared memory and the other block's
//   through the cluster's distributed shared memory, 16 B each.  Every
//   table column, W-index and weight is still read from device memory
//   once.
// - sweep_entry_quad (the QUAD body): past that, where a quarter of the
//   table fits one CUDA block (at the two-shard 96^3 plans at bp 8192, EP
//   16768 and 10496: 195 and 146 KB a block), a cluster of four CUDA
//   blocks per listed entry; block r stages variables 2r and 2r+1 of the
//   table (8 B per column, one float2 plane).  gg is separable by
//   variable, so block r sweeps every lane of the entry for its six output
//   rows d*NV + 2r + u from its own plane alone: no distributed shared
//   memory read, and each block reads the slot stream itself (four reads
//   of it, from L2 while the cluster runs together).  flux needs
//   variables 0-2 of every column, so there block r sweeps every fourth
//   64-lane run of the entry and reads the other three planes through the
//   cluster's distributed shared memory, 8 B each.  Both stream a
//   thread's lane groups as the cluster body does (sweep_items_quad).
// All four compute the same values in the same order per lane
// (slot_update is sweep_chunk's arithmetic, and the quad body's gg update
// is its per-variable part), so they agree bit for bit.

#pragma once

#include <cooperative_groups.h>
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
// and ep multiples of 4 for the 16-byte loads, the table, or with `ctas`
// CUDA blocks sharing it each block's 1/ctas of it, within kStagedMaxSmem:
// its size into *smem), and the instance's dynamic shared memory limit is
// raised once (*raised: the launching instance's flag; past 48 KB in all,
// the static table included, a launch needs it).
template <class Kernel>
inline bool staged_launch_ok(Kernel kernel, bool* raised, int64_t bp,
                             int64_t ep, int64_t* smem, int ctas = 1) {
  *smem = staged_bytes(bp, ep) / ctas;
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

// One live slot of one lane in the staged and cluster bodies: its own
// values, the slot's eight sources and three weights into the lane's
// accumulators.  sweep_chunk's arithmetic, in its order.
template <Op kOp>
__device__ __forceinline__ void slot_update(float (&acc)[op_rows(kOp)],
                                            const float (&own)[kNV],
                                            const float (&src)[kNV],
                                            const float (&w)[3]) {
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
}

// One lane of a staged entry g (the staged body): its own values and every
// live slot's sources come from the staged table through load(i, x)
// (column i, eight variables); the W-index and weights from device memory.
template <bool kAccumulate, Op kOp, class WT, class OutT, class Load>
__device__ __forceinline__ void sweep_lane_staged(
    const SweepArgs<OutT>& a, const GatherSrc<WT>& s, const int* s_width,
    int64_t g, int64_t base, int lane, const Load& load) {
  constexpr int R = op_rows(kOp);
  OutT* out_p = a.out + (g / a.nb) * R * a.ndev;
  const int64_t col = base + lane;
  float own[kNV];
  load(lane, own);
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = kAccumulate ? widen(out_p[r * a.ndev + col]) : 0.0f;
  }
  // the live slots in slot order; slot k's successor's W-index and weights
  // are loaded before slot k is computed, so two slots' loads are in flight
  // (the init forms 14-20 % faster on an H100)
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
    load(i, src);
    slot_update<kOp>(acc, own, src, w);
    k = kn;
    i = i_n;
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = w_n[d];
  }
  const float sc = __ldg(a.scale + g * a.bp + lane);
#pragma unroll
  for (int r = 0; r < R; ++r) store(out_p + r * a.ndev + col, acc[r] * sc);
}

// One listed (shard, entry) g in [0, P*nb), by one CUDA block of any size:
// stage the table, then every lane of the entry, blockDim.x at a time.
// ext_cnt (P*nb) holds each entry's live ext columns (null: all EP); a live
// lane's W-index stays below bp + ext_cnt[g] (the model derives the counts
// from the W-indices).  The early return is uniform over the CUDA block.
template <bool kAccumulate, Op kOp, class WT, class OutT>
__device__ __forceinline__ void sweep_entry_staged(
    const SweepArgs<OutT>& a, const GatherSrc<WT>& s, const int32_t* ext_cnt,
    int64_t g) {
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

  auto load = [&](int i, float (&x)[kNV]) { t.load(i, x); };
  for (int lane = threadIdx.x; lane < a.bp; lane += blockDim.x) {
    sweep_lane_staged<kAccumulate, kOp>(a, s, s_width, g, base, lane, load);
  }
}

// ---- The cluster gather body (see the header comment).

// The CTAs of one cluster: CTA r stages plane r of the table, variables
// 4r..4r+3 (StagedTable's planes).
constexpr int kClusterCtas = 2;
// Lanes a thread sweeps at once: a pair of neighbouring lanes, whose
// W-indices, weights, scale and output are one wider word each.
constexpr int kClusterPair = 2;
// Lanes alternate between the CTAs in runs of one warp's pairs.
constexpr int kClusterRun = 32 * kClusterPair;

// Dynamic shared memory of one CTA of the cluster body: one float4 plane,
// 16 B per column, half the staged table.
__host__ __device__ constexpr int64_t cluster_bytes(int64_t bp, int64_t ep) {
  return staged_bytes(bp, ep) / kClusterCtas;
}

// The first lane of pair position j of CTA `rank`: run j / 32 of that CTA
// is run (j / 32)·kClusterCtas + rank of the entry, so the runs alternate
// between the CTAs and each sweeps half of every slot's prefix (the
// widths are multiples of 128); a warp's 32 threads take one run, a pair
// each.
__host__ __device__ constexpr int cluster_lane(int j, int rank) {
  return ((j / 32) * kClusterCtas + rank) * kClusterRun +
         (j % 32) * kClusterPair;
}

// Two neighbouring elements at p (aligned to two) widened to f32, the first
// in .x: one 8-byte load of f32, one 4-byte load of bf16 (the first element
// its low half; a bf16 widens exactly as its bits shifted into the high half
// of a float).  ld2 reads through the read-only cache; ld2_out reads the
// output (the init operand), which the same thread rewrites.
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 bf16x2_widen(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return bf16x2_widen(__ldg(reinterpret_cast<const unsigned*>(p)));
}
__device__ __forceinline__ float2 ld2_out(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2_out(const bf16* p) {
  return bf16x2_widen(*reinterpret_cast<const unsigned*>(p));
}
// Two neighbouring outputs at once, each rounded as store() rounds it.
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Items of a thread's stream fetched ahead of the one it computes: two (on
// an H100 at bp 8192 one item took 0.976-1.026x the time of two across the
// K2 instances, three 0.984-1.014x; PERF.md section 6).  With two lanes a
// thread every cluster instance fits 128 registers with no spill.
constexpr int kClusterAhead = 2;

// One item of a thread's work in the cluster body: a lane pair (its first
// lane; bp or past it: no item left) at one slot k live in that lane (K:
// the pair has no live slot, and only writes its output), with both
// W-indices and both lanes' three weights.
struct PairItem {
  int lane;
  int k;
  int2 i;
  float2 w[3];
};

// Every lane pair a thread of CTA `rank` sweeps in cluster entry g (pair
// positions threadIdx.x, + blockDim.x, ...; cluster_lane), as one stream
// of items in pair order, each pair's live slots in slot order: the
// staged lane's work for both lanes of a pair, in the same order per
// lane.  The W-indices and weights of the item kAhead items on are
// fetched while an item computes, across pair boundaries, so the slot
// stream's device-memory latency overlaps work from one pair to the next;
// a pair's scale is fetched as it starts.  Liveness stays per lane: a
// pair enters slot k where its first lane is live, and lane + 1 adds its
// terms only where it is live too (an odd width can split a pair); a dead
// lane's W-index still names a table column ([0, bp + EP)), so its reads
// stay in the table.
template <int kAhead, bool kAccumulate, Op kOp, class WT, class OutT,
          class Load>
__device__ __forceinline__ void sweep_pairs_cluster(
    const SweepArgs<OutT>& a, const GatherSrc<WT>& s, const int* s_width,
    int64_t g, int64_t base, int rank, const Load& load) {
  constexpr int R = op_rows(kOp);
  OutT* out_p = a.out + (g / a.nb) * R * a.ndev + base;
  const float* scale = a.scale + g * a.bp;
  const int K = a.K;
  const int bp = a.bp;
  const int step = static_cast<int>(blockDim.x);
  // the first slot at or after k live in `lane` (K: none)
  auto live_from = [&](int lane, int k) {
    while (k < K && lane >= s_width[k]) ++k;
    return k;
  };
  // the fetch cursor: pair position fj, slot fk of the next item
  int fj = static_cast<int>(threadIdx.x);
  int fk = live_from(cluster_lane(fj, rank), 0);
  auto fetch = [&](PairItem& f) {
    const int lane = cluster_lane(fj, rank);
    f.lane = lane;
    f.k = fk;
    if (lane >= bp) return;
    if (fk < K) {
      const int64_t row = g * K + fk;     // (shard, entry, slot)
      f.i = __ldg(reinterpret_cast<const int2*>(s.slot_idx + row * bp +
                                                lane));
      const WT* wp = s.slot_w + row * 3 * bp + lane;
#pragma unroll
      for (int d = 0; d < 3; ++d) f.w[d] = ld2(wp + d * bp);
      fk = live_from(lane, fk + 1);
      if (fk < K) return;
    }
    fj += step;                           // the pair's last item
    fk = live_from(cluster_lane(fj, rank), 0);
  };
  PairItem q[kAhead + 1];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) fetch(q[d]);
  int lane = q[0].lane;
  if (lane >= bp) return;
  float own[kClusterPair][kNV];
  float acc[kClusterPair][R];
  float2 sc;
  auto begin = [&]() {
    load(lane, own[0]);
    load(lane + 1, own[1]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 x = kAccumulate ? ld2_out(out_p + r * a.ndev + lane)
                                   : make_float2(0.0f, 0.0f);
      acc[0][r] = x.x;
      acc[1][r] = x.y;
    }
    sc = ld2(scale + lane);
  };
  begin();
  while (true) {
    fetch(q[kAhead]);
    const PairItem& c = q[0];
    if (c.k < K) {
      float src[kClusterPair][kNV];
      load(c.i.x, src[0]);
      load(c.i.y, src[1]);
      const float w0[3] = {c.w[0].x, c.w[1].x, c.w[2].x};
      slot_update<kOp>(acc[0], own[0], src[0], w0);
      if (lane + 1 < s_width[c.k]) {
        const float w1[3] = {c.w[0].y, c.w[1].y, c.w[2].y};
        slot_update<kOp>(acc[1], own[1], src[1], w1);
      }
    }
    if (q[1].lane != lane) {              // the pair's last item
#pragma unroll
      for (int r = 0; r < R; ++r) {
        store2(out_p + r * a.ndev + lane, acc[0][r] * sc.x,
               acc[1][r] * sc.y);
      }
      lane = q[1].lane;
      if (lane >= bp) break;
      begin();
    }
#pragma unroll
    for (int d = 0; d < kAhead; ++d) q[d] = q[d + 1];
  }
}

// Copies `quads` groups of four columns of the four rows at src + u*stride
// (u < 4, 16-byte aligned) into plane p at columns [col0, col0 + 4*quads):
// StagedTable::stage for one plane.
__device__ __forceinline__ void stage_plane(float4* p, const float* src,
                                            int64_t stride, int quads,
                                            int col0) {
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    float4 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      r[u] = __ldg(reinterpret_cast<const float4*>(src + u * stride) + q);
    }
    float4* d = p + col0 + 4 * q;
    d[0] = make_float4(r[0].x, r[1].x, r[2].x, r[3].x);
    d[1] = make_float4(r[0].y, r[1].y, r[2].y, r[3].y);
    d[2] = make_float4(r[0].z, r[1].z, r[2].z, r[3].z);
    d[3] = make_float4(r[0].w, r[1].w, r[2].w, r[3].w);
  }
}

// One listed (shard, entry) g by a cluster of kClusterCtas CUDA blocks:
// each stages its plane of the table (ext_cnt as in sweep_entry_staged),
// the cluster synchronises, and each sweeps its half of the lanes, a pair
// a thread, reading its own plane from its shared memory and the other
// through the cluster's distributed shared memory.  The last barrier
// keeps every plane alive until the other CTA's reads are done.  The
// early return is uniform over the cluster (both CTAs see the same
// entry).  bp is a multiple of 4, so a pair never passes it.
template <bool kAccumulate, Op kOp, class WT, class OutT>
__device__ __forceinline__ void sweep_entry_cluster(
    const SweepArgs<OutT>& a, const GatherSrc<WT>& s, const int32_t* ext_cnt,
    int64_t g) {
  __shared__ int s_width[kMaxSlots];
  extern __shared__ float4 s_plane[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = g % a.nb;
  if (b > 0 && a.block_ids[g] == a.block_ids[g - 1]) return;   // pad entry
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    s_width[k] = a.slots[k];
  }
  const int64_t ndev = a.ndev;
  const int64_t base = static_cast<int64_t>(a.block_ids[g]) * a.bp;
  const int ep = static_cast<int>(s.ep);
  const int live = ext_cnt == nullptr ? ep : min(max(ext_cnt[g], 0), ep);
  stage_plane(s_plane, a.var_T + ((g / a.nb) * kNV + 4 * rank) * ndev + base,
              ndev, a.bp / 4, 0);
  stage_plane(s_plane, s.exts + (g * kNV + 4 * rank) * s.ep, s.ep,
              (live + 3) / 4, a.bp);
  cluster.sync();                 // both planes (and s_width) written

  const float4* peer = cluster.map_shared_rank(s_plane, rank ^ 1);
  auto load = [&](int i, float (&x)[kNV]) {
    const float4 mine = s_plane[i];
    const float4 theirs = peer[i];
    const float4 lo = rank == 0 ? mine : theirs;
    const float4 hi = rank == 0 ? theirs : mine;
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  };
  sweep_pairs_cluster<kClusterAhead, kAccumulate, kOp>(a, s, s_width, g,
                                                       base, rank, load);
  cluster.sync();                 // the other CTA's reads of this plane
}

// ---- The quad gather body (see the header comment).

// The CTAs of one quad cluster: CTA r stages variables 2r and 2r+1.
constexpr int kQuadCtas = 4;
// Lanes a thread sweeps at once in the quad body: a group of neighbouring
// lanes whose W-indices, weights, scale and output rows are one wider word
// each.  gg keeps six accumulators a lane, so it takes kQuadLanesGG;
// flux, with eight accumulators and eight own values a lane, takes a pair
// as the cluster body does.
constexpr int kQuadLanesGG = 4;
constexpr int kQuadLanesFlux = 2;

// Dynamic shared memory of one CTA of the quad body: two variables, 8 B
// per column, a quarter of the staged table.
__host__ __device__ constexpr int64_t quad_bytes(int64_t bp, int64_t ep) {
  return staged_bytes(bp, ep) / kQuadCtas;
}

// L neighbouring elements at p (aligned to L) widened to f32: one load of
// L*4 bytes (f32) or L*2 bytes (bf16), through the read-only cache (ldn),
// or of the output, which the same thread rewrites (ldn_out); stn stores
// L outputs at once, each rounded as store() rounds it.
__device__ __forceinline__ void ldn(const int32_t* p, int (&x)[2]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void ldn(const int32_t* p, int (&x)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ldn(const float* p, float (&x)[2]) {
  const float2 v = ld2(p);
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void ldn(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ldn(const bf16* p, float (&x)[2]) {
  const float2 v = ld2(p);
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void ldn(const bf16* p, float (&x)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = bf16x2_widen(u.x);
  const float2 b = bf16x2_widen(u.y);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void ldn_out(const float* p, float (&x)[2]) {
  const float2 v = ld2_out(p);
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void ldn_out(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ldn_out(const bf16* p, float (&x)[2]) {
  const float2 v = ld2_out(p);
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void ldn_out(const bf16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = bf16x2_widen(u.x);
  const float2 b = bf16x2_widen(u.y);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void stn(float* p, const float (&x)[2]) {
  store2(p, x[0], x[1]);
}
__device__ __forceinline__ void stn(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void stn(bf16* p, const float (&x)[2]) {
  store2(p, x[0], x[1]);
}
__device__ __forceinline__ void stn(bf16* p, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a),
                 *reinterpret_cast<const unsigned*>(&b));
}

// gg in the quad body, split by variables: CTA `rank` sweeps every lane of
// the entry (lane group j is lanes L*j ..), two values a column from its
// own plane, six output rows (local row d*2 + u is row d*NV + 2*rank + u).
// update is slot_update's gg arithmetic for variables 2*rank + u, in its
// order per accumulator.
template <int L>
struct QuadGG {
  static constexpr Op kOp = Op::kGG;
  static constexpr int kV = 2;
  static constexpr int kR = 6;
  const float2* plane;
  int rank;

  __device__ __forceinline__ int lane(int j) const { return L * j; }
  __device__ __forceinline__ int row(int r) const {
    return (r / 2) * kNV + 2 * rank + r % 2;
  }
  __device__ __forceinline__ void load(int i, float (&x)[kV]) const {
    const float2 f = plane[i];
    x[0] = f.x; x[1] = f.y;
  }
  __device__ __forceinline__ void update(float (&acc)[kR],
                                         const float (&own)[kV],
                                         const float (&src)[kV],
                                         const float (&w)[3]) const {
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const float avg = 0.5f * (own[u] + src[u]);
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[d * kV + u] += w[d] * avg;
    }
  }
};

// flux in the quad body, split by lanes: CTA `rank` sweeps run
// (j / 32)·kQuadCtas + rank of the entry's runs of 32·L lanes, so the runs
// go round the four CTAs and each sweeps a quarter of every slot's prefix
// (widths are multiples of 128); a column's eight values are the four
// planes' pairs, its own plane local, the other three through the
// cluster's distributed shared memory; the eight rows and slot_update as
// the other bodies.
template <int L>
struct QuadFlux {
  static constexpr Op kOp = Op::kFlux;
  static constexpr int kV = kNV;
  static constexpr int kR = kNV;
  const float2* planes[kQuadCtas];
  int rank;

  __device__ __forceinline__ int lane(int j) const {
    return ((j / 32) * kQuadCtas + rank) * (32 * L) + (j % 32) * L;
  }
  __device__ __forceinline__ int row(int r) const { return r; }
  __device__ __forceinline__ void load(int i, float (&x)[kV]) const {
#pragma unroll
    for (int q = 0; q < kQuadCtas; ++q) {
      const float2 f = planes[q][i];
      x[2 * q] = f.x;
      x[2 * q + 1] = f.y;
    }
  }
  __device__ __forceinline__ void update(float (&acc)[kR],
                                         const float (&own)[kV],
                                         const float (&src)[kV],
                                         const float (&w)[3]) const {
    slot_update<Op::kFlux>(acc, own, src, w);
  }
};

// One item of a thread's work in the quad body: a group of L lanes (its
// first lane; bp or past it: no item left) at one slot k live in that lane
// (K: the group has no live slot, and only writes its output), with the L
// W-indices and the L lanes' three weights.
template <int L>
struct LaneItem {
  int lane;
  int k;
  int i[L];
  float w[3][L];
};

// Every lane group a thread of a quad CTA sweeps in entry g (group
// positions threadIdx.x, + blockDim.x, ...; part.lane), as one stream of
// items in group order, each group's live slots in slot order: the
// cluster body's stream (sweep_pairs_cluster) for groups of L lanes and
// the rows and values of `part`.  Liveness stays per lane: a group enters
// slot k where its first lane is live, and lane + u adds its terms only
// where it is live too; a dead lane's W-index still names a table column
// ([0, bp + EP)), so its reads stay in the table.
template <int L, int kAhead, bool kAccumulate, class Part, class WT,
          class OutT>
__device__ __forceinline__ void sweep_items_quad(
    const SweepArgs<OutT>& a, const GatherSrc<WT>& s, const int* s_width,
    int64_t g, int64_t base, const Part& part) {
  constexpr int R = Part::kR;
  constexpr int V = Part::kV;
  OutT* out_p = a.out + (g / a.nb) * op_rows(Part::kOp) * a.ndev + base;
  const float* scale = a.scale + g * a.bp;
  const int K = a.K;
  const int bp = a.bp;
  const int step = static_cast<int>(blockDim.x);
  // the first slot at or after k live in `lane` (K: none)
  auto live_from = [&](int lane, int k) {
    while (k < K && lane >= s_width[k]) ++k;
    return k;
  };
  // the fetch cursor: group position fj, slot fk of the next item
  int fj = static_cast<int>(threadIdx.x);
  int fk = live_from(part.lane(fj), 0);
  auto fetch = [&](LaneItem<L>& f) {
    const int lane = part.lane(fj);
    f.lane = lane;
    f.k = fk;
    if (lane >= bp) return;
    if (fk < K) {
      const int64_t row = g * K + fk;     // (shard, entry, slot)
      ldn(s.slot_idx + row * bp + lane, f.i);
      const WT* wp = s.slot_w + row * 3 * bp + lane;
#pragma unroll
      for (int d = 0; d < 3; ++d) ldn(wp + d * bp, f.w[d]);
      fk = live_from(lane, fk + 1);
      if (fk < K) return;
    }
    fj += step;                           // the group's last item
    fk = live_from(part.lane(fj), 0);
  };
  LaneItem<L> q[kAhead + 1];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) fetch(q[d]);
  int lane = q[0].lane;
  if (lane >= bp) return;
  float own[L][V];
  float acc[L][R];
  float sc[L];
  auto begin = [&]() {
#pragma unroll
    for (int u = 0; u < L; ++u) part.load(lane + u, own[u]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[L];
      if constexpr (kAccumulate) {
        ldn_out(out_p + part.row(r) * a.ndev + lane, x);
      } else {
#pragma unroll
        for (int u = 0; u < L; ++u) x[u] = 0.0f;
      }
#pragma unroll
      for (int u = 0; u < L; ++u) acc[u][r] = x[u];
    }
    ldn(scale + lane, sc);
  };
  begin();
  while (true) {
    fetch(q[kAhead]);
    const LaneItem<L>& c = q[0];
    if (c.k < K) {
      float src[L][V];
#pragma unroll
      for (int u = 0; u < L; ++u) part.load(c.i[u], src[u]);
#pragma unroll
      for (int u = 0; u < L; ++u) {
        if (u == 0 || lane + u < s_width[c.k]) {
          const float w[3] = {c.w[0][u], c.w[1][u], c.w[2][u]};
          part.update(acc[u], own[u], src[u], w);
        }
      }
    }
    if (q[1].lane != lane) {              // the group's last item
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x[L];
#pragma unroll
        for (int u = 0; u < L; ++u) x[u] = acc[u][r] * sc[u];
        stn(out_p + part.row(r) * a.ndev + lane, x);
      }
      lane = q[1].lane;
      if (lane >= bp) break;
      begin();
    }
#pragma unroll
    for (int d = 0; d < kAhead; ++d) q[d] = q[d + 1];
  }
}

// Copies `quads` groups of four columns of the two rows at src and
// src + stride (16-byte aligned) into the float2 plane p at columns
// [col0, col0 + 4*quads): two 16-byte loads along the rows and two
// 16-byte stores per group.
__device__ __forceinline__ void stage_pair_plane(float2* p, const float* src,
                                                 int64_t stride, int quads,
                                                 int col0) {
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const float4 r0 = __ldg(reinterpret_cast<const float4*>(src) + q);
    const float4 r1 = __ldg(reinterpret_cast<const float4*>(src + stride) +
                            q);
    float4* d = reinterpret_cast<float4*>(p + col0 + 4 * q);
    d[0] = make_float4(r0.x, r1.x, r0.y, r1.y);
    d[1] = make_float4(r0.z, r1.z, r0.w, r1.w);
  }
}

// One listed (shard, entry) g by a cluster of kQuadCtas CUDA blocks: each
// stages its two variables of the table (ext_cnt as in
// sweep_entry_staged).  gg: the block synchronises with itself alone and
// sweeps its six rows over every lane.  flux: the cluster synchronises,
// each block sweeps its quarter of the lanes through all four planes, and
// the last barrier keeps every plane alive until the other blocks' reads
// are done.  The early return is uniform over the cluster (its blocks see
// the same entry).  bp is a multiple of 4, so a lane group never passes
// it.
template <bool kAccumulate, Op kOp, class WT, class OutT>
__device__ __forceinline__ void sweep_entry_quad(
    const SweepArgs<OutT>& a, const GatherSrc<WT>& s, const int32_t* ext_cnt,
    int64_t g) {
  __shared__ int s_width[kMaxSlots];
  extern __shared__ float4 s_quad[];
  float2* plane = reinterpret_cast<float2*>(s_quad);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = g % a.nb;
  if (b > 0 && a.block_ids[g] == a.block_ids[g - 1]) return;   // pad entry
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    s_width[k] = a.slots[k];
  }
  const int64_t ndev = a.ndev;
  const int64_t base = static_cast<int64_t>(a.block_ids[g]) * a.bp;
  const int ep = static_cast<int>(s.ep);
  const int live = ext_cnt == nullptr ? ep : min(max(ext_cnt[g], 0), ep);
  stage_pair_plane(plane,
                   a.var_T + ((g / a.nb) * kNV + 2 * rank) * ndev + base,
                   ndev, a.bp / 4, 0);
  stage_pair_plane(plane, s.exts + (g * kNV + 2 * rank) * s.ep, s.ep,
                   (live + 3) / 4, a.bp);
  if constexpr (kOp == Op::kGG) {
    __syncthreads();              // this block's plane (and s_width)
    sweep_items_quad<kQuadLanesGG, kClusterAhead, kAccumulate>(
        a, s, s_width, g, base, QuadGG<kQuadLanesGG>{plane, rank});
  } else {
    cluster.sync();               // every plane (and s_width) written
    QuadFlux<kQuadLanesFlux> part;
    part.rank = rank;
#pragma unroll
    for (int r = 0; r < kQuadCtas; ++r) {
      part.planes[r] = r == rank ? plane : cluster.map_shared_rank(plane, r);
    }
    sweep_items_quad<kQuadLanesFlux, kClusterAhead, kAccumulate>(
        a, s, s_width, g, base, part);
    cluster.sync();               // the other blocks' reads of this plane
  }
}

// The gather bodies as the entry points take them
// (ops/blocksweep.py::GATHER_BODY_CODES).
enum Body { kDirect = 0, kStaged = 1, kCluster = 2, kQuad = 3 };

// The cluster and quad bodies' CUDA blocks: a multiple of 32 threads, at
// most this many (the launches take blocksweep.cluster_threads and
// quad_threads), one or two blocks per SM.
constexpr int kClusterMaxThreads = 512;

inline bool cluster_threads_ok(int threads) {
  return threads >= 32 && threads <= kClusterMaxThreads && threads % 32 == 0;
}

// The launch configuration of `clusters` clusters of `ctas` CUDA blocks
// (kClusterCtas, or kQuadCtas; cfg.attrs points at *attr).
inline cudaLaunchConfig_t cluster_config(int64_t clusters, int threads,
                                         int64_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr,
                                         int ctas = kClusterCtas) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(ctas);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `ctas` blocks of `kernel` that can be resident at once on
// this card at `threads` threads and `smem` dynamic bytes a block, into *n.
template <class Kernel>
cudaError_t resident_clusters(Kernel kernel, int threads, int64_t smem,
                              int* n, int ctas = kClusterCtas) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(1, threads, smem, 0, &attr, ctas);
  return cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(kernel), &cfg);
}

// The residency a cluster launch of one instance last checked.
struct Residency {
  int64_t smem = -1;
  int threads = 0;
};

// cudaSuccess where at least one cluster of `kernel` can be resident at
// `threads` and `smem` (asked of the runtime once per distinct pair: *r is
// the launching instance's), cudaErrorInvalidConfiguration where none can:
// such a launch would fail, and nothing falls back to another body.
template <class Kernel>
cudaError_t cluster_fits(Kernel kernel, int threads, int64_t smem,
                         Residency* r, int ctas = kClusterCtas) {
  if (smem == r->smem && threads == r->threads) return cudaSuccess;
  int n = 0;
  const cudaError_t e = resident_clusters(kernel, threads, smem, &n, ctas);
  if (e != cudaSuccess) return e;
  if (n < 1) return cudaErrorInvalidConfiguration;
  r->smem = smem;
  r->threads = threads;
  return cudaSuccess;
}

// One cluster launch of `kernel` in clusters of kCtas blocks (the cluster
// body's two, or the quad body's four): `region` leading blocks (K3's push
// region, padded to whole clusters; 0 for K2), then a cluster per entry,
// after its checks: the shared memory of one 1/kCtas share of the table a
// block (its limit raised once per instance, *raised) and at least one
// resident cluster (*resident).  `args` follow the kernel's signature.
// Returns the cudaError_t.
template <int kCtas = kClusterCtas, class Kernel, class... Args>
int launch_cluster(Kernel kernel, bool* raised, Residency* resident,
                   int bp, int64_t ep, int64_t region, int64_t entries,
                   int threads, cudaStream_t stream, Args... args) {
  int64_t smem = 0;
  const int64_t grid = region + kCtas * entries;
  if (!cluster_threads_ok(threads) || region % kCtas != 0 ||
      grid > 0x7fffffffLL ||
      !staged_launch_ok(kernel, raised, bp, ep, &smem, kCtas)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cluster_fits(kernel, threads, smem, resident, kCtas);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(grid / kCtas, threads, smem, stream, &attr, kCtas);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
