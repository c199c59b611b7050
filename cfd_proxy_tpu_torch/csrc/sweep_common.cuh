// Per-thread body of the block sweep, shared by K1 (sweep_packed.cu), K2
// (sweep_gather.cu) and both forms of K3 (sweep_overlap.cu), for both ops.
//
// Replaces the bodies of cfd_proxy_tpu/ops/blocksweep.py::
// _block_compute_packed (K1, the packed formulation) and _block_compute
// (K2, the gather formulation), ops "gg" and "flux", f32, with and without
// their `accumulate` operand.  For point column `col` of listed block b of
// shard p (lane l = col - block_ids[p, b]*bp), over the live slots k
// (l < wks[k]) with source src_k and weights w_k (3):
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
//   is one indexed load per variable.  Pad slots hold W-index 0 and zero
//   weight: they read own column 0 and add nothing (under flux too: with
//   w = 0, udw = uow = a = 0).
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
// W-index and 32 B of gathered values that mostly hit L1/L2 (the block's
// own columns and its RCB-local ext table).  The math is 24 FMAs per slot
// (gg) or ~6 + 4*8 operations (flux).  Design: the accumulators (24 gg, 8
// flux) and the 8 own values stay in registers for the whole slot loop, so
// nothing but the streams touches memory; every stream is coalesced along
// the point columns.  The gather form reads the block table straight from
// global memory through the read-only cache rather than staging it in
// shared memory: a 128-thread CUDA block covers one 128-lane chunk of a
// block, so staging the whole NV x (bp + EP) table per CUDA block would
// read it bp/128 times over, and it needs no size limit at any bp.  Slot
// widths are per-slot and need not be monotone (a slot of zero-normal faces
// can be narrower than a later one), so every slot is tested and none ends
// the loop; zero-width slots have no table entries and no offset of their
// own.  The operation order is the reference body's; nvcc's default FMA
// contraction moves results by a few ulp (under flux it can also move
// max(|udw|, |uow|) to the other branch near a tie, where the two are
// within those few ulp of each other, so the result stays continuous).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cfd {

constexpr int kNV = 8;            // padded variable count (ops/plan.py::NV)
constexpr int kRows = 3 * kNV;    // gg output rows d*NV+v
constexpr int kMaxSlots = 64;     // slot-table capacity (checked by the wrapper)
constexpr int kThreads = 128;

// Operands both formulations share.
struct SweepArgs {
  const float* var_T;       // (P, NV, ndev)
  int64_t ndev;
  const float* scale;       // (P, nb, bp)
  const int32_t* block_ids; // (P, nb)
  const int32_t* slots;     // (2, K) width, offset
  int K;
  int64_t nb;
  int bp;
  int64_t chunks;           // kThreads-column chunks per block
  float* out;               // (P, rows, ndev); also init when accumulating
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
struct SlotPtrs {
  const float* src;
  int64_t src_stride;
  const float* w;
  int64_t w_stride;
};

// K1: the packed compact source table.
struct PackedSrc {
  const float* srcs;        // (P, nb, NV, L)
  const float* slot_w;      // (P, nb, 3, L)
  int64_t L;

  __device__ __forceinline__ SlotPtrs slot(const SweepArgs&, int64_t g,
                                           int /*k*/, int off, int lane,
                                           const float* /*own_blk*/) const {
    const int64_t j = static_cast<int64_t>(off) + lane;
    return {srcs + g * kNV * L + j, L, slot_w + g * 3 * L + j, L};
  }
};

// K2: gather from [own ‖ exts] by the W-index.
struct GatherSrc {
  const float* exts;        // (P, nb, NV, EP)
  const int32_t* slot_idx;  // (P, nb, K, bp) W-index in [0, bp + EP)
  const float* slot_w;      // (P, nb, K, 3, bp)
  int64_t ep;

  __device__ __forceinline__ SlotPtrs slot(const SweepArgs& a, int64_t g,
                                           int k, int /*off*/, int lane,
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
template <bool kAccumulate, Op kOp, class Src>
__device__ __forceinline__ void sweep_chunk(const SweepArgs& a, const Src& s,
                                            int64_t blk) {
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
  const float* own_p = a.var_T + shard * kNV * ndev;
  float* out_p = a.out + shard * R * ndev;

  float own[kNV];
#pragma unroll
  for (int v = 0; v < kNV; ++v) own[v] = __ldg(own_p + v * ndev + col);

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = kAccumulate ? out_p[r * ndev + col] : 0.0f;
  }

  for (int k = 0; k < a.K; ++k) {
    if (lane >= s_width[k]) continue;       // outside slot k's prefix
    const SlotPtrs p = s.slot(a, g, k, s_off[k], lane, own_p + base);
    float w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = __ldg(p.w + d * p.w_stride);
    if constexpr (kOp == Op::kGG) {
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const float avg = 0.5f * (own[v] + __ldg(p.src + v * p.src_stride));
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d * kNV + v] += w[d] * avg;
      }
    } else {
      float src[kNV];
#pragma unroll
      for (int v = 0; v < kNV; ++v) src[v] = __ldg(p.src + v * p.src_stride);
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
  for (int r = 0; r < R; ++r) out_p[r * ndev + col] = acc[r] * sc;
}

// Host-side checks shared by the entry points; a bad shape never launches.
inline bool sweep_args_ok(int K, int bp, int64_t grid) {
  return K >= 1 && K <= kMaxSlots && bp > 0 && grid <= 0x7fffffffLL;
}

}  // namespace cfd
