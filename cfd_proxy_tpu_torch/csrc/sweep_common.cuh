// Per-thread body of the packed compact Green-Gauss sweep, shared by K1
// (sweep_packed.cu) and K3 (sweep_overlap.cu).
//
// Replaces the body of cfd_proxy_tpu/ops/blocksweep.py::
// _block_compute_packed (op "gg", f32, `wks` compact layout), with and
// without its `accumulate` operand.  For point column `col` of listed
// block b of shard p (lane l = col - block_ids[p, b]*bp):
//
//     acc[d*NV+v] = (accumulate ? out[p, d*NV+v, col] : 0)
//                   + Σ_k [l < wks[k]] w_k[d, l] * 0.5f*(own[v, l] + src_k[v, l])
//     out[p, d*NV+v, col] = scale[p, b, l] * acc[d*NV+v]
//
// where slot k's weights and sources sit at lane offset off_k of the
// compact (P, nb, 3, L) / (P, nb, NV, L) tables.  The Pallas kernel walks
// one block per grid step with the slot loop unrolled over static widths;
// here every (shard, block) entry of the plan runs in parallel, one thread
// per point column, and the slot loop reads (width, offset) pairs from a
// small table.  With `accumulate` the output is also the `init` operand
// (the reference aliases the two): each thread reads its own 24 values and
// writes them back, so no column is touched by two threads.
//
// Pad entries.  Shards share one block-list length; a shorter list is
// padded with entries that all name the shard's trailing TRASH block
// (models/gradients_pallas.py::_pad_blocks).  Run at once, those entries
// would read and write the same columns concurrently.  Real block lists
// are strictly ascending, so a pad entry is exactly an entry equal to its
// predecessor: it is skipped, and the first entry naming the trash block
// computes it once, as the reference's sequential grid leaves it.
//
// Bound: memory.  Per point it streams own 32 B, scale 4 B, out 96 B (and
// init 96 B when accumulating) and, per live slot, 32 B of sources + 12 B
// of weights; the math is 24 FMAs per slot.  Design: 24 f32 accumulators
// and the 8 own values stay in registers for the whole slot loop, so
// nothing but the streams touches memory; every load and store is
// coalesced along the point columns.  Slot widths are per-slot and need
// not be monotone (a slot of zero-normal faces can be narrower than a later
// one), so every slot is tested and none ends the loop; zero-width slots
// have no table entries and no offset of their own.  The operation order is
// the reference body's; nvcc's default FMA contraction moves results by a
// few ulp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cfd {

constexpr int kNV = 8;            // padded variable count (ops/plan.py::NV)
constexpr int kRows = 3 * kNV;    // output rows d*NV+v
constexpr int kMaxSlots = 64;     // slot-table capacity (checked by the wrapper)
constexpr int kThreads = 128;

struct SweepArgs {
  const float* var_T;       // (P, NV, ndev)
  int64_t ndev;
  const float* srcs;        // (P, nb, NV, L)
  const float* slot_w;      // (P, nb, 3, L)
  const float* scale;       // (P, nb, bp)
  const int32_t* block_ids; // (P, nb)
  const int32_t* slots;     // (2, K) width, offset
  int K;
  int64_t nb;
  int64_t L;
  int bp;
  int64_t chunks;           // kThreads-column chunks per block
  float* out;               // (P, 3*NV, ndev); also init when accumulating
};

// Grid blocks a sweep needs: one per (shard, entry, chunk).
inline int64_t sweep_grid(int64_t P, int64_t nb, int bp, int64_t* chunks) {
  *chunks = (bp + kThreads - 1) / kThreads;
  return P * nb * (*chunks);
}

// One kThreads-column chunk of one (shard, entry); `blk` in
// [0, P*nb*chunks).  The early returns are uniform over the CUDA block up
// to the barrier.
template <bool kAccumulate>
__device__ __forceinline__ void sweep_chunk(const SweepArgs& a, int64_t blk) {
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
  const int64_t col = static_cast<int64_t>(a.block_ids[g]) * a.bp + lane;
  const float* own_p = a.var_T + shard * kNV * ndev;
  float* out_p = a.out + shard * kRows * ndev;

  float own[kNV];
#pragma unroll
  for (int v = 0; v < kNV; ++v) own[v] = __ldg(own_p + v * ndev + col);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r] = kAccumulate ? out_p[r * ndev + col] : 0.0f;
  }

  const float* sb = a.srcs + g * kNV * a.L;
  const float* wb = a.slot_w + g * 3 * a.L;
  for (int k = 0; k < a.K; ++k) {
    if (lane >= s_width[k]) continue;       // outside slot k's prefix
    const int64_t j = static_cast<int64_t>(s_off[k]) + lane;
    float w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = __ldg(wb + d * a.L + j);
#pragma unroll
    for (int v = 0; v < kNV; ++v) {
      const float avg = 0.5f * (own[v] + __ldg(sb + v * a.L + j));
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[d * kNV + v] += w[d] * avg;
    }
  }

  const float s = __ldg(a.scale + g * a.bp + lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r) out_p[r * ndev + col] = acc[r] * s;
}

// Host-side checks shared by the entry points; a bad shape never launches.
inline bool sweep_args_ok(int K, int bp, int64_t grid) {
  return K >= 1 && K <= kMaxSlots && bp > 0 && grid <= 0x7fffffffLL;
}

}  // namespace cfd
