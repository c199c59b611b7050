// Green-Gauss block sweep, PACKED formulation, COMPACT prefix layout, f32.
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::sweep_blocks, packed branch
// with `wks` (body _block_compute_packed), op "gg", no `init`.  For point
// column `col` of block b (lane p = col - block_ids[b]*bp):
//
//     out[d*NV+v, col] = scale[b, p] *
//         Σ_k [p < wks[k]] w_k[d, p] * 0.5f*(own[v, p] + src_k[v, p])
//
// where slot k's weights and sources sit at lane offset off_k in the
// compact (nb, 3, L) / (nb, NV, L) tables.  The Pallas kernel walks one
// block per grid step with the slot loop unrolled over static widths; here
// every block of the plan runs in parallel, one thread per point column,
// and the slot loop reads (width, offset) pairs from a small table.
//
// Bound: memory.  Per point it streams own 32 B, scale 4 B, out 96 B and,
// per live slot, 32 B of sources + 12 B of weights (44 B * L/bp in all);
// the math is 24 FMAs per slot.  Design: 24 f32 accumulators and the 8 own
// values stay in registers for the whole slot loop, so nothing but the
// streams touches memory; every load and store is coalesced along the
// point columns.  Slot widths are per-slot and need not be monotone (a slot
// of zero-normal faces can be narrower than a later one), so every slot is
// tested and none ends the loop; zero-width slots have no table entries and
// no offset of their own.  The same operation order as the reference body;
// nvcc's default FMA contraction moves results by a few ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNV = 8;            // padded variable count (ops/plan.py::NV)
constexpr int kRows = 3 * kNV;    // output rows d*NV+v
constexpr int kMaxSlots = 64;     // slot-table capacity (checked by the wrapper)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
sweep_packed_kernel(const float* __restrict__ var_T, int64_t ndev,
                    const float* __restrict__ srcs,      // (nb, NV, L)
                    const float* __restrict__ slot_w,    // (nb, 3, L)
                    const float* __restrict__ scale,     // (nb, bp)
                    const int32_t* __restrict__ block_ids,  // (nb,)
                    const int32_t* __restrict__ slots,   // (2, K) width, offset
                    int K, int64_t L, int bp, int64_t chunks,
                    float* __restrict__ out) {           // (3*NV, ndev)
  __shared__ int s_width[kMaxSlots];
  __shared__ int s_off[kMaxSlots];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_width[k] = slots[k];
    s_off[k] = slots[K + k];
  }
  __syncthreads();

  const int64_t b = blockIdx.x / chunks;
  const int lane = static_cast<int>((blockIdx.x % chunks) * kThreads) +
                   static_cast<int>(threadIdx.x);
  if (lane >= bp) return;
  const int64_t col = static_cast<int64_t>(block_ids[b]) * bp + lane;

  float own[kNV];
#pragma unroll
  for (int v = 0; v < kNV; ++v) own[v] = __ldg(var_T + v * ndev + col);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  const float* sb = srcs + b * kNV * L;
  const float* wb = slot_w + b * 3 * L;
  for (int k = 0; k < K; ++k) {
    if (lane >= s_width[k]) continue;       // outside slot k's prefix
    const int64_t j = static_cast<int64_t>(s_off[k]) + lane;
    float w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = __ldg(wb + d * L + j);
#pragma unroll
    for (int v = 0; v < kNV; ++v) {
      const float avg = 0.5f * (own[v] + __ldg(sb + v * L + j));
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[d * kNV + v] += w[d] * avg;
    }
  }

  const float s = __ldg(scale + b * bp + lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r * ndev + col] = acc[r] * s;
}

}  // namespace

// All pointers contiguous on the current device; shapes as annotated in the
// kernel.  K <= 64.  Launches on `stream`; returns the launch's cudaError_t
// (0 = success).
extern "C" int cfd_sweep_packed(const float* var_T, int64_t ndev,
                                const float* srcs, const float* slot_w,
                                const float* scale, const int32_t* block_ids,
                                const int32_t* slots, int K, int64_t nb,
                                int64_t L, int bp, float* out,
                                cudaStream_t stream) {
  if (nb == 0) return 0;
  if (K < 0 || K > kMaxSlots || bp <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunks = (bp + kThreads - 1) / kThreads;
  const int64_t grid = nb * chunks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sweep_packed_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      var_T, ndev, srcs, slot_w, scale, block_ids, slots, K, L, bp, chunks,
      out);
  return static_cast<int>(cudaGetLastError());
}
