// K4: packed source table for the block sweep (compact layout), over P
// shards in one launch: f32 source values, or bf16 source deltas.
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::pack_srcs (the Pallas re-pack,
// compact `wks` layout, src_format "f32" or "bf16d") together with the take
// that feeds it (blocksweep.py::gather_exts).  The reference gathers each
// block's ext columns into a table first and then resolves every slot's
// W-index inside the kernel; here the host resolves both once (ops/plan.py::
// compact_src_cols) and the kernel is one direct gather:
//
//     f32:   out[p, b, v, j] = var_T[p, v, src_cols[p, b, j]]
//     bf16d: out[p, b, v, j] = bf16_rn(var_T[p, v, src_cols[p, b, j]]
//                                      - var_T[p, v, own])
//
// for j < L, v < NV.  bf16d is the reference's delta pack (:969-975):
// each entry's source minus the destination lane's OWN column, own =
// block_ids[p, b]*bp + lane, where lane = j - off_k for the slot k whose
// compact lanes [off_k, off_k + wks[k]) hold j (the slot table `slots`,
// (2, K) widths and offsets, as the sweep reads it).  Pad lanes resolve to a
// valid column with zero weight in the reference's plan, so their delta is
// the same finite value there and here; pad entries (the trash block
// repeated) are packed like any other entry.  The f32 subtraction and the
// round-to-nearest-even cast are the reference's, so both forms equal the
// plain PyTorch version bit for bit.
//
// Bound: memory.  Per table entry it writes NV*4 = 32 bytes (f32) or NV*2 =
// 16 bytes (bf16d) (coalesced: one thread per (p, b, j), neighbouring
// threads on neighbouring j) and reads 4 bytes of index plus NV gathered
// floats (and, bf16d, NV own floats, which neighbouring threads read from
// neighbouring columns).  The gathered columns are the block's own columns
// and its RCB-local halo, so most reads hit L2.  No synchronisation beyond
// the slot table's load into shared memory: the simplest correct form, to
// be made fast in later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNV = 8;          // padded variable count (ops/plan.py::NV)
constexpr int kThreads = 256;
constexpr int kMaxSlots = 64;   // slot-table capacity (checked by the wrapper)

__global__ void __launch_bounds__(kThreads)
pack_srcs_kernel(const float* __restrict__ var_T, int64_t ndev,
                 const int32_t* __restrict__ src_cols, int64_t nb, int64_t L,
                 int64_t chunks, float* __restrict__ out) {
  const int64_t g = blockIdx.x / chunks;     // flat (shard, block) index
  const int64_t j = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  if (j >= L) return;
  // 64-bit offsets throughout: (g*NV + v)*L + j passes 2^31 on large meshes
  const int64_t col = src_cols[g * L + j];
  const float* vp = var_T + (g / nb) * kNV * ndev;
  float* o = out + g * kNV * L + j;
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
    o[v * L] = __ldg(vp + v * ndev + col);
  }
}

__global__ void __launch_bounds__(kThreads)
pack_deltas_kernel(const float* __restrict__ var_T, int64_t ndev,
                   const int32_t* __restrict__ src_cols,
                   const int32_t* __restrict__ block_ids,
                   const int32_t* __restrict__ slots, int K, int bp,
                   int64_t nb, int64_t L, int64_t chunks,
                   __nv_bfloat16* __restrict__ out) {
  __shared__ int s_width[kMaxSlots];
  __shared__ int s_off[kMaxSlots];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_width[k] = slots[k];
    s_off[k] = slots[K + k];
  }
  __syncthreads();
  const int64_t g = blockIdx.x / chunks;     // flat (shard, block) index
  const int64_t j = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  if (j >= L) return;
  // offsets ascend, so the last live slot starting at or before j holds it
  int64_t lane = 0;
  for (int k = 0; k < K; ++k) {
    if (s_width[k] > 0 && s_off[k] <= j) lane = j - s_off[k];
  }
  const int64_t col = src_cols[g * L + j];
  const int64_t own = static_cast<int64_t>(block_ids[g]) * bp + lane;
  const float* vp = var_T + (g / nb) * kNV * ndev;
  __nv_bfloat16* o = out + g * kNV * L + j;
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
    o[v * L] = __float2bfloat16_rn(__ldg(vp + v * ndev + col) -
                                   __ldg(vp + v * ndev + own));
  }
}

}  // namespace

// var_T (P, NV, ndev) f32, src_cols (P, nb, L) i32, out (P, nb, NV, L):
// f32 when delta == 0; bf16 when delta != 0, which also reads block_ids
// (P, nb) i32 and the slot table slots (2, K) i32 (K <= 64) of block size
// bp (unread, and may be null, for f32).  All contiguous on the current
// device.  Launches on `stream`; returns the launch's cudaError_t
// (0 = success).
extern "C" int cfd_pack_srcs(const float* var_T, int64_t ndev,
                             const int32_t* src_cols, int64_t P, int64_t nb,
                             int64_t L, int delta, const int32_t* block_ids,
                             const int32_t* slots, int K, int bp, void* out,
                             cudaStream_t stream) {
  if (P == 0 || nb == 0 || L == 0) return 0;
  const int64_t chunks = (L + kThreads - 1) / kThreads;
  const int64_t grid = P * nb * chunks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(grid);
  if (!delta) {
    pack_srcs_kernel<<<g, kThreads, 0, stream>>>(
        var_T, ndev, src_cols, nb, L, chunks, static_cast<float*>(out));
  } else {
    if (K < 1 || K > kMaxSlots || bp <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pack_deltas_kernel<<<g, kThreads, 0, stream>>>(
        var_T, ndev, src_cols, block_ids, slots, K, bp, nb, L, chunks,
        static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
