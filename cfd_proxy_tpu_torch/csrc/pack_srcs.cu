// K4: packed source table for the Green-Gauss block sweep (compact
// layout), over P shards in one launch.
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::pack_srcs (the Pallas re-pack,
// compact `wks` layout, f32) together with the take that feeds it
// (blocksweep.py::gather_exts).  The reference gathers each block's ext
// columns into a table first and then resolves every slot's W-index inside
// the kernel; here the host resolves both once (ops/plan.py::
// compact_src_cols) and the kernel is one direct gather:
//
//     out[p, b, v, j] = var_T[p, v, src_cols[p, b, j]]      j < L, v < NV
//
// Bound: memory.  Per table entry it writes NV*4 = 32 bytes (coalesced: one
// thread per (p, b, j), neighbouring threads on neighbouring j) and reads 4
// bytes of index plus NV gathered floats.  The gathered columns are the
// block's own columns and its RCB-local halo, so most reads hit L2.  No
// shared memory, no synchronisation: the simplest correct form, to be made
// fast in later work.  A pure gather, so the result equals the plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNV = 8;          // padded variable count (ops/plan.py::NV)
constexpr int kThreads = 256;

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

}  // namespace

// var_T (P, NV, ndev) f32, src_cols (P, nb, L) i32, out (P, nb, NV, L) f32;
// all contiguous on the current device.  Launches on `stream`; returns the
// launch's cudaError_t (0 = success).
extern "C" int cfd_pack_srcs(const float* var_T, int64_t ndev,
                             const int32_t* src_cols, int64_t P, int64_t nb,
                             int64_t L, float* out, cudaStream_t stream) {
  if (P == 0 || nb == 0 || L == 0) return 0;
  const int64_t chunks = (L + kThreads - 1) / kThreads;
  const int64_t grid = P * nb * chunks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pack_srcs_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      var_T, ndev, src_cols, nb, L, chunks, out);
  return static_cast<int>(cudaGetLastError());
}
