// The chained step's state update, over P shards in one launch:
//
//   out[p, v, c] = var[p, v, c] + round_G(coupling * g[p, v, c]),  v < NV
//
// var and out (P, NV, ndev) f32; g (P, g_rows, ndev), the step's output in
// the grad dtype G (f32 or bf16), whose first NV rows the update reads
// (g_rows: 3*NV gradient rows, NV flux rows).
//
// Replaces no pallas_call: the reference writes `v + 1e-30 * g[:, :NV, :]`
// inside jax.jit + lax.fori_loop (cfd_proxy_tpu/models/gradients_pallas.py
// :1102 and :1166), and XLA fuses the product and the sum into one pass over
// the state.  Run as two torch operations, the update read and wrote the
// product as a tensor of its own between them (two kernels, about 140 MB at
// the one-shard 96^3 plan); this kernel is that fusion, by hand.
//
// The types are the torch update's, bit for bit: the product in f32 (the
// coupling rounded to f32 first, as torch takes a Python scalar), rounded
// to G (to nearest even for bf16), then the sum in f32.  __fmul_rn and
// __fadd_rn keep nvcc from contracting the pair into one FMA, which would
// round once and change the bits.
//
// Bound: bytes, each input read once and the output written once: var and
// out 4 B an element, g 4 or 2; at the one-shard 96^3 plan 85 MB (f32 g),
// 0.0255 ms at 3.35 TB/s.  Two operations an element, nothing for the
// arithmetic units.  The design: four neighbouring columns a thread, one
// 16-byte load of var and of out's store, a 16- (f32) or 8-byte (bf16) load
// of g; a CUDA block row of the grid per state row (P * NV), each grid-
// strided along its row's column quads, so no index is divided; a plain
// kernel of one column a thread where ndev or an operand is not aligned to
// four elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNV = 8;            // the state's rows (ops/plan.py::NV)
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // an H100's SMs, 16 blocks each

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float term(float c, float g) {
  return __fmul_rn(c, g);
}
__device__ __forceinline__ float term(float c, bf16 g) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(c,
                                                        __bfloat162float(g))));
}

// Four G values from 16 (f32) or 8 (bf16) aligned bytes.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, bf16 (&x)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}

// Row blockIdx.y of out (shard * NV + v): its column quads, grid-stride
// along x (no division on the path: the row is the block's).
template <class G>
__global__ void __launch_bounds__(kThreads)
chain_update_kernel(const float* var, const G* g, int64_t g_rows,
                    int64_t ndev, float c, float* out) {
  const int64_t row = blockIdx.y, p = row / kNV;
  const float* vr = var + row * ndev;
  const G* gr = g + (p * g_rows + (row - p * kNV)) * ndev;
  float* orow = out + row * ndev;
  for (int64_t col = (blockIdx.x * static_cast<int64_t>(kThreads) +
                      threadIdx.x) * 4;
       col < ndev; col += static_cast<int64_t>(gridDim.x) * kThreads * 4) {
    const float4 v = *reinterpret_cast<const float4*>(vr + col);
    G x[4];
    load4(gr + col, x);
    float4 o;
    o.x = __fadd_rn(v.x, term(c, x[0]));
    o.y = __fadd_rn(v.y, term(c, x[1]));
    o.z = __fadd_rn(v.z, term(c, x[2]));
    o.w = __fadd_rn(v.w, term(c, x[3]));
    *reinterpret_cast<float4*>(orow + col) = o;
  }
}

// The same, one column a thread (any ndev, any alignment).
template <class G>
__global__ void __launch_bounds__(kThreads)
chain_update_scalar_kernel(const float* var, const G* g, int64_t g_rows,
                           int64_t ndev, float c, float* out) {
  const int64_t row = blockIdx.y, p = row / kNV;
  const G* gr = g + (p * g_rows + (row - p * kNV)) * ndev;
  for (int64_t col = blockIdx.x * static_cast<int64_t>(kThreads) +
                     threadIdx.x;
       col < ndev; col += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[row * ndev + col] =
        __fadd_rn(var[row * ndev + col], term(c, gr[col]));
  }
}

template <class G>
int launch_update(const float* var, const void* g, int64_t g_rows, int64_t P,
                  int64_t ndev, float c, float* out, cudaStream_t stream) {
  const int64_t rows = P * kNV;
  if (rows == 0 || ndev == 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const G* gp = static_cast<const G*>(g);
  const bool vec = ndev % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(var) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gp) % (4 * sizeof(G)) == 0;
  // blocks along a row: enough for its columns (quads), at most about
  // kMaxBlocks over the launch
  const int64_t items = vec ? ndev / 4 : ndev;
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = kMaxBlocks / rows > 0 ? kMaxBlocks / rows : 1;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>(rows));
  if (vec) {
    chain_update_kernel<G><<<grid, kThreads, 0, stream>>>(var, gp, g_rows,
                                                          ndev, c, out);
  } else {
    chain_update_scalar_kernel<G><<<grid, kThreads, 0, stream>>>(
        var, gp, g_rows, ndev, c, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// var, out (P, NV, ndev) f32, contiguous, out not var; g (P, g_rows, ndev)
// contiguous, bf16 where g_bf16 != 0, else f32, g_rows >= NV; c the
// coupling, already f32.  Launches on `stream`; returns the launch's
// cudaError_t (0 = success).
extern "C" int cfd_chain_update(const float* var, const void* g, int g_bf16,
                                int64_t g_rows, int64_t P, int64_t ndev,
                                float c, float* out, cudaStream_t stream) {
  if (g_rows < kNV || P < 0 || ndev < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return g_bf16 ? launch_update<bf16>(var, g, g_rows, P, ndev, c, out, stream)
                : launch_update<float>(var, g, g_rows, P, ndev, c, out,
                                       stream);
}
