// The halo exchange's send buffers, every shard and phase in one launch:
//
//   buf[p, k, r, j] = round_W(widen(x[p, r, idx[p, k, j]]) * scale[p, k, j])
//
// x (P, rows, ndev) in the source type X (f32 or bf16): the gradients (3*NV
// or NV rows) or the state (NV rows); idx (P, nph, s_max) int32, the
// layout's send columns (`send_idx`); scale (P, nph, s_max) f32, the send
// mask or the mask times the inverse volume (`pack_scale`); buf (P, nph,
// rows, s_max) in the wire type W (f32 or bf16).
//
// Replaces no pallas_call: the reference packs with XLA slices and a take
// (cfd_proxy_tpu/models/gradients_pallas.py:807 `_pack_buf`).  As torch
// indexing the pack was an advanced index over three broadcast int64 index
// tensors, a broadcast multiply and a cast, about 0.084 ms a step at the
// 96^3 eight-shard plan; this kernel is that pass by hand.
//
// The types are the torch expression's, `(x[shard, row, idx] * scale)
// .to(W)`, bit for bit on every lane: x widened to f32 (exact), one f32
// product (__fmul_rn: nothing to contract with), rounded to nearest even
// into W.  A pad lane (scale 0) is computed as any other: its index names a
// column of the shard (a segment's pads repeat its last send column, so
// their loads land on a line a neighbour reads), and its product keeps
// torch's sign of zero.
//
// Bound: bytes.  The buffer written once, each live lane's source rows,
// index and scale read once: at the 96^3 eight-shard plan (6 phases,
// s_max 2432, 24 f32 rows, 55 406 live lanes of 116 736) 11.21 MB written
// and 6.25 MB read, 0.0052 ms at 3.35 TB/s.  The design: a thread takes
// four neighbouring lanes of one (shard, phase) and kRows rows; it reads
// the four indices and scales with one 16-byte load each, issues its
// kRows x 4 gathered loads before any store, then stores each row's four
// wire values at once (16 bytes f32, 8 bf16).  The send columns are sorted
// within a unit (parallel/tlayout.py), so a warp's loads of one row fall
// on neighbouring columns and its stores on one stretch of a buffer row.
// A grid row (blockIdx.y) per group of kRows rows.  The layout pads s_max
// to whole 128-lane tiles (parallel/tlayout.py), so every call the models
// make takes whole quads; the wrapper refuses any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;          // rows a thread, a grid row per group

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// Four wire values into 16 (f32) or 8 (bf16) aligned bytes.
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// Lane quad q (lanes 4q .. 4q+3 of the flattened (P * nph, s_max) lanes;
// s_max a multiple of 4, so a quad stays in one (shard, phase)), rows
// [blockIdx.y * kRows, + kRows) of its buffer.
template <class X, class W>
__global__ void __launch_bounds__(kThreads)
pack_halo_kernel(const X* __restrict__ x, const int* __restrict__ idx,
                 const float* __restrict__ scale, int64_t rows, int64_t ndev,
                 int64_t nph, int64_t s_max, int64_t quads,
                 W* __restrict__ buf) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (q >= quads) return;
  const int64_t lane = q * 4, pk = lane / s_max, j = lane - pk * s_max;
  const int64_t p = pk / nph, r0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int4 c = *reinterpret_cast<const int4*>(idx + lane);
  const float4 s = *reinterpret_cast<const float4*>(scale + lane);
  const X* xr = x + (p * rows + r0) * ndev;
  W* out = buf + (pk * rows + r0) * s_max + j;
  float v[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i < rows) {
      const X* row = xr + i * ndev;
      v[i][0] = widen(row[c.x]);
      v[i][1] = widen(row[c.y]);
      v[i][2] = widen(row[c.z]);
      v[i][3] = widen(row[c.w]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i < rows) {
      store4(out + i * s_max, __fmul_rn(v[i][0], s.x),
             __fmul_rn(v[i][1], s.y), __fmul_rn(v[i][2], s.z),
             __fmul_rn(v[i][3], s.w));
    }
  }
}

template <class X, class W>
int launch_pack(const void* x, const int* idx, const float* scale, int64_t P,
                int64_t rows, int64_t ndev, int64_t nph, int64_t s_max,
                void* buf, cudaStream_t stream) {
  const int64_t quads = P * nph * s_max / 4;
  if (quads == 0 || rows == 0) return 0;
  const int64_t groups = (rows + kRows - 1) / kRows;
  W* bp = static_cast<W*>(buf);
  if (groups > 65535 || s_max % 4 != 0 ||
      reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scale) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bp) % (4 * sizeof(W)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(groups));
  pack_halo_kernel<X, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const X*>(x), idx, scale, rows, ndev, nph, s_max, quads,
      bp);
  return static_cast<int>(cudaGetLastError());
}

template <class X>
int launch_wire(int w_bf16, const void* x, const int* idx, const float* scale,
                int64_t P, int64_t rows, int64_t ndev, int64_t nph,
                int64_t s_max, void* buf, cudaStream_t stream) {
  return w_bf16 ? launch_pack<X, bf16>(x, idx, scale, P, rows, ndev, nph,
                                       s_max, buf, stream)
                : launch_pack<X, float>(x, idx, scale, P, rows, ndev, nph,
                                        s_max, buf, stream);
}

}  // namespace

// x (P, rows, ndev) contiguous, bf16 where x_bf16 != 0, else f32; idx and
// scale (P, nph, s_max) contiguous int32 and f32, 16-byte aligned, every
// index in [0, ndev), s_max a multiple of 4; buf (P, nph, rows, s_max)
// contiguous, bf16 where w_bf16 != 0, else f32.  Launches on `stream`;
// returns the launch's cudaError_t (0 = success).
extern "C" int cfd_pack_halo(const void* x, int x_bf16, const int* idx,
                             const float* scale, int64_t P, int64_t rows,
                             int64_t ndev, int64_t nph, int64_t s_max,
                             void* buf, int w_bf16, cudaStream_t stream) {
  if (P < 0 || rows < 0 || ndev < 0 || nph < 0 || s_max < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return x_bf16 ? launch_wire<bf16>(w_bf16, x, idx, scale, P, rows, ndev,
                                    nph, s_max, buf, stream)
                : launch_wire<float>(w_bf16, x, idx, scale, P, rows, ndev,
                                     nph, s_max, buf, stream);
}

// Registers, local bytes a thread, static shared bytes and resident blocks
// per SM of the instance (x_bf16, w_bf16) into out[0..3].
extern "C" int cfd_pack_halo_info(int x_bf16, int w_bf16, int* out) {
  const void* fn =
      x_bf16 ? (w_bf16 ? reinterpret_cast<const void*>(
                             &pack_halo_kernel<bf16, bf16>)
                       : reinterpret_cast<const void*>(
                             &pack_halo_kernel<bf16, float>))
             : (w_bf16 ? reinterpret_cast<const void*>(
                             &pack_halo_kernel<float, bf16>)
                       : reinterpret_cast<const void*>(
                             &pack_halo_kernel<float, float>));
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}
