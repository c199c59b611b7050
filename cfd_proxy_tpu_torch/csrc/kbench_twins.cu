// Measurement twins of K1 for the kernel bench (tools/kbench.py): K5a/K5e
// (the stream twin, one body with an f32 and a bf16 instance), K5b (K1's
// math with the own term hoisted) and K5c (K1 on 7 variable rows).
//
// Replaces the Pallas closures of cfd_proxy_tpu/tools/kbench.py::main:
//   K5a  stream_kernel (:269), launched through call() (:257) on the
//        rectangular (nb, K, NV, bp) table;
//   K5e  cstream_bso_kernel (:476), launched through _cstream_fn (:496) on
//        the compact tables: f32 tables and output (cstream_c), bf16
//        deltas, weights and output (cstream_bso);
//   K5b  wsum_kernel (:278), through call();
//   K5c  nv7_kernel (:300), through nv7_fn (:311).
// The port keeps one table layout, K1's compact one (sweep_packed.cu); the
// rectangular layout is the compact table at full widths (wks = (bp,)*K),
// so K5a is the stream body on that table and K5e the same body on the
// prefix table.
//
// For point column col of listed entry b of shard p (lane l), over the
// live slots k (l < wks[k]), with source s_k and weights w_k at compact
// lane off_k + l:
//   stream  s1[v] = own[v] + sum_k s_k[v];  s2[d] = sum_k w_k[d];
//           out[d*NV+v] = (s2[d]*s1[v]) * scale
//   wsum    acc[d*NV+v] = sum_k w_k[d]*s_k[v];  ws[d] = sum_k w_k[d];
//           out[d*NV+v] = (0.5f*(acc[d*NV+v] + ws[d]*own[v])) * scale
//   gg      K1's gg body (sweep_common.cuh) on NVT variable rows:
//           acc[d*NVT+v] += w_k[d] * 0.5f*(own[v] + s_k[v]);
//           out = acc * scale
// in the reference's operation order.  The stream twin's bf16 instance
// widens every bf16 operand where it is loaded (cfd::ld) and rounds only
// the store (cfd::store), as K1 does; it adds the deltas as values (minimal
// math, not the sweep's).  The stream body has no multiply-add to
// contract, so it agrees with its plain version bit for bit; wsum's and
// gg's multiply-adds contract as K1's do.
//
// Bound: memory, the bytes of the K1 instance each twin stands beside.  Per
// listed point column: own (4*NVT B), scale (4 B) and the output (3*NVT
// rows of 4 or 2 B); per live slot lane: NVT sources (4 or 2 B each) and 3
// weights (4 or 2 B each).  K5c moves 7/8 of K1-flat's var, source and
// output bytes (the weights and scale do not shrink).  Arithmetic per slot
// lane: 11 adds (stream), 24 FMAs + 3 adds (wsum), 21 FMAs + 14 (gg on 7
// rows), against K1's 24 FMAs + 16.
//
// Design: K1's own, so that a twin differs from K1 in its arithmetic only
// and their times compare bytes: one thread per point column, the sums and
// own values in registers for the whole slot loop, every stream coalesced
// along the point columns and read through the read-only cache with K1's
// loads, the slot table in shared memory, the same skip of pad entries
// (an entry equal to its predecessor), 128 threads a block and K1's
// launch-bounds hint.  The row count is a template parameter (NVT), so K5c
// is its own instance with its own strides; sweep_common.cuh's kNV = 8 and
// K1's instances stay as they are.

#include "sweep_common.cuh"

namespace {

// K1's hint (sweep_packed.cu), so that the twins are scheduled as K1 is.
constexpr int kMinBlocks = 5;

enum class Twin { kStream, kWsum, kGG };

struct TwinArgs {
  const float* var_T;        // (P, NVT, ndev)
  int64_t ndev;
  const void* srcs;          // (P, nb, NVT, L)
  const void* slot_w;        // (P, nb, 3, L)
  const float* scale;        // (P, nb, bp)
  const int32_t* block_ids;  // (P, nb)
  const int32_t* slots;      // (2, K) width, offset
  int K;
  int64_t nb;
  int64_t L;
  int bp;
  int64_t chunks;            // cfd::kThreads-column chunks per block
  void* out;                 // (P, 3*NVT, ndev), zero-filled by the wrapper
};

// One cfd::kThreads-column chunk of one (shard, entry) per CUDA block, as in
// cfd::sweep_chunk; the early returns are uniform over the block up to the
// barrier.
template <Twin kT, int NVT, class WT, class ST, class OT>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
twin_kernel(TwinArgs a) {
  constexpr int R = 3 * NVT;
  __shared__ int s_width[cfd::kMaxSlots];
  __shared__ int s_off[cfd::kMaxSlots];
  const int64_t blk = blockIdx.x;
  const int64_t g = blk / a.chunks;     // flat (shard, entry) index
  const int64_t b = g % a.nb;
  if (b > 0 && a.block_ids[g] == a.block_ids[g - 1]) return;   // pad entry
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    s_width[k] = a.slots[k];
    s_off[k] = a.slots[a.K + k];
  }
  __syncthreads();

  const int lane = static_cast<int>((blk % a.chunks) * cfd::kThreads) +
                   static_cast<int>(threadIdx.x);
  if (lane >= a.bp) return;
  const int64_t shard = g / a.nb;
  const int64_t ndev = a.ndev;
  const int64_t col = static_cast<int64_t>(a.block_ids[g]) * a.bp + lane;
  const float* own_p = a.var_T + shard * NVT * ndev;
  OT* out_p = static_cast<OT*>(a.out) + shard * R * ndev;
  const ST* src = static_cast<const ST*>(a.srcs) + g * NVT * a.L + lane;
  const WT* wt = static_cast<const WT*>(a.slot_w) + g * 3 * a.L + lane;

  float own[NVT];
#pragma unroll
  for (int v = 0; v < NVT; ++v) own[v] = __ldg(own_p + v * ndev + col);

  // stream: s1 in acc[0, NVT); wsum and gg: the output rows
  float acc[kT == Twin::kStream ? NVT : R];
  if constexpr (kT == Twin::kStream) {
#pragma unroll
    for (int v = 0; v < NVT; ++v) acc[v] = own[v];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  }
  float ws[3] = {0.0f, 0.0f, 0.0f};     // s2 (stream), wsum (wsum)

  for (int k = 0; k < a.K; ++k) {
    if (lane >= s_width[k]) continue;   // outside slot k's prefix
    const int64_t off = s_off[k];
    float w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = cfd::ld(wt + off + d * a.L);
#pragma unroll
    for (int v = 0; v < NVT; ++v) {
      const float sv = cfd::ld(src + off + v * a.L);
      if constexpr (kT == Twin::kStream) {
        acc[v] += sv;
      } else if constexpr (kT == Twin::kWsum) {
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d * NVT + v] += w[d] * sv;
      } else {
        const float avg = 0.5f * (own[v] + sv);
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d * NVT + v] += w[d] * avg;
      }
    }
    if constexpr (kT != Twin::kGG) {
#pragma unroll
      for (int d = 0; d < 3; ++d) ws[d] += w[d];
    }
  }

  const float sc = __ldg(a.scale + g * a.bp + lane);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int v = 0; v < NVT; ++v) {
      const int r = d * NVT + v;
      float x;
      if constexpr (kT == Twin::kStream) {
        x = (ws[d] * acc[v]) * sc;
      } else if constexpr (kT == Twin::kWsum) {
        x = (0.5f * (acc[r] + ws[d] * own[v])) * sc;
      } else {
        x = acc[r] * sc;
      }
      cfd::store(out_p + r * ndev + col, x);
    }
  }
}

template <Twin kT, int NVT, class T>
int launch_twin(TwinArgs a, int64_t P, cudaStream_t stream) {
  if (P == 0 || a.nb == 0) return 0;
  const int64_t grid = cfd::sweep_grid(P, a.nb, a.bp, &a.chunks);
  if (!cfd::sweep_args_ok(a.K, a.bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  twin_kernel<kT, NVT, T, T, T>
      <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The operands of cfd_sweep_packed (sweep_packed.cu) with NVT variable rows
// (8, or 7 for cfd_nv7_sweep), all contiguous on the current device; K <=
// 64; `out` (P, 3*NVT, ndev) is zero-filled by the caller.  Launches on
// `stream`; returns the launch's cudaError_t (0 = success).

// K5a/K5e: bf16 != 0: srcs, slot_w and out are bf16, else f32.
extern "C" int cfd_stream_twin(const float* var_T, int64_t ndev,
                               const void* srcs, const void* slot_w,
                               const float* scale, const int32_t* block_ids,
                               const int32_t* slots, int K, int64_t P,
                               int64_t nb, int64_t L, int bp, int bf16,
                               void* out, cudaStream_t stream) {
  const TwinArgs a{var_T, ndev, srcs, slot_w, scale, block_ids, slots,
                   K, nb, L, bp, 0, out};
  return bf16 ? launch_twin<Twin::kStream, cfd::kNV, cfd::bf16>(a, P, stream)
              : launch_twin<Twin::kStream, cfd::kNV, float>(a, P, stream);
}

// K5b, f32.
extern "C" int cfd_wsum_twin(const float* var_T, int64_t ndev,
                             const void* srcs, const void* slot_w,
                             const float* scale, const int32_t* block_ids,
                             const int32_t* slots, int K, int64_t P,
                             int64_t nb, int64_t L, int bp, void* out,
                             cudaStream_t stream) {
  const TwinArgs a{var_T, ndev, srcs, slot_w, scale, block_ids, slots,
                   K, nb, L, bp, 0, out};
  return launch_twin<Twin::kWsum, cfd::kNV, float>(a, P, stream);
}

// K5c, f32, 7 variable rows: var_T (P, 7, ndev), srcs (P, nb, 7, L), out
// (P, 21, ndev).
extern "C" int cfd_nv7_sweep(const float* var_T, int64_t ndev,
                             const void* srcs, const void* slot_w,
                             const float* scale, const int32_t* block_ids,
                             const int32_t* slots, int K, int64_t P,
                             int64_t nb, int64_t L, int bp, void* out,
                             cudaStream_t stream) {
  const TwinArgs a{var_T, ndev, srcs, slot_w, scale, block_ids, slots,
                   K, nb, L, bp, 0, out};
  return launch_twin<Twin::kGG, 7, float>(a, P, stream);
}
