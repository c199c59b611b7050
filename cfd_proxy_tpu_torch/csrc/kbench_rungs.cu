// The kernel bench's rungs on K1's compact prefix tables (tools/kbench.py):
// K5f (the bf16 stack with pre-halved weights, own folded or hoisted), K5g
// (one accumulator set per dimension), K5d (int8 deltas), K5h (the factored
// upwind flux) and K5i (the flux kernel's stream twin).
//
// Replaces the Pallas closures of cfd_proxy_tpu/tools/kbench.py::main:
//   K5d  i8_kernel (:424), launched through i8_fn (:446);
//   K5f  _bso_kernel(hoist_own) (:546), through _bso_fn (:575): bso_fold
//        (hoist_own False) and bso_wsum (True);
//   K5g  bso_acc3_kernel (:614), through bso_acc3_fn (:635);
//   K5h  cflux_fact_kernel (:691), through cflux_fact_fn (:716);
//   K5i  cstream_flux_kernel (:743), through cstream_flux_fn (:763).
//
// For point column col of listed entry b of shard p (lane l), over the live
// slots k (l < wks[k]) with source s_k (a delta d_k where the table holds
// deltas) and weights w_k at compact lane off_k + l, in the reference's
// operation order:
//   fold        o2 = own + own;  acc[d*NV+v] += w'_k[d] * (o2[v] + d_k[v])
//               (w' = the weights halved by the host, so this is K1's
//               w_k[d] * (own[v] + 0.5f*d_k[v]) with one operation fewer)
//   fold_wsum   acc[d*NV+v] += w'_k[d] * d_k[v];  then once
//               acc[d*NV+v] += wsum[d] * o2[v], wsum (P, nb, 3, bp) f32 =
//               0.5 * sum_k w_k read once per point column
//   acc3        avg[v] = own[v] + 0.5f*d_k[v];  for each d: acc_d[v] +=
//               w_k[d] * avg[v], three separate accumulator sets joined at
//               the store (rows d*NV+v): K1's products in K1's order
//   i8          d_k[v] = float(q_k[v]) * s[v], s[v] = i8_scale[p, b, v, 0]
//               (the per-(entry, variable) quantization step);
//               acc[d*NV+v] += w_k[d] * (own[v] + 0.5f*d_k[v])
//   flux_fact   udw, uow, a as K1's flux body (sweep_common.cuh);
//               cu = 0.5f*(udw + a);  cg = 0.5f*(uow - a);
//               acc[v] += cu*own[v] + cg*s_k[v]
//   stream_flux s1[v] = own[v] + sum_k s_k[v];  s2[d] = sum_k w_k[d];
//               out[v] = (s1[v] * ((s2[0] + s2[1]) + s2[2])) * scale
// and out = acc * scale for all but stream_flux.  The gg rungs (fold,
// fold_wsum, acc3, i8) write 3*NV rows in bf16 from bf16 weights and bf16
// (i8: int8) deltas; the flux rungs write NV rows in f32 from f32 tables.
// Every narrow operand is widened where it is loaded (cfd::ld), the sums
// stay f32 and only the store rounds (cfd::store).
//
// acc3 forms K1-w16-d16-o16's products and adds them in its order, so the
// two agree bit for bit; so does fold while no halved weight is subnormal
// (scaling by two is exact).  stream_flux has no multiply-add to contract
// and agrees with its plain version bit for bit; the others' multiply-adds
// contract as K1's do (flux_fact's max(|udw|, |uow|) can flip near a tie,
// as K1-flux's).
//
// Bound: memory, the bytes of the K1 instance each rung stands beside.  Per
// listed point column: own 32 B, scale 4 B, the output (24 rows of 2 B, or 8
// of 4 B), and for fold_wsum 12 B of wsum; per live slot lane: 8 sources (2
// B deltas, 1 B int8, or 4 B values) and 3 weights (2 B or 4 B); i8 reads 8
// floats of i8_scale per CUDA block.  Arithmetic per slot lane: fold 8 adds
// + 24 FMAs; fold_wsum 24 FMAs; acc3 and i8 K1's 8 + 24 FMAs (i8: + 8
// multiplies); flux_fact 6 dot FMAs + 5 + 16; stream_flux 11 adds.
//
// Design: K1's own (sweep_common.cuh, kbench_twins.cu), so that a rung
// differs from its K1 in arithmetic or bytes only and their times compare:
// one thread per point column, accumulators and own values in registers
// for the whole slot loop, every stream coalesced along the point columns
// through the read-only cache, the slot table (and i8's eight scales) in
// shared memory, the same skip of pad entries, 128 threads a block and K1's
// launch-bounds hint.  An int8 source is one byte per thread (32 B per warp
// and row): coalesced, in narrow transactions, the simple form.

#include "sweep_common.cuh"

namespace {

// K1's hint (sweep_packed.cu), so that the rungs are scheduled as K1 is.
constexpr int kMinBlocks = 5;
// Lanes of one (entry, variable) row of i8_scale: the reference stores the
// step broadcast over one 128-lane tile.
constexpr int kScaleLanes = 128;

// In the order of ops/twins.py::RUNGS.
enum class Rung { kFold, kFoldWsum, kAcc3, kI8, kFluxFact, kStreamFlux };

__host__ __device__ constexpr bool is_flux(Rung r) {
  return r == Rung::kFluxFact || r == Rung::kStreamFlux;
}

struct RungArgs {
  const float* var_T;        // (P, NV, ndev)
  int64_t ndev;
  const void* srcs;          // (P, nb, NV, L)
  const void* slot_w;        // (P, nb, 3, L)
  const float* scale;        // (P, nb, bp)
  const int32_t* block_ids;  // (P, nb)
  const int32_t* slots;      // (2, K) width, offset
  int K;
  int64_t nb;
  int64_t L;
  int bp;
  int64_t chunks;            // cfd::kThreads-column chunks per block
  const float* extra;        // fold_wsum: wsum (P, nb, 3, bp); i8: i8_scale
                             // (P, nb, NV, kScaleLanes); else null
  void* out;                 // (P, rows, ndev), zero-filled by the wrapper
};

// One cfd::kThreads-column chunk of one (shard, entry) per CUDA block, as in
// cfd::sweep_chunk; the early returns are uniform over the block up to the
// barrier.
template <Rung kR, class WT, class ST, class OT>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
rung_kernel(RungArgs a) {
  constexpr int NV = cfd::kNV;
  constexpr int R = is_flux(kR) ? NV : 3 * NV;
  __shared__ int s_width[cfd::kMaxSlots];
  __shared__ int s_off[cfd::kMaxSlots];
  __shared__ float s_step[NV];          // i8: the entry's quantization steps
  const int64_t blk = blockIdx.x;
  const int64_t g = blk / a.chunks;     // flat (shard, entry) index
  const int64_t b = g % a.nb;
  if (b > 0 && a.block_ids[g] == a.block_ids[g - 1]) return;   // pad entry
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    s_width[k] = a.slots[k];
    s_off[k] = a.slots[a.K + k];
  }
  if constexpr (kR == Rung::kI8) {
    if (threadIdx.x < NV) {
      s_step[threadIdx.x] =
          __ldg(a.extra + (g * NV + threadIdx.x) * kScaleLanes);
    }
  }
  __syncthreads();

  const int lane = static_cast<int>((blk % a.chunks) * cfd::kThreads) +
                   static_cast<int>(threadIdx.x);
  if (lane >= a.bp) return;
  const int64_t shard = g / a.nb;
  const int64_t ndev = a.ndev;
  const int64_t col = static_cast<int64_t>(a.block_ids[g]) * a.bp + lane;
  const float* own_p = a.var_T + shard * NV * ndev;
  OT* out_p = static_cast<OT*>(a.out) + shard * R * ndev;
  const ST* src = static_cast<const ST*>(a.srcs) + g * NV * a.L + lane;
  const WT* wt = static_cast<const WT*>(a.slot_w) + g * 3 * a.L + lane;

  // own; fold and fold_wsum keep o2 = own + own in its place
  float own[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    own[v] = __ldg(own_p + v * ndev + col);
    if constexpr (kR == Rung::kFold || kR == Rung::kFoldWsum) {
      own[v] = own[v] + own[v];
    }
  }

  float acc[R];                         // stream_flux: s1
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = kR == Rung::kStreamFlux ? own[r] : 0.0f;
  }
  float s2[3] = {0.0f, 0.0f, 0.0f};     // stream_flux only

  for (int k = 0; k < a.K; ++k) {
    if (lane >= s_width[k]) continue;   // outside slot k's prefix
    const int64_t off = s_off[k];
    float w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) w[d] = cfd::ld(wt + off + d * a.L);
    float t[NV];                        // the slot's per-variable term
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float sv = cfd::ld(src + off + v * a.L);
      if constexpr (kR == Rung::kFold) {
        t[v] = own[v] + sv;                           // o2 + delta
      } else if constexpr (kR == Rung::kAcc3) {
        t[v] = own[v] + 0.5f * sv;
      } else if constexpr (kR == Rung::kI8) {
        t[v] = own[v] + 0.5f * (sv * s_step[v]);
      } else {
        t[v] = sv;
      }
    }
    if constexpr (kR == Rung::kStreamFlux) {
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] += t[v];
#pragma unroll
      for (int d = 0; d < 3; ++d) s2[d] += w[d];
    } else if constexpr (kR == Rung::kFluxFact) {
      const float udw = own[0] * w[0] + own[1] * w[1] + own[2] * w[2];
      const float uow = t[0] * w[0] + t[1] * w[1] + t[2] * w[2];
      const float am = fmaxf(fabsf(udw), fabsf(uow));
      const float cu = 0.5f * (udw + am);
      const float cg = 0.5f * (uow - am);
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] += cu * own[v] + cg * t[v];
    } else {
      // acc3: the dimension loop outside the variables', one accumulator
      // set acc[d*NV .. d*NV+NV) per dimension; the others as K1
#pragma unroll
      for (int d = 0; d < 3; ++d) {
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[d * NV + v] += w[d] * t[v];
      }
    }
  }

  if constexpr (kR == Rung::kFoldWsum) {
    const float* ws = a.extra + g * 3 * a.bp + lane;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float wd = __ldg(ws + d * a.bp);
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[d * NV + v] += wd * own[v];
    }
  }

  const float sc = __ldg(a.scale + g * a.bp + lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x;
    if constexpr (kR == Rung::kStreamFlux) {
      x = (acc[r] * ((s2[0] + s2[1]) + s2[2])) * sc;
    } else {
      x = acc[r] * sc;
    }
    cfd::store(out_p + r * ndev + col, x);
  }
}

template <Rung kR, class WT, class ST, class OT>
int launch_rung(RungArgs a, int64_t P, cudaStream_t stream) {
  if (P == 0 || a.nb == 0) return 0;
  const int64_t grid = cfd::sweep_grid(P, a.nb, a.bp, &a.chunks);
  if (!cfd::sweep_args_ok(a.K, a.bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rung_kernel<kR, WT, ST, OT>
      <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The operands of cfd_sweep_packed (sweep_packed.cu) on an f32 state, all
// contiguous on the current device; K <= 64.  `rung` picks the kernel, in
// the order of ops/twins.py::RUNGS:
//   0 fold, 1 fold_wsum, 2 acc3: srcs bf16 deltas, slot_w bf16, out
//     (P, 3*NV, ndev) bf16; fold_wsum reads `extra` = wsum (P, nb, 3, bp) f32;
//   3 i8: srcs int8, slot_w bf16, out (P, 3*NV, ndev) bf16, `extra` =
//     i8_scale (P, nb, NV, 128) f32;
//   4 flux_fact, 5 stream_flux: srcs and slot_w f32, out (P, NV, ndev) f32.
// `extra` is null for the rungs that read none; `out` is zero-filled by the
// caller.  Launches on `stream`; returns the launch's cudaError_t (0 =
// success), cudaErrorInvalidValue for an unknown rung or a missing `extra`.
extern "C" int cfd_kbench_rung(const float* var_T, int64_t ndev,
                               const void* srcs, const void* slot_w,
                               const float* scale, const int32_t* block_ids,
                               const int32_t* slots, int K, int64_t P,
                               int64_t nb, int64_t L, int bp, int rung,
                               const float* extra, void* out,
                               cudaStream_t stream) {
  using cfd::bf16;
  const RungArgs a{var_T, ndev, srcs, slot_w, scale, block_ids, slots,
                   K, nb, L, bp, 0, extra, out};
  const bool needs_extra = rung == 1 || rung == 3;
  if (needs_extra != (extra != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (rung) {
    case 0:
      return launch_rung<Rung::kFold, bf16, bf16, bf16>(a, P, stream);
    case 1:
      return launch_rung<Rung::kFoldWsum, bf16, bf16, bf16>(a, P, stream);
    case 2:
      return launch_rung<Rung::kAcc3, bf16, bf16, bf16>(a, P, stream);
    case 3:
      return launch_rung<Rung::kI8, bf16, int8_t, bf16>(a, P, stream);
    case 4:
      return launch_rung<Rung::kFluxFact, float, float, float>(a, P, stream);
    case 5:
      return launch_rung<Rung::kStreamFlux, float, float, float>(a, P,
                                                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
