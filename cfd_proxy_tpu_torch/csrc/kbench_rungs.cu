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
// Design: K1's own (sweep_common.cuh, kbench_twins.cu) for every rung but
// i8, so that a rung differs from its K1 in arithmetic or bytes only and
// their times compare: one thread per point column, accumulators and own
// values in registers for the whole slot loop, every stream coalesced along
// the point columns through the read-only cache, the slot table in shared
// memory, the same skip of pad entries, 128 threads a block and K1's
// launch-bounds hint.
//
// i8 (K5d) no longer shares K1's load pattern.  One byte per thread and row
// is 32 B per warp: with K1's pattern a slot lane costs 11 load requests (8
// int8 rows, 3 bf16 weight rows) for 14 B, and K5d timed as K5e-bf16, which
// moves 22 B per slot lane in the same 11 requests.  So i8_kernel gives
// each thread V = kI8Lanes = 4 consecutive point columns
// (ops/twins.py::I8_LANES): one 4-byte copy of deltas per row and slot (a
// whole 128-byte line per warp), one 8-byte copy of 4 weights, own and
// scale as float4, 4 bf16 values stored per output row; the V-lane group
// is live in slot k when its first lane is.  Every slot width and offset
// must be a multiple of V (the kernel traps on one that is not; the
// launch checks bp and L, the wrapper the alignment of every vector access,
// and both refuse).  Two measured limits shape the rest (PERF.md section
// 6):
// - registers: one thread holding all 8 variables of 4 columns needs 96
//   accumulators and 32 own values (168 registers, 12 warps per SM), and
//   ptxas then interleaves the slot's loads with its arithmetic unless it
//   can spare registers, which exposed their latency (on an H100, 0.087
//   against 0.109 ms from code shape alone).  So V/2 threads share a
//   group of V lanes, each taking NV/(V/2) variables: a tile of 16
//   (variable, lane) pairs, 48 accumulators, 124 registers, no spill, 16
//   warps per SM; the weight rows are read by each of the V/2 threads (L1
//   serves the repeats).
// - loads in flight: each thread copies its live slots' raw rows into a
//   ring of kI8Stages slots in shared memory with cp.async, kI8Stages - 1
//   slots ahead of the one it computes, so no register waits on them.
// Each lane's arithmetic is the one-column kernel's, in its order, so the
// outputs are the same bit for bit.  The entry's eight quantization steps
// sit in shared memory.

#include <cuda_pipeline.h>

#include "sweep_common.cuh"

namespace {

// K1's hint (sweep_packed.cu), so that the rungs are scheduled as K1 is.
constexpr int kMinBlocks = 5;
// Lanes of one (entry, variable) row of i8_scale: the reference stores the
// step broadcast over one 128-lane tile.
constexpr int kScaleLanes = 128;

// The rungs on the shared template, by their index in ops/twins.py::RUNGS
// (i8, index 3, has a kernel of its own: i8_kernel).
enum class Rung { kFold = 0, kFoldWsum = 1, kAcc3 = 2, kFluxFact = 4,
                  kStreamFlux = 5 };

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
  int64_t chunks;            // CUDA blocks per entry
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

// ---- K5d: V point columns per thread (the header comment).

constexpr int kI8Lanes = 4;

// int8 → f32 (exact)
__device__ __forceinline__ void widen(char4 c, float (&x)[4]) {
  x[0] = static_cast<float>(c.x);
  x[1] = static_cast<float>(c.y);
  x[2] = static_cast<float>(c.z);
  x[3] = static_cast<float>(c.w);
}
// bf16 → f32 (exact: a bf16 is the top half of its f32), two a word
__device__ __forceinline__ void widen_pair(unsigned u, float* x) {
  x[0] = __uint_as_float(u << 16);
  x[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint2 u, float (&x)[4]) {
  widen_pair(u.x, x);
  widen_pair(u.y, x + 2);
}

// 4 consecutive f32 values (16-byte aligned) in one 16-byte load.
__device__ __forceinline__ void ld_f32(const float* p, float (&x)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

// 4 values rounded to bf16 (to nearest even, as cfd::store), in one 8-byte
// store.
__device__ __forceinline__ void st_bf16(cfd::bf16* p, const float (&x)[4]) {
  unsigned h[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * j])) |
           (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * j + 1])))
            << 16);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(h[0], h[1]);
}

// Slots each thread has in flight in its shared-memory ring (one computed,
// kI8Stages - 1 arriving), and the resident CUDA blocks per SM asked of
// ptxas (128 registers: 48 accumulators, 16 own values, no spill).
constexpr int kI8Stages = 4;
constexpr int kI8MinBlocks = 4;

// One chunk of one (shard, entry) per CUDA block.  Thread t holds a tile
// of 16 (variable, lane) pairs: S = V/2 threads share a group of V lanes,
// thread t taking variables [h·NV/S, (h+1)·NV/S) (h = t / G, G = kThreads/S
// groups a block) of lanes [l0, l0 + V), l0 = V·(chunk·G + t % G), for all
// three dimensions.  Its live slots' deltas and weights are copied, raw,
// into its own kI8Stages-slot ring in shared memory (cp.async), kI8Stages -
// 1 slots ahead of the one it computes.  The early returns are uniform
// over the block up to the barrier.
__global__ void __launch_bounds__(cfd::kThreads, kI8MinBlocks)
i8_kernel(RungArgs a) {
  constexpr int NV = cfd::kNV;
  constexpr int V = kI8Lanes;
  constexpr int S = V / 2;              // threads per group of V lanes
  constexpr int NS = NV / S;            // variables per thread
  constexpr int G = cfd::kThreads / S;  // lane groups per CUDA block
  constexpr int D = kI8Stages;
  using Q = char4;                      // V int8 deltas
  using W = uint2;                      // V bf16 weights
  __shared__ int s_width[cfd::kMaxSlots];
  __shared__ int s_off[cfd::kMaxSlots];
  __shared__ float s_step[NV];          // the entry's quantization steps
  __shared__ Q s_q[D][NS][cfd::kThreads];
  __shared__ W s_w[D][3][cfd::kThreads];
  const int64_t blk = blockIdx.x;
  const int64_t g = blk / a.chunks;     // flat (shard, entry) index
  const int64_t b = g % a.nb;
  if (b > 0 && a.block_ids[g] == a.block_ids[g - 1]) return;   // pad entry
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    s_width[k] = a.slots[k];
    s_off[k] = a.slots[a.K + k];
    if ((s_width[k] | s_off[k]) % V != 0) __trap();   // the vector copies
  }
  if (threadIdx.x < NV) {
    s_step[threadIdx.x] =
        __ldg(a.extra + (g * NV + threadIdx.x) * kScaleLanes);
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int lane = V * (static_cast<int>((blk % a.chunks) * G) + t % G);
  if (lane >= a.bp) return;
  const int v0 = (t / G) * NS;          // the thread's first variable
  const int64_t shard = g / a.nb;
  const int64_t ndev = a.ndev;
  const int64_t col = static_cast<int64_t>(a.block_ids[g]) * a.bp + lane;
  const float* own_p = a.var_T + (shard * NV + v0) * ndev + col;
  cfd::bf16* out_p =
      static_cast<cfd::bf16*>(a.out) + (shard * 3 * NV + v0) * ndev + col;
  const int8_t* src =
      static_cast<const int8_t*>(a.srcs) + (g * NV + v0) * a.L + lane;
  const cfd::bf16* wt =
      static_cast<const cfd::bf16*>(a.slot_w) + g * 3 * a.L + lane;

  float own[NS][V];
#pragma unroll
  for (int v = 0; v < NS; ++v) ld_f32(own_p + v * ndev, own[v]);
  float acc[3 * NS][V];                 // row d·NS + v: out row d·NV + v0 + v
#pragma unroll
  for (int r = 0; r < 3 * NS; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.0f;
  }

  auto live_from = [&](int k) {         // the first live slot from k on
    while (k < a.K && lane >= s_width[k]) ++k;
    return k;
  };
  auto copy_slot = [&](int st, int k) {  // slot k's rows into stage st
    const int64_t off = s_off[k];
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      __pipeline_memcpy_async(&s_q[st][v][t], src + off + v * a.L,
                              sizeof(Q));
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      __pipeline_memcpy_async(&s_w[st][d][t], wt + off + d * a.L,
                              sizeof(W));
    }
  };
  // stages 0 .. D-2 take the first D-1 live slots; each step then waits
  // for its slot's copies, computes it, and refills the stage the previous
  // step freed with the next live slot (one commit a step, empty or not)
  int k = live_from(0);
  int kf = k;                           // the next slot to copy
#pragma unroll
  for (int st = 0; st < D - 1; ++st) {
    if (kf < a.K) {
      copy_slot(st, kf);
      kf = live_from(kf + 1);
    }
    __pipeline_commit();
  }
  for (int st = 0; k < a.K; st = st == D - 1 ? 0 : st + 1) {
    __pipeline_wait_prior(D - 2);
    float w[3][V];
#pragma unroll
    for (int d = 0; d < 3; ++d) widen(s_w[st][d][t], w[d]);
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      float q[V];
      widen(s_q[st][v][t], q);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float tv = own[v][j] + 0.5f * (q[j] * s_step[v0 + v]);
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d * NS + v][j] += w[d][j] * tv;
      }
    }
    if (kf < a.K) {
      copy_slot(st == 0 ? D - 1 : st - 1, kf);
      kf = live_from(kf + 1);
    }
    __pipeline_commit();
    k = live_from(k + 1);
  }

  float sc[V];
  ld_f32(a.scale + g * a.bp + lane, sc);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      float x[V];
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = acc[d * NS + v][j] * sc[j];
      st_bf16(out_p + (d * NV + v) * ndev, x);
    }
  }
}

// Grid and chunks of a launch whose CUDA block covers `cols` point columns
// of an entry.
inline int64_t rung_grid(int64_t P, int64_t nb, int bp, int cols,
                         int64_t* chunks) {
  *chunks = (bp + cols - 1) / cols;
  return P * nb * (*chunks);
}

template <Rung kR, class WT, class ST, class OT>
int launch_rung(RungArgs a, int64_t P, cudaStream_t stream) {
  if (P == 0 || a.nb == 0) return 0;
  const int64_t grid = rung_grid(P, a.nb, a.bp, cfd::kThreads, &a.chunks);
  if (!cfd::sweep_args_ok(a.K, a.bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rung_kernel<kR, WT, ST, OT>
      <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A CUDA block of i8_kernel covers kThreads / (V/2) groups of V lanes.
int launch_i8(RungArgs a, int64_t P, cudaStream_t stream) {
  constexpr int V = kI8Lanes;
  if (P == 0 || a.nb == 0) return 0;
  const int64_t grid =
      rung_grid(P, a.nb, a.bp, cfd::kThreads / (V / 2) * V, &a.chunks);
  if (!cfd::sweep_args_ok(a.K, a.bp, grid) || a.bp % V != 0 ||
      a.L % V != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  i8_kernel<<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The operands of cfd_sweep_packed (sweep_packed.cu) on an f32 state, all
// contiguous on the current device; K <= 64.  `rung` picks the kernel, in
// the order of ops/twins.py::RUNGS:
//   0 fold, 1 fold_wsum, 2 acc3: srcs bf16 deltas, slot_w bf16, out
//     (P, 3*NV, ndev) bf16; fold_wsum reads `extra` = wsum (P, nb, 3, bp) f32;
//   3 i8: srcs int8, slot_w bf16, out (P, 3*NV, ndev) bf16, `extra` =
//     i8_scale (P, nb, NV, 128) f32; bp, L and every slot width and offset
//     multiples of kI8Lanes (4), and var_T, scale, srcs, slot_w and out
//     aligned to its vector accesses (checked by the wrapper,
//     ops/twins.py);
//   4 flux_fact, 5 stream_flux: srcs and slot_w f32, out (P, NV, ndev) f32.
// `extra` is null for the rungs that read none; `out` is zero-filled by the
// caller.  Launches on `stream`; returns the launch's cudaError_t (0 =
// success), cudaErrorInvalidValue for an unknown rung or a missing `extra`
// (and for i8, bp or L not a multiple of 4).
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
      return launch_i8(a, P, stream);
    case 4:
      return launch_rung<Rung::kFluxFact, float, float, float>(a, P, stream);
    case 5:
      return launch_rung<Rung::kStreamFlux, float, float, float>(a, P,
                                                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
