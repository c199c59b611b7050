// K4: packed source table for the block sweep (compact layout), over P
// shards in one launch: f32 source values, or bf16 source deltas.
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::pack_srcs (the Pallas re-pack,
// compact `wks` layout, src_format "f32" or "bf16d") together with the take
// that feeds it (blocksweep.py::gather_exts).  The reference's two stages
// are kept, fused through shared memory: per table block (p, b) the block's
// W columns of a variable row — its bp own columns, then its EP ext columns
// (ext_idx) — are staged in shared memory (gather_exts), and every compact
// lane j then resolves its compact W-index widx[p, b, j] against the staged
// row (pack_srcs, _masked_gather):
//
//     f32:   out[p, b, v, j] = row_v[widx[p, b, j]]
//     bf16d: out[p, b, v, j] = bf16_rn(row_v[widx[p, b, j]] - row_v[lane(j)])
//
//     row_v = var_T[p, v, b_id*bp : b_id*bp + bp] ++ var_T[p, v, ext_idx[p, b]]
//
// for j < L, v < NV, b_id = block_ids[p, b].  widx is the plan's slot_idx
// prefix-compacted as the weights are (ops/plan.py::compact_widx), so
// row_v[widx[j]] is var_T[p, v, src_cols[p, b, j]] (ops/plan.py::
// compact_src_cols), which the plain version gathers.  bf16d is the
// reference's delta pack (:969-975): each entry's source minus the
// destination lane's OWN value, lane(j) = j - off_k for the slot k whose
// compact lanes [off_k, off_k + wks[k]) hold j (the slot table `slots`,
// (2, K) widths and offsets); the own column is W-index lane(j) of the
// staged row, so var_T is read once for both.  Pad lanes resolve to a
// valid column with zero weight in the reference's plan, so their delta is
// the same finite value there and here; pad entries (the trash block
// repeated) are packed like any other entry.  The f32 subtraction and the
// round-to-nearest-even cast are the reference's, so both forms equal the
// plain PyTorch version bit for bit.
//
// Bound: memory.  Per table entry it writes NV*4 = 32 bytes (f32) or NV*2 =
// 16 bytes (bf16d) and reads one 4-byte W-index; the state is read once per
// staging.  The first design gathered var_T[p, v, src_cols[j]] straight
// from device memory, one thread per lane: a warp's load touched ~29
// distinct 32-byte sectors for 32 lanes at 96^3 (each table block reads
// ~5 400 distinct columns ~4.8 times each), ~1.35 GB through L2 to write
// 184 MB, 30 % of the bound on an H100 (bf16d 19 %).  Here each staged
// column is read once per CUDA block (own columns as 16-byte loads of one
// contiguous run, ext columns through the sorted ext list); the lane loop
// reads the W-index coalesced (four lanes a thread, 16 bytes), shared
// memory at random, and writes coalesced (16 bytes f32, 8 bytes bf16 a
// thread): 65 % of the bound (bf16d 42 %) at the 96^3 one-shard table on
// an H100 at 700 W, 1.7x faster than one torch.gather of the same table
// (PERF.md section 6, chip_smoke.py).
//
// Split: a CUDA block stages `rows` variable rows (rows x (bp + EP) x 4
// bytes of dynamic shared memory) of one table block and writes all their
// lanes, so a launch has P*nb*(NV/rows) blocks: 218 table blocks quantise
// badly on 132 SMs, and 872 blocks of two rows fill the card.  The wrapper
// stages two rows, halved until they fit one block's shared memory
// (ops/blocksweep.py::pack_srcs).  Fewer rows re-read the W-index, more
// rows or lane ranges per table block re-stage more than the better
// quantisation buys (each candidate's time: PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNV = 8;          // padded variable count (ops/plan.py::NV)
constexpr int kThreads = 256;
constexpr int kMaxSlots = 64;   // slot-table capacity (checked by the wrapper)
// dynamic shared memory a block may take: an H100 block's 227 KB less the
// static slot table
constexpr int kMaxSmem = 227 * 1024 - 2 * kMaxSlots * 4;

// Floats per staged row: bp + ep, rounded up to whole 16-byte pieces so
// that every row starts aligned.
__host__ __device__ inline int row_stride(int bp, int ep) {
  return (bp + ep + 3) / 4 * 4;
}

template <bool kDelta>
__global__ void __launch_bounds__(kThreads)
pack_staged_kernel(const float* __restrict__ var_T, int64_t ndev,
                   const int32_t* __restrict__ widx,
                   const int32_t* __restrict__ ext_idx, int ep,
                   const int32_t* __restrict__ block_ids,
                   const int32_t* __restrict__ slots, int K, int bp,
                   int64_t nb, int64_t L, int rows,
                   void* __restrict__ out) {
  extern __shared__ __align__(16) float s_row[];   // rows x row_stride(..)
  __shared__ int s_width[kMaxSlots];
  __shared__ int s_off[kMaxSlots];
  const int64_t blk = blockIdx.x;
  const int groups = kNV / rows;
  const int v0 = static_cast<int>(blk % groups) * rows;
  const int64_t g = blk / groups;              // flat (shard, block) index
  const int W = row_stride(bp, ep);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_width[k] = slots[k];
    s_off[k] = slots[K + k];
  }
  // stage: own columns as one contiguous run, ext columns by the ext list
  const float* vp = var_T + ((g / nb) * kNV + v0) * ndev;
  const int64_t base = static_cast<int64_t>(block_ids[g]) * bp;
  const int32_t* ext = ext_idx + g * ep;
  for (int r = 0; r < rows; ++r) {
    const float* row = vp + r * ndev;
    const float4* own = reinterpret_cast<const float4*>(row + base);
    float4* s4 = reinterpret_cast<float4*>(s_row + r * W);
    for (int i = threadIdx.x; i < bp / 4; i += blockDim.x) {
      s4[i] = __ldg(own + i);
    }
    for (int e = threadIdx.x; e < ep; e += blockDim.x) {
      s_row[r * W + bp + e] = __ldg(row + __ldg(ext + e));
    }
  }
  __syncthreads();
  // resolve: slot by slot (K == 0: one run [0, L), f32 only); four lanes a
  // thread where the rows allow (L % 4 == 0: 16-byte W-index loads,
  // 16-byte f32 / 8-byte bf16 stores)
  const int32_t* wi = widx + g * L;
  const int64_t o0 = (g * kNV + v0) * L;
  auto one = [&](int64_t j, int64_t off) {
    const int x = __ldg(wi + j);
    for (int r = 0; r < rows; ++r) {
      const float val = s_row[r * W + x];
      if constexpr (kDelta) {
        const float own = s_row[r * W + static_cast<int>(j - off)];
        static_cast<__nv_bfloat16*>(out)[o0 + r * L + j] =
            __float2bfloat16_rn(val - own);
      } else {
        static_cast<float*>(out)[o0 + r * L + j] = val;
      }
    }
  };
  const int nslots = K > 0 ? K : 1;
  for (int k = 0; k < nslots; ++k) {
    const int64_t j0 = K > 0 ? s_off[k] : 0;      // the slot's lanes
    const int64_t j1 = K > 0 ? j0 + s_width[k] : L;
    if (j0 >= j1) continue;
    // [a, b): the whole quads of [j0, j1) when L % 4 == 0, else empty
    int64_t a = j1, b = j1;
    if (L % 4 == 0) {
      a = (j0 + 3) / 4 * 4;
      b = j1 / 4 * 4;
      if (a > b) a = b = j1;
    }
    for (int64_t j = j0 + threadIdx.x; j < a; j += blockDim.x) one(j, j0);
    for (int64_t q = a / 4 + threadIdx.x; q < b / 4; q += blockDim.x) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(wi) + q);
      const int64_t j = 4 * q;
      const int lane = static_cast<int>(j - j0);
      for (int r = 0; r < rows; ++r) {
        const float* sr = s_row + r * W;
        float4 v = make_float4(sr[x.x], sr[x.y], sr[x.z], sr[x.w]);
        if constexpr (kDelta) {
          const __nv_bfloat162 p0 = __floats2bfloat162_rn(
              v.x - sr[lane], v.y - sr[lane + 1]);
          const __nv_bfloat162 p1 = __floats2bfloat162_rn(
              v.z - sr[lane + 2], v.w - sr[lane + 3]);
          uint2 u;
          u.x = *reinterpret_cast<const uint32_t*>(&p0);
          u.y = *reinterpret_cast<const uint32_t*>(&p1);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o0 +
                                    r * L + j) = u;
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o0 + r * L +
                                     j) = v;
        }
      }
    }
    for (int64_t j = b + threadIdx.x; j < j1; j += blockDim.x) one(j, j0);
  }
}

}  // namespace

// var_T (P, NV, ndev) f32 with 16-byte aligned rows (ndev % 4 == 0, base
// aligned); widx (P, nb, L) i32 in [0, bp + ep); ext_idx (P, nb, ep) i32 in
// [0, ndev) (may be null when ep == 0); block_ids (P, nb) i32; out (P, nb,
// NV, L): f32 when delta == 0, bf16 deltas when delta != 0, which also reads
// the slot table slots (2, K) i32 (1 <= K <= 64; f32 passes K = 0 and may
// pass null); bp a multiple of 4.  rows (1, 2, 4 or 8) variable rows per
// CUDA block.  All contiguous on the current device.  Launches on `stream`; returns the launch's
// cudaError_t (0 = success).
extern "C" int cfd_pack_srcs(const float* var_T, int64_t ndev,
                             const int32_t* widx, const int32_t* ext_idx,
                             int ep, const int32_t* block_ids,
                             const int32_t* slots, int K, int bp, int64_t P,
                             int64_t nb, int64_t L, int delta, int rows,
                             void* out, cudaStream_t stream) {
  if (P == 0 || nb == 0 || L == 0) return 0;
  if (bp <= 0 || bp % 4 != 0 || ndev % 4 != 0 || ep < 0 ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8) ||
      K < 0 || K > kMaxSlots || (delta && K < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = static_cast<int64_t>(rows) * row_stride(bp, ep) * 4;
  const int64_t grid = P * nb * (kNV / rows);
  if (smem > kMaxSmem || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launch = [&](auto kernel, auto* o) {
    // above 48 KB dynamic shared memory needs the opt-in, per instance
    static int64_t allowed = 48 * 1024;
    if (smem > allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      allowed = kMaxSmem;
    }
    kernel<<<static_cast<unsigned>(grid), kThreads,
             static_cast<size_t>(smem), stream>>>(
        var_T, ndev, widx, ext_idx, ep, block_ids, slots, K, bp, nb, L,
        rows, o);
    return static_cast<int>(cudaGetLastError());
  };
  if (delta) {
    return launch(pack_staged_kernel<true>, static_cast<__nv_bfloat16*>(out));
  }
  return launch(pack_staged_kernel<false>, static_cast<float*>(out));
}

// K4's registers, local bytes, static shared bytes and resident blocks per
// SM at `smem` bytes of staged rows, into out[0..4] (delta: the bf16d
// instance).  Returns the cudaError_t.
extern "C" int cfd_pack_srcs_info(int delta, int smem, int* out) {
  const auto kernel =
      delta ? pack_staged_kernel<true> : pack_staged_kernel<false>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, kernel, kThreads, smem));
}
