// K1: block sweep, PACKED formulation, COMPACT prefix layout, f32, over P
// shards in one launch; ops "gg" and "flux" (the entry point's `op`).
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::sweep_blocks, packed branch
// with `wks` (body _block_compute_packed, its gg body :489-494 and its flux
// body :495-504), with and without `init`.  The per-thread body, its bound
// and the handling of pad entries are in sweep_common.cuh.
//
// Without init the wrapper hands a zero-filled output, so columns of blocks
// the plan does not list stay zero.  With init the output IS init (the
// reference aliases them): listed columns are seeded from it and rewritten
// in place, unlisted columns keep their values, and nothing is zero-filled.

#include "sweep_common.cuh"

namespace {

// Resident blocks per SM that ptxas is asked to allow for.  Measured on an
// H100 at the one-shard 96^3 shapes, in turns with the other settings:
// without the hint the zero-filled form took 0.167 ms and the init form
// 0.235 ms; with 5, 0.128 and 0.161 ms — the init form keeps its 96
// registers, so the gain is ptxas's schedule, not occupancy.  6 and 8 were
// slower (and make the init form spill).  The flux instances keep the
// same hint (untuned).
constexpr int kMinBlocks = 5;

template <bool kAccumulate, cfd::Op kOp>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_packed_kernel(cfd::SweepArgs a, cfd::PackedSrc s) {
  cfd::sweep_chunk<kAccumulate, kOp>(a, s, blockIdx.x);
}

template <cfd::Op kOp>
int launch_packed(const float* var_T, int64_t ndev, const float* srcs,
                  const float* slot_w, const float* scale,
                  const int32_t* block_ids, const int32_t* slots, int K,
                  int64_t P, int64_t nb, int64_t L, int bp, int accumulate,
                  float* out, cudaStream_t stream) {
  if (P == 0 || nb == 0) return 0;
  int64_t chunks = 0;
  const int64_t grid = cfd::sweep_grid(P, nb, bp, &chunks);
  if (!cfd::sweep_args_ok(K, bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cfd::SweepArgs a{var_T, ndev, scale, block_ids, slots, K, nb, bp,
                         chunks, out};
  const cfd::PackedSrc s{srcs, slot_w, L};
  const unsigned g = static_cast<unsigned>(grid);
  if (accumulate) {
    sweep_packed_kernel<true, kOp><<<g, cfd::kThreads, 0, stream>>>(a, s);
  } else {
    sweep_packed_kernel<false, kOp><<<g, cfd::kThreads, 0, stream>>>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as annotated in cfd::SweepArgs and cfd::PackedSrc, all contiguous
// on the current device; K <= 64; op as in cfd::op_ok; `out` has
// cfd::op_rows rows (3*NV gg, NV flux).  accumulate != 0: `out` holds init
// on entry.  Launches on `stream`; returns the launch's cudaError_t
// (0 = success).
extern "C" int cfd_sweep_packed(const float* var_T, int64_t ndev,
                                const float* srcs, const float* slot_w,
                                const float* scale, const int32_t* block_ids,
                                const int32_t* slots, int K, int64_t P,
                                int64_t nb, int64_t L, int bp, int accumulate,
                                int op, float* out, cudaStream_t stream) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = op == 0 ? &launch_packed<cfd::Op::kGG>
                              : &launch_packed<cfd::Op::kFlux>;
  return launch(var_T, ndev, srcs, slot_w, scale, block_ids, slots, K, P, nb,
                L, bp, accumulate, out, stream);
}
