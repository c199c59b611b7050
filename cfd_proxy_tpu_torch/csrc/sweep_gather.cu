// K2: block sweep, GATHER formulation, f32, over P shards in one launch;
// ops "gg" and "flux" (the entry point's `op`).
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::sweep_blocks, gather branch
// (body _block_compute, with _masked_gather; its gg body :416-419 and its
// flux body :420-426), with and without `init`.  The sources are gathered
// inside the sweep from the block table [own ‖ exts] by the W-index, so a
// state update rebuilds only the small per-block ext tables (gather_exts)
// instead of re-packing every slot's sources (K4).  The per-thread body,
// its bound, the W-index fetch and the handling of pad entries are in
// sweep_common.cuh (GatherSrc).
//
// Without init the wrapper hands a zero-filled output, so columns of blocks
// the plan does not list stay zero.  With init the output IS init (the
// reference aliases them): listed columns are seeded from it and rewritten
// in place, unlisted columns keep their values, and nothing is zero-filled.

#include "sweep_common.cuh"

namespace {

// Resident blocks per SM that ptxas is asked to allow for: K1's value (see
// sweep_packed.cu), kept for the same body and for the flux instances.
constexpr int kMinBlocks = 5;

template <bool kAccumulate, cfd::Op kOp>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_gather_kernel(cfd::SweepArgs a, cfd::GatherSrc s) {
  cfd::sweep_chunk<kAccumulate, kOp>(a, s, blockIdx.x);
}

template <cfd::Op kOp>
int launch_gather(const float* var_T, int64_t ndev, const float* exts,
                  int64_t ep, const int32_t* slot_idx, const float* slot_w,
                  const float* scale, const int32_t* block_ids,
                  const int32_t* slots, int K, int64_t P, int64_t nb, int bp,
                  int accumulate, float* out, cudaStream_t stream) {
  if (P == 0 || nb == 0) return 0;
  int64_t chunks = 0;
  const int64_t grid = cfd::sweep_grid(P, nb, bp, &chunks);
  if (!cfd::sweep_args_ok(K, bp, grid) || ep <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cfd::SweepArgs a{var_T, ndev, scale, block_ids, slots, K, nb, bp,
                         chunks, out};
  const cfd::GatherSrc s{exts, slot_idx, slot_w, ep};
  const unsigned g = static_cast<unsigned>(grid);
  if (accumulate) {
    sweep_gather_kernel<true, kOp><<<g, cfd::kThreads, 0, stream>>>(a, s);
  } else {
    sweep_gather_kernel<false, kOp><<<g, cfd::kThreads, 0, stream>>>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as annotated in cfd::SweepArgs and cfd::GatherSrc, all contiguous
// on the current device; K <= 64; every slot_idx in [0, bp + ep) (checked
// where the plan is loaded); op as in cfd::op_ok; `out` has cfd::op_rows
// rows.  `slots` holds the per-slot widths (its offset row is not read: the
// gather tables are rectangular).  accumulate != 0: `out` holds init on
// entry.  Launches on `stream`; returns the launch's cudaError_t
// (0 = success).
extern "C" int cfd_sweep_gather(const float* var_T, int64_t ndev,
                                const float* exts, int64_t ep,
                                const int32_t* slot_idx, const float* slot_w,
                                const float* scale, const int32_t* block_ids,
                                const int32_t* slots, int K, int64_t P,
                                int64_t nb, int bp, int accumulate, int op,
                                float* out, cudaStream_t stream) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = op == 0 ? &launch_gather<cfd::Op::kGG>
                              : &launch_gather<cfd::Op::kFlux>;
  return launch(var_T, ndev, exts, ep, slot_idx, slot_w, scale, block_ids,
                slots, K, P, nb, bp, accumulate, out, stream);
}
