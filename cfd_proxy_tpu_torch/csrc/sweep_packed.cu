// K1: block sweep, PACKED formulation, COMPACT prefix layout, over P shards
// in one launch; ops "gg" and "flux" (the entry point's `op`), f32 or bf16
// weights, f32 source values or bf16 source deltas, f32 or bf16 output.
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::sweep_blocks, packed branch
// with `wks` (body _block_compute_packed, its gg body :489-494 and its flux
// body :495-504), with and without `init`, with src_format "f32" or "bf16d",
// slot_w f32 or bf16 and out_dtype f32 or bf16; and the one form the kernel
// bench's var16 variant reaches with a bf16 state (own_ref[:].astype(f32),
// :469): gg, no init, bf16 weights, deltas and output.  The per-thread
// body, its bound, the precisions and the handling of pad entries are in
// sweep_common.cuh.
//
// Without init the wrapper hands an uninitialised output and the kernel
// writes zeros into the columns of the blocks the plan does not list
// (sweep_common.cuh::clear_unlisted), so no separate fill streams the whole
// output once more before the sweep writes it (at the one-shard 96^3 plan a
// torch.zeros of 85 MB, 0.026 ms on an H100; PERF.md section 5).  The
// zeros are spread over the launch: its grid holds, per shard, a CTA for
// every kThreads-column chunk of every block, listed or not, beside one for
// every chunk of every entry, so a plan with long gaps (the boundary class,
// which at one shard lists a single block) clears them as fast as a fill.
// With init the output IS init (the reference aliases them, and checks
// that their dtypes agree): listed columns are seeded from it and rewritten
// in place, unlisted columns keep their values, the grid is one CTA per
// chunk of each entry, and nothing is zeroed.

#include "sweep_common.cuh"

namespace {

// Resident blocks per SM that ptxas is asked to allow for.  Measured on an
// H100 at the one-shard 96^3 shapes, in turns with the other settings:
// without the hint the zero-filled form took 0.167 ms and the init form
// 0.235 ms; with 5, 0.128 and 0.161 ms — the init form keeps its 96
// registers, so the gain is ptxas's schedule, not occupancy.  6 and 8 were
// slower (and make the init form spill).  The flux and reduced-precision
// instances keep the same hint (untuned).  The zero-filled gg forms' own
// zeros (clear_unlisted) took them from 64 to 71-72 registers, no spill;
// K1 alone went from 0.128 to 0.130 ms at the one-shard bulk plan, and the
// clear placed after the sweep took 72-80 registers at the same time.
constexpr int kMinBlocks = 5;

// CTA r of a shard's `span` (launch_packed): the zeros of chunk r of the
// unlisted blocks (zero-filled forms), then chunk r of the shard's entries
// where r < nb * chunks.  The init forms' span is nb * chunks: one CTA per
// chunk of each entry, blockIdx.x as sweep_chunk takes it.
template <bool kAccumulate, cfd::Op kOp, class S, class O, class V>
__device__ __forceinline__ void sweep_packed_cta(const cfd::SweepArgs<O, V>& a,
                                                 const S& s, int64_t span) {
  const int64_t shard = blockIdx.x / span, r = blockIdx.x % span;
  if constexpr (!kAccumulate) {
    cfd::clear_unlisted<cfd::op_rows(kOp)>(a, shard, r);
  }
  if (r < a.nb * a.chunks) {
    cfd::sweep_chunk<kAccumulate, kOp>(a, s, shard * a.nb * a.chunks + r);
  }
}

template <bool kAccumulate, cfd::Op kOp, class W, class S, class O>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_packed_kernel(cfd::SweepArgs<O> a, cfd::PackedSrc<W, S> s,
                    int64_t span) {
  sweep_packed_cta<kAccumulate, kOp>(a, s, span);
}

// K1 on a bf16 state (var16): the same body, the own values widened as
// they are loaded.  A kernel of its own, so that the f32-state instances
// keep their names and code.
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_packed_v16_kernel(cfd::SweepArgs<cfd::bf16, cfd::bf16> a,
                        cfd::PackedSrc<cfd::bf16, cfd::bf16> s,
                        int64_t span) {
  sweep_packed_cta<false, cfd::Op::kGG>(a, s, span);
}

// V: the state's element type; bf16 runs the var16 kernel (W, S and O are
// then bf16, gg, no init: checked by the entry point).
template <bool kAccumulate, cfd::Op kOp, class W, class S, class O,
          class V = float>
int launch_packed(const void* var_T, int64_t ndev, const void* srcs,
                  const void* slot_w, const float* scale,
                  const int32_t* block_ids, const int32_t* slots, int K,
                  int64_t P, int64_t nb, int64_t L, int bp, void* out,
                  cudaStream_t stream) {
  if (P == 0 || nb == 0) return 0;
  int64_t chunks = 0;
  cfd::sweep_grid(P, nb, bp, &chunks);
  // CTAs a shard: a chunk of each entry, and without init also one of each
  // block (sweep_packed_cta)
  const int64_t nblk = ndev / bp;
  const int64_t span = chunks * (kAccumulate || nb >= nblk ? nb : nblk);
  const int64_t grid = P * span;
  if (!cfd::sweep_args_ok(K, bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cfd::SweepArgs<O, V> a{static_cast<const V*>(var_T), ndev, scale,
                               block_ids, slots, K, nb, bp, chunks,
                               static_cast<O*>(out)};
  const cfd::PackedSrc<W, S> s{static_cast<const S*>(srcs),
                               static_cast<const W*>(slot_w), L};
  if constexpr (std::is_same<V, cfd::bf16>::value) {
    sweep_packed_v16_kernel
        <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(a, s,
                                                                    span);
  } else {
    sweep_packed_kernel<kAccumulate, kOp, W, S, O>
        <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(a, s,
                                                                    span);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as annotated in cfd::SweepArgs and cfd::PackedSrc, all contiguous
// on the current device; K <= 64; op as in cfd::op_ok; `out` has
// cfd::op_rows rows (3*NV gg, NV flux).  accumulate != 0: `out` holds init
// on entry.  w_bf16 / src_bf16d / out_bf16 != 0: slot_w is bf16, srcs holds
// bf16 deltas, out (and init) is bf16; else f32.  var_bf16 != 0: var_T is
// bf16, which only the gg op without init on bf16 weights, deltas and output
// takes (any other combination is refused before a launch).  Launches on
// `stream`; returns the launch's cudaError_t (0 = success).
extern "C" int cfd_sweep_packed(const void* var_T, int64_t ndev,
                                const void* srcs, const void* slot_w,
                                const float* scale, const int32_t* block_ids,
                                const int32_t* slots, int K, int64_t P,
                                int64_t nb, int64_t L, int bp, int accumulate,
                                int op, int w_bf16, int src_bf16d,
                                int out_bf16, int var_bf16, void* out,
                                cudaStream_t stream) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  if (var_bf16) {
    if (accumulate || op != 0 || !w_bf16 || !src_bf16d || !out_bf16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_packed<false, cfd::Op::kGG, cfd::bf16, cfd::bf16, cfd::bf16,
                         cfd::bf16>(var_T, ndev, srcs, slot_w, scale,
                                    block_ids, slots, K, P, nb, L, bp, out,
                                    stream);
  }
  const bool flags[] = {accumulate != 0, op == 1, w_bf16 != 0,
                        src_bf16d != 0, out_bf16 != 0};
  return cfd::with_flags(flags, [&](auto acc, auto flux, auto w16, auto d16,
                                    auto o16) {
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    return launch_packed<decltype(acc)::value, kOp,
                         cfd::Elt<decltype(w16)::value>,
                         cfd::Elt<decltype(d16)::value>,
                         cfd::Elt<decltype(o16)::value>>(
        var_T, ndev, srcs, slot_w, scale, block_ids, slots, K, P, nb, L, bp,
        out, stream);
  });
}
