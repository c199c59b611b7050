// K2: block sweep, GATHER formulation, over P shards in one launch; ops
// "gg" and "flux" (the entry point's `op`), f32 or bf16 weights, f32 or
// bf16 output.
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::sweep_blocks, gather branch
// (body _block_compute, with _masked_gather; its gg body :416-419 and its
// flux body :420-426), with and without `init`, with slot_w f32 or bf16
// and out_dtype f32 or bf16 (the sources are the f32 state: the reference
// takes bf16 sources with the packed formulation only).  The sources are
// gathered inside the sweep from the block table [own ‖ exts] by the
// W-index, so a state update rebuilds only the small per-block ext tables
// (gather_exts) instead of re-packing every slot's sources (K4).  The
// per-thread arithmetic, the precisions, the W-index and the handling of
// pad entries are in sweep_common.cuh.
//
// Two bodies, chosen by the wrapper (ops/blocksweep.py::gather_body) from
// (bp, EP) alone, by one fixed rule: the STAGED body where bp and EP are
// multiples of 4 and the staged table fits one CUDA block's shared memory
// (cfd::kStagedMaxSmem, 227 KB less the static slot table), else the
// DIRECT body.
//
// - Staged (sweep_common.cuh::sweep_entry_staged): one CUDA block of
//   kStagedThreads per listed (shard, entry), two lanes per thread at bp
//   512.  Layout: the entry's table, own columns var_T[p, :, base : base +
//   bp] then its live ext columns exts[p, b, :, :ext_cnt], column-major in
//   two float4 planes (variables 0-3 and 4-7 of a column one 16-byte word
//   each), so a slot lane resolves its eight sources with two 16-byte
//   shared loads by its W-index; the table is filled with 16-byte coalesced
//   loads along each variable row, transposed in registers.  Budget:
//   staged_bytes(bp, EP) = 32 B per column of dynamic shared memory (the
//   padded EP sizes it, the live count decides what is loaded): 32 KB at
//   the one-shard 96^3 plan at bp 512 (EP 512), 48 and 56 KB at eight
//   shards (EP 1024, 1280).  The first launch of an instance raises its
//   dynamic shared memory limit (past 48 KB in all, the static slot table
//   included, a launch needs it).  Measured on an H100 (PERF.md section 6):
//   a row-major table (eight 4-byte shared loads per slot lane) was 5-9 %
//   slower, 128-thread blocks 26 % slower on the eight-shard bulk plan
//   (half the warps per SM at its 56 KB table).
//   The staged body wins wherever it fits: at the one-shard plan at AUTO's
//   bp 4096 (EP 1920, a 188 KB table, one CUDA block per SM) it took 0.186
//   ms against the direct body's 0.250.
// - Direct (sweep_chunk with GatherSrc): one CUDA block of 128 threads per
//   (shard, entry, 128-lane chunk), sources read from device memory; no
//   shared memory, so it runs at any bp: where bp + EP passes 7 256
//   columns (bp 8192 at 96^3) it is the only body.
//
// Bound: sweep_common.cuh's, with every table column read once per entry
// (chip_smoke.py::sweep_bound).  Registers: the accumulators (24 gg, 8
// flux), the 8 own values and the next slot's prefetched W-index and
// weights stay in registers.  The zero-filled forms ask ptxas for four
// resident blocks per SM, which fits them in 64 registers with no spill
// (left free, gg took 68 and three blocks, 7 % slower at the one-shard
// plan); the init forms ask for two and take 64-71, no spill, three
// blocks.  The direct kernel keeps K1's hint (five blocks; 96 registers
// and 8 bytes of spill for gg-init).  Both counts are in the build log
// (chip_smoke.py's build phase, chip_turns.py).
//
// Without init the wrapper hands an uninitialised output and the kernel
// writes zeros into the columns of blocks the plan does not list
// (sweep_common.cuh::clear_gaps; the block lists are ascending), so no
// separate fill streams the output once more.  With init the output IS init
// (the reference aliases them): listed columns are seeded from it and
// rewritten in place, unlisted columns keep their values.

#include "sweep_common.cuh"

namespace {

// Resident blocks per SM that ptxas is asked to allow for: K1's value (see
// sweep_packed.cu), kept for the same body and for the flux and
// reduced-precision instances.
constexpr int kMinBlocks = 5;

// The staged body's CUDA block, and the resident blocks per SM ptxas is
// asked to allow for: four for the zero-filled forms (64 registers), two
// for the init forms (which take 64-71, three blocks per SM).
constexpr int kStagedThreads = 256;
constexpr int kStagedMinBlocks = 4;
constexpr int kStagedInitMinBlocks = 2;

template <bool kAccumulate, cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_gather_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s) {
  if constexpr (!kAccumulate) {     // this chunk's lane of unlisted blocks
    cfd::clear_gaps<cfd::op_rows(kOp)>(
        a, blockIdx.x / a.chunks,
        static_cast<int>((blockIdx.x % a.chunks) * cfd::kThreads) +
            static_cast<int>(threadIdx.x),
        a.bp);
  }
  cfd::sweep_chunk<kAccumulate, kOp>(a, s, blockIdx.x);
}

template <bool kAccumulate, cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(kStagedThreads,
                                  kAccumulate ? kStagedInitMinBlocks
                                              : kStagedMinBlocks)
sweep_gather_staged_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                           const int32_t* ext_cnt) {
  if constexpr (!kAccumulate) {
    cfd::clear_gaps<cfd::op_rows(kOp)>(a, blockIdx.x, threadIdx.x,
                                       blockDim.x);
  }
  cfd::sweep_entry_staged<kAccumulate, kOp>(a, s, ext_cnt, blockIdx.x);
}

template <bool kAccumulate, cfd::Op kOp, class W, class O>
int launch_gather(const float* var_T, int64_t ndev, const float* exts,
                  int64_t ep, const int32_t* slot_idx, const void* slot_w,
                  const float* scale, const int32_t* block_ids,
                  const int32_t* slots, int K, int64_t P, int64_t nb, int bp,
                  const int32_t* ext_cnt, int staged, void* out,
                  cudaStream_t stream) {
  if (P == 0 || nb == 0) return 0;
  int64_t chunks = 0;
  const int64_t grid = cfd::sweep_grid(P, nb, bp, &chunks);
  if (!cfd::sweep_args_ok(K, bp, grid) || ep <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cfd::SweepArgs<O> a{var_T, ndev, scale, block_ids, slots, K, nb, bp,
                            chunks, static_cast<O*>(out)};
  const cfd::GatherSrc<W> s{exts, slot_idx, static_cast<const W*>(slot_w),
                            ep};
  if (!staged) {
    sweep_gather_kernel<kAccumulate, kOp, W, O>
        <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(a, s);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = sweep_gather_staged_kernel<kAccumulate, kOp, W, O>;
  static bool raised = false;
  int64_t smem = 0;
  if (!cfd::staged_launch_ok(kernel, &raised, bp, ep, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(P * nb), kStagedThreads,
           static_cast<size_t>(smem), stream>>>(a, s, ext_cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as annotated in cfd::SweepArgs and cfd::GatherSrc, all contiguous
// on the current device; K <= 64; every slot_idx in [0, bp + ep) (checked
// where the plan is loaded); op as in cfd::op_ok; `out` has cfd::op_rows
// rows.  `slots` holds the per-slot widths (its offset row is not read: the
// gather tables are rectangular).  staged != 0: the staged body (bp and ep
// multiples of 4, var_T and exts 16-byte aligned, cfd::staged_bytes(bp, ep)
// within a block's shared memory), which reads ext_cnt (P, nb) i32, each
// entry's live ext columns, every live slot_idx below bp + ext_cnt (null:
// ep for every entry); staged == 0: the direct body (ext_cnt not read).
// accumulate != 0: `out` holds init on entry.  w_bf16 / out_bf16 != 0:
// slot_w / out (and init) are bf16; else f32.  Launches on `stream`;
// returns the launch's cudaError_t (0 = success).
extern "C" int cfd_sweep_gather(const float* var_T, int64_t ndev,
                                const float* exts, int64_t ep,
                                const int32_t* slot_idx, const void* slot_w,
                                const float* scale, const int32_t* block_ids,
                                const int32_t* slots, int K, int64_t P,
                                int64_t nb, int bp, const int32_t* ext_cnt,
                                int staged, int accumulate, int op,
                                int w_bf16, int out_bf16, void* out,
                                cudaStream_t stream) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  const bool flags[] = {accumulate != 0, op == 1, w_bf16 != 0,
                        out_bf16 != 0};
  return cfd::with_flags(flags, [&](auto acc, auto flux, auto w16,
                                    auto o16) {
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    return launch_gather<decltype(acc)::value, kOp,
                         cfd::Elt<decltype(w16)::value>,
                         cfd::Elt<decltype(o16)::value>>(
        var_T, ndev, exts, ep, slot_idx, slot_w, scale, block_ids, slots, K,
        P, nb, bp, ext_cnt, staged, out, stream);
  });
}

// Registers and local bytes per thread (spills and stack), static shared
// bytes and resident blocks per SM at `smem` bytes of dynamic shared memory
// of one K2 instance (body, init form, op and dtype flags as in
// cfd_sweep_gather), into out[0..4].  Returns the cudaError_t.
extern "C" int cfd_sweep_gather_info(int staged, int accumulate, int op,
                                     int w_bf16, int out_bf16, int smem,
                                     int* out) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  const bool flags[] = {accumulate != 0, op == 1, w_bf16 != 0,
                        out_bf16 != 0};
  return cfd::with_flags(flags, [&](auto acc, auto flux, auto w16,
                                    auto o16) {
    constexpr bool kAcc = decltype(acc)::value;
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    using W = cfd::Elt<decltype(w16)::value>;
    using O = cfd::Elt<decltype(o16)::value>;
    auto info = [&](auto kernel, int threads, int dyn) {
      cudaFuncAttributes f;
      cudaError_t e = cudaFuncGetAttributes(&f, kernel);
      if (e != cudaSuccess) return static_cast<int>(e);
      out[0] = f.numRegs;
      out[1] = static_cast<int>(f.localSizeBytes);
      out[2] = static_cast<int>(f.sharedSizeBytes);
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          cfd::kStagedMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out + 3, kernel, threads, dyn));
    };
    if (staged) {
      return info(sweep_gather_staged_kernel<kAcc, kOp, W, O>,
                  kStagedThreads, smem);
    }
    return info(sweep_gather_kernel<kAcc, kOp, W, O>, cfd::kThreads, 0);
  });
}
