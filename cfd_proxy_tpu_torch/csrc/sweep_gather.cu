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
// Four bodies, chosen by the wrapper (ops/blocksweep.py::gather_body) from
// (bp, EP) alone, by one fixed rule, where bp and EP are multiples of 4:
// the STAGED body where two blocks' staged tables fit one SM's shared
// memory, else the CLUSTER body where half the table fits one block
// (cfd::kStagedMaxSmem, 227 KB less the static slot table), else, for op
// gg, the QUAD body where a quarter of it does; else, and wherever bp or EP
// is not a multiple of 4, the DIRECT body.
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
//   It runs where two of its blocks fit one SM.
// - Cluster (sweep_common.cuh::sweep_entry_cluster): past 3 608 columns
//   (bp + EP; at 96^3 AUTO's bp 4096, EP 1920: 188 KB, and bp 8192, EP
//   2688: 340 KB) a cluster of two CUDA blocks per listed entry (launched
//   with the cluster attribute, cudaLaunchKernelEx) holds one float4 plane
//   each, cluster_bytes(bp, EP) = 16 B per column (94 KB at bp 4096: two
//   blocks of 256 threads per SM; 170 KB at bp 8192: one of 512;
//   blocksweep.cluster_threads).  The launch first asks the
//   runtime how many such clusters can be resident
//   (cudaOccupancyMaxActiveClusters) and refuses to launch if none can.
//   Each thread sweeps two neighbouring lanes (sweep_pairs_cluster), its
//   pairs one stream of slot items fetched two ahead; 109-128 registers,
//   no spill.  On an H100 at bp 8192 gg f32 took 0.139 ms at one lane a
//   thread (47 % of its bound; the direct body 0.306, 21 %) and takes
//   0.126 at two (52 %); the bf16 and flux instances 0.115-0.125 (35-48 %:
//   distributed shared memory reads and the slot stream set their pace,
//   PERF.md section 6); at AUTO's bp 4096 gg 0.138 at one lane a thread
//   (two blocks of 256 threads an SM; the staged body 0.186): the rule
//   takes it wherever two staged blocks do not fit one SM.
// - Quad (sweep_common.cuh::sweep_entry_quad): past 14 512 columns (at the
//   two-shard 96^3 plans at bp 8192: bp + EP 24 960 and 18 688) a cluster
//   of four CUDA blocks per listed entry, each staging two variables,
//   quad_bytes(bp, EP) = 8 B per column (195 and 146 KB: one block of
//   blocksweep.quad_threads an SM), up to about 29 000 columns.  gg is
//   split by variables (each block six output rows over every lane, four
//   lanes a thread, its own plane alone), flux by lanes (each block every
//   fourth 64-lane run, two lanes a thread, three planes through
//   distributed shared memory).  The launch refuses, as the cluster
//   body's does, where no cluster of four can be resident.  On an H100
//   (PERF.md section 6) gg took 0.156 ms on the two-shard bulk plan
//   (direct 0.309; 52 % of its bound; 102-116 registers, no spill, 30
//   resident clusters); flux 0.305 against direct 0.309 and 0.29 at one
//   shard against the cluster body's 0.117: its three remote planes take
//   about 74 % of its time (all-local reads: 0.076), so the rule keeps
//   flux on the direct body.
// - Direct (sweep_common.cuh::sweep_chunk_direct): no shared memory, so it
//   runs at any bp and EP.  The wrapper (blocksweep.gather_table) first
//   launches sweep_gather_table_kernel, which writes each listed entry's
//   own and live ext columns point-major into a device-memory table
//   (P, nb, bp + EP, NV), 16-byte stores, a warp 512 neighbouring bytes;
//   then one CUDA block of 128 threads per (shard, entry, 256 lanes)
//   sweeps, two lanes 32 apart a thread (each load and store of a warp one
//   row of 32 neighbouring elements, at any operand offset), each
//   thread's live slots one stream of items whose W-indices and weights
//   are fetched two items ahead, a slot lane's eight sources two 16-byte
//   loads of one sector of the table.  The table's bytes (written once,
//   read once) count in the kernel's time; its bound stays the sweep's
//   own, and chip_smoke.py::table_bound reports the one with the table's
//   bytes beside it (bound_ms_with_table).
//
// Bound: sweep_common.cuh's, with every table column read once per entry
// (chip_smoke.py::sweep_bound).  Registers: the accumulators (24 gg, 8
// flux), the 8 own values and the next slot's prefetched W-index and
// weights stay in registers.  The zero-filled staged forms ask ptxas for
// four resident blocks per SM, which fits them in 64 registers with no
// spill (left free, gg took 68 and three blocks, 7 % slower at the
// one-shard plan); the init forms ask for two and take 64-71, no spill,
// three blocks.  The direct kernel asks for four blocks under gg (two
// lanes' 48 accumulators and 16 own values in up to 128 registers) and
// five under flux (sweep_common.cuh::kDirectMinBlocks).  Both counts are
// in the build log (chip_smoke.py's build phase, chip_turns.py).
//
// Without init the wrapper hands an uninitialised output and the kernel
// writes zeros into the columns of blocks the plan does not list
// (sweep_common.cuh::clear_gaps; the block lists are ascending), so no
// separate fill streams the output once more.  With init the output IS init
// (the reference aliases them): listed columns are seeded from it and
// rewritten in place, unlisted columns keep their values.

#include "sweep_common.cuh"

namespace {

// The direct body's table build: threads a block, and float4 of an
// entry's own columns a thread (sets the blocks per entry).
constexpr int kTableThreads = 256;
constexpr int kTableQuads = 4;

// The staged body's CUDA block, and the resident blocks per SM ptxas is
// asked to allow for: four for the zero-filled forms (64 registers), two
// for the init forms (which take 64-71, three blocks per SM).
constexpr int kStagedThreads = 256;
constexpr int kStagedMinBlocks = 4;
constexpr int kStagedInitMinBlocks = 2;

template <bool kAccumulate, cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kThreads, cfd::kDirectMinBlocks<kOp>)
sweep_gather_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                    const float4* tbl) {
  if constexpr (!kAccumulate) {     // this block's lanes of unlisted blocks
    cfd::clear_gaps<cfd::op_rows(kOp)>(
        a, blockIdx.x / a.chunks,
        static_cast<int>((blockIdx.x % a.chunks) * cfd::kThreads) +
            static_cast<int>(threadIdx.x),
        static_cast<int>(a.chunks) * cfd::kThreads);
  }
  cfd::sweep_chunk_direct<kAccumulate, kOp>(a, s, tbl, blockIdx.x);
}

__global__ void __launch_bounds__(kTableThreads)
sweep_gather_table_kernel(const float* var_T, int64_t ndev, const float* exts,
                          int64_t ep, const int32_t* block_ids,
                          const int32_t* ext_cnt, int64_t nb, int bp,
                          int64_t splits, float4* tbl) {
  cfd::gather_table_part(var_T, ndev, exts, ep, block_ids, ext_cnt, nb, bp,
                         splits, tbl, blockIdx.x);
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
__global__ void __launch_bounds__(cfd::kClusterMaxThreads, 1)
sweep_gather_cluster_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                            const int32_t* ext_cnt) {
  const int64_t g = blockIdx.x / cfd::kClusterCtas;   // one entry a cluster
  if constexpr (!kAccumulate) {   // the cluster's blocks split the gaps
    const int rank = static_cast<int>(blockIdx.x % cfd::kClusterCtas);
    cfd::clear_gaps<cfd::op_rows(kOp)>(
        a, g, rank * static_cast<int>(blockDim.x) + threadIdx.x,
        cfd::kClusterCtas * blockDim.x);
  }
  cfd::sweep_entry_cluster<kAccumulate, kOp>(a, s, ext_cnt, g);
}

// The quad body (sweep_common.cuh::sweep_entry_quad): four CUDA blocks a
// listed entry, one block an SM at the plans that take it.
template <bool kAccumulate, cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kClusterMaxThreads, 1)
sweep_gather_quad_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                         const int32_t* ext_cnt) {
  const int64_t g = blockIdx.x / cfd::kQuadCtas;      // one entry a cluster
  if constexpr (!kAccumulate) {   // the cluster's blocks split the gaps
    const int rank = static_cast<int>(blockIdx.x % cfd::kQuadCtas);
    cfd::clear_gaps<cfd::op_rows(kOp)>(
        a, g, rank * static_cast<int>(blockDim.x) + threadIdx.x,
        cfd::kQuadCtas * blockDim.x);
  }
  cfd::sweep_entry_quad<kAccumulate, kOp>(a, s, ext_cnt, g);
}

template <bool kAccumulate, cfd::Op kOp, class W, class O>
int launch_gather(const float* var_T, int64_t ndev, const float* exts,
                  int64_t ep, const int32_t* slot_idx, const void* slot_w,
                  const float* scale, const int32_t* block_ids,
                  const int32_t* slots, int K, int64_t P, int64_t nb, int bp,
                  const int32_t* ext_cnt, const void* tbl, int body,
                  int threads, void* out, cudaStream_t stream) {
  if (P == 0 || nb == 0) return 0;
  int64_t chunks = 0;
  const int64_t grid = cfd::direct_grid(P, nb, bp, &chunks);
  if (!cfd::sweep_args_ok(K, bp, grid) || ep <= 0 ||
      reinterpret_cast<uintptr_t>(tbl) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cfd::SweepArgs<O> a{var_T, ndev, scale, block_ids, slots, K, nb, bp,
                            chunks, static_cast<O*>(out)};
  const cfd::GatherSrc<W> s{exts, slot_idx, static_cast<const W*>(slot_w),
                            ep};
  if (body == cfd::kDirect) {
    sweep_gather_kernel<kAccumulate, kOp, W, O>
        <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(
            a, s, static_cast<const float4*>(tbl));
    return static_cast<int>(cudaGetLastError());
  }
  if (body == cfd::kCluster) {
    static bool raised = false;
    static cfd::Residency resident;
    return cfd::launch_cluster(
        sweep_gather_cluster_kernel<kAccumulate, kOp, W, O>, &raised,
        &resident, bp, ep, 0, P * nb, threads, stream, a, s, ext_cnt);
  }
  if (body == cfd::kQuad) {
    static bool raised = false;
    static cfd::Residency resident;
    return cfd::launch_cluster<cfd::kQuadCtas>(
        sweep_gather_quad_kernel<kAccumulate, kOp, W, O>, &raised,
        &resident, bp, ep, 0, P * nb, threads, stream, a, s, ext_cnt);
  }
  if (body != cfd::kStaged) return static_cast<int>(cudaErrorInvalidValue);
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
// gather tables are rectangular).  body (enum cfd::Body): kStaged (bp and ep
// multiples of 4, var_T and exts 16-byte aligned, cfd::staged_bytes(bp, ep)
// within a block's shared memory) and kCluster (the same, with
// cfd::cluster_bytes(bp, ep) within it, `threads` a multiple of 32 up to
// cfd::kClusterMaxThreads) and kQuad (the same with cfd::quad_bytes, and
// slot_idx, slot_w, scale and out aligned to cfd::kQuadLanesGG elements for
// gg, cfd::kQuadLanesFlux for flux)
// read ext_cnt (P, nb) i32, each entry's live ext columns, every live
// slot_idx below bp + ext_cnt (null: ep for every entry); kDirect reads
// neither ext_cnt nor `threads`.  accumulate != 0:
// `out` holds init on entry.  w_bf16 / out_bf16 != 0: slot_w / out (and
// init) are bf16; else f32.  Launches on `stream`; returns the launch's
// cudaError_t (0 = success; cudaErrorInvalidConfiguration when no cluster
// of the cluster or quad body can be resident).
extern "C" int cfd_sweep_gather(const float* var_T, int64_t ndev,
                                const float* exts, int64_t ep,
                                const int32_t* slot_idx, const void* slot_w,
                                const float* scale, const int32_t* block_ids,
                                const int32_t* slots, int K, int64_t P,
                                int64_t nb, int bp, const int32_t* ext_cnt,
                                const void* tbl, int body, int accumulate,
                                int op, int w_bf16, int out_bf16, int threads,
                                void* out, cudaStream_t stream) {
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
        P, nb, bp, ext_cnt, tbl, body, threads, out, stream);
  });
}

// The direct body's table of P*nb entries (cfd::table_floats floats at
// `tbl`, 16-byte aligned) from var_T (P, NV, ndev) and exts (P, nb, NV,
// ep) as cfd_sweep_gather takes them, each entry's own columns and its
// ext_cnt live ext columns (null: all ep).  Launches on `stream`; returns
// the launch's cudaError_t.
extern "C" int cfd_gather_table(const float* var_T, int64_t ndev,
                                const float* exts, int64_t ep,
                                const int32_t* block_ids,
                                const int32_t* ext_cnt, int64_t P,
                                int64_t nb, int bp, void* tbl,
                                cudaStream_t stream) {
  if (P == 0 || nb == 0) return 0;
  // blocks an entry: its own columns kTableQuads float4 a thread; the
  // live ext columns continue the same blocks' stride
  const int64_t per = static_cast<int64_t>(kTableThreads) * kTableQuads;
  const int64_t splits = (2 * static_cast<int64_t>(bp) + per - 1) / per;
  const int64_t grid = P * nb * splits;
  if (bp <= 0 || ep <= 0 || grid > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(tbl) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sweep_gather_table_kernel<<<static_cast<unsigned>(grid), kTableThreads, 0,
                              stream>>>(var_T, ndev, exts, ep, block_ids,
                                        ext_cnt, nb, bp, splits,
                                        static_cast<float4*>(tbl));
  return static_cast<int>(cudaGetLastError());
}

// Registers and local bytes per thread (spills and stack), static shared
// bytes and resident blocks per SM at `smem` bytes of dynamic shared memory
// (and, the cluster and quad bodies, `threads` threads a block) of one K2
// instance (body, init form, op and dtype flags as in cfd_sweep_gather),
// into out[0..4]; the cluster and quad bodies also the clusters that can
// be resident at once into out[4] (else 0).  Returns the cudaError_t.
extern "C" int cfd_sweep_gather_info(int body, int accumulate, int op,
                                     int w_bf16, int out_bf16, int smem,
                                     int threads, int* out) {
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
    out[4] = 0;
    auto info = [&](auto kernel, int block, int dyn) {
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
          out + 3, kernel, block, dyn));
    };
    if (body == cfd::kStaged) {
      return info(sweep_gather_staged_kernel<kAcc, kOp, W, O>,
                  kStagedThreads, smem);
    }
    if (body == cfd::kCluster) {
      const auto kernel = sweep_gather_cluster_kernel<kAcc, kOp, W, O>;
      const int e = info(kernel, threads, smem);
      if (e != 0) return e;
      return static_cast<int>(
          cfd::resident_clusters(kernel, threads, smem, out + 4));
    }
    if (body == cfd::kQuad) {
      const auto kernel = sweep_gather_quad_kernel<kAcc, kOp, W, O>;
      const int e = info(kernel, threads, smem);
      if (e != 0) return e;
      return static_cast<int>(cfd::resident_clusters(
          kernel, threads, smem, out + 4, cfd::kQuadCtas));
    }
    return info(sweep_gather_kernel<kAcc, kOp, W, O>, cfd::kThreads, 0);
  });
}

// The same facts of the direct body's table build (out[4] = 0).
extern "C" int cfd_gather_table_info(int* out) {
  cudaFuncAttributes f;
  const cudaError_t e = cudaFuncGetAttributes(&f, sweep_gather_table_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = f.numRegs;
  out[1] = static_cast<int>(f.localSizeBytes);
  out[2] = static_cast<int>(f.sharedSizeBytes);
  out[4] = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, sweep_gather_table_kernel, kTableThreads, 0));
}
