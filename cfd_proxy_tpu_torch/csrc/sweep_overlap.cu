// K3: fused interior sweep + halo push, P shards on one card, one launch,
// in both formulations (packed: the K1 body; gather: the K2 body), both ops
// (gg and flux: the entry point's `op`) and every precision of those bodies.
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::sweep_blocks_overlap (ops "gg"
// and "flux"; packed compact and gather bodies, :744-747; src_format,
// slot_w and out_dtype as in K1/K2; send buffers in f32 or, under the
// reference's halo_dtype bfloat16, bf16) — the GASPI write-notify analogue.
// On the TPU the kernel starts one make_async_remote_copy per
// phase at its first grid step, sweeps the interior blocks (K1 or K2
// accumulating onto the boundary result) while the copies fly, and waits
// for them at its last step.  Here a "remote" device is another shard, and
// the kernel has two forms, by where that shard's receive buffer lives:
//
//     recv[dsts[p, k], k] = sendbufs[p, k]       (rows x s_max elements)
//     grad[p]             = K1/K2-accumulate of the interior plan onto init[p]
//
// The first CUDA blocks of the grid do the pushes (the block scheduler
// hands out low indices first, so the copies start first, as the
// reference's do); the rest run the interior sweep (sweep_common.cuh): in
// the gather forms, the body ops/blocksweep.py::gather_body picks for the
// fused kernel, by K2's rule: staged where two staged tables fit one SM,
// one sweep block per listed entry with its table in the launch's dynamic
// shared memory (which the push blocks are given too and leave unused);
// past that the cluster body where half the table fits one block, a
// cluster of two CUDA blocks per entry (sweep_overlap_cluster_kernel: the
// push region padded to whole clusters); past that, for gg, the quad body
// where a quarter fits, a cluster of four (sweep_overlap_quad_kernel, the
// region padded to whole clusters of four: 0.160 ms against direct 0.320
// at the two-shard 96^3 interior plan at bp 8192 on an H100; its flux form
// lost to direct there, 0.314 against 0.285); else direct
// (sweep_overlap_direct_kernel: K2's direct body in the sweep blocks, the
// wrapper building its point-major table before the launch where
// blocksweep.direct_sources says so).  The flux form keeps the direct
// body where the rule says staged: the staged one took 1.0035x the time
// of an earlier direct body (one lane a thread, six blocks an SM) in
// turns at the eight-shard 96^3 interior plan at bp 512 on an H100, where
// its four 128-thread blocks per SM leave the flux body (8 accumulators,
// little work per load) short; the present direct body took 0.84x of
// that one's time there (PERF.md section 6).  The
// push is a copy of bytes, so one body serves f32 and bf16 buffers: each
// (shard, phase) buffer is rows*s_max*esize bytes, moved in 16-byte pieces.
//
// The loopback form (cfd_sweep_overlap, cfd_sweep_overlap_gather): all P
// shards in one process on one card, `recv` a buffer of this launch alone
// (zero-filled by the wrapper), indexed by `dsts`.  The send buffers are
// written by the pack, which runs earlier on the same stream, and nothing
// else can touch `recv` while the launch runs, so this form needs neither
// the reference's readiness barrier nor its arrival waits.
//
// The peer form (cfd_sweep_overlap_peer, cfd_sweep_overlap_gather_peer):
// the shards are spread over processes (ranks), each on its own card or
// several on one.  `recv` lives as long as the model, so that another rank
// can map it once (CUDA IPC, parallel/transport.py::Peer), and a push goes
// to an ADDRESS taken from a table: this rank's memory or a peer's.  A
// persistent buffer brings back the reference's reason for its barrier (a
// push may not land while the receiver still reads last step's buffer) and
// for its waits (nothing may read recv before the push has landed), so this
// form runs the whole protocol: readiness signals, the wait before the
// first store, arrival flags, and the wait for them by the block that
// draws the launch's last exit ticket.  push_common.cuh holds that device
// code (K6, push_bench.cu, runs the same) and says why no launch can
// deadlock and how every wait is bounded.  Its `mode` argument carries the
// reference's kernel debug rungs: no barrier ("nobar"), neither barrier nor
// copy ("nodma").
//
// `recv` is kept apart from the gradient array on purpose, in both forms:
// the interior sweep writes the ghost columns of listed blocks (with zero
// scale), so a push straight into the ghost region would race with it.  The
// step copies `recv` into the ghost regions after the kernel, as the
// reference does.
//
// Bound: memory.  The sweep streams as K1/K2 with init; the push reads and
// writes rows*s_max*esize bytes per (shard, phase), a few percent of the
// sweep's bytes at the benchmark sizes, with 16-byte coalesced copies.
// rows is the op's output row count (3*NV gg, NV flux).  The staged gather
// form runs four 128-thread blocks per SM at the eight-shard tables, half
// the warps K2's 256-thread blocks keep, so it gains less than K2 (PERF.md
// section 6).  The cluster form runs K2's cluster body at its threads
// (blocksweep.cluster_threads: 256 at the one-shard plan at AUTO's bp 4096,
// two blocks an SM; 512 at bp 8192 and at the two-shard plan at bp 4096,
// one), its push blocks at the same.  On an H100 it took about 0.16 ms at
// the one-shard 96^3 interior plan at bp 4096 (the one-block staged body
// 0.33) and at bp 8192 (direct 0.32), 56 % of its bound.

#include "push_common.cuh"
#include "sweep_common.cuh"

namespace {

constexpr int64_t kPushBytes = 16;                         // uint4 per thread
constexpr int64_t kPushChunk = cfd::kThreads * 4;          // uint4s per block

struct PushArgs {
  const uint4* sendbufs;    // (P, nph, rows, s_max) elements of esize bytes
  const int32_t* dsts;      // (P, nph) destination shard per phase
  int64_t nph;
  int64_t seg;              // 16-byte pieces per (shard, phase) buffer
  int64_t chunks;           // push blocks per (shard, phase)
  int64_t blocks;           // push blocks in all: P*nph*chunks
  uint4* recv;              // (P, nph, rows, s_max), zero-filled
};

__device__ __forceinline__ void push_chunk(const PushArgs& p, int64_t blk) {
  const int64_t pk = blk / p.chunks;                  // flat (shard, phase)
  const int64_t k = pk % p.nph;
  const int64_t dst = p.dsts[pk];
  const uint4* src = p.sendbufs + pk * p.seg;
  uint4* to = p.recv + (dst * p.nph + k) * p.seg;
  const int64_t lo = (blk % p.chunks) * kPushChunk;
  const int64_t hi = lo + kPushChunk < p.seg ? lo + kPushChunk : p.seg;
  for (int64_t j = lo + threadIdx.x; j < hi; j += cfd::kThreads) {
    to[j] = __ldg(src + j);
  }
}

// Resident blocks per SM that ptxas is asked to allow for (see
// sweep_packed.cu).  Measured on an H100 at the one-shard 96^3 shapes, in
// turns: no hint 0.240 ms, 5 0.243 ms, 6 0.190 ms, 8 0.241 ms.
// The packed flux and reduced-precision instances keep the same hint
// (untuned); the gather forms' direct sweep blocks run kernels of their
// own (sweep_overlap_direct_kernel, below).
constexpr int kMinBlocks = 6;

template <cfd::Op kOp, class Src, class O>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_overlap_kernel(cfd::SweepArgs<O> a, Src s, PushArgs p) {
  if (static_cast<int64_t>(blockIdx.x) < p.blocks) {
    push_chunk(p, blockIdx.x);
    return;
  }
  cfd::sweep_chunk<true, kOp>(a, s, blockIdx.x - p.blocks);
}

// The gather forms' direct sweep blocks (sweep_common.cuh::
// sweep_chunk_direct: kDirectChunk lanes of one entry a block, two lanes a
// thread, sources from the table `tbl` or, null, from var_T and exts) after
// the push blocks.  Resident blocks per SM asked of ptxas as K2's direct
// instances (sweep_common.cuh::kDirectMinBlocks): four for gg, five for
// flux.

template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kThreads, cfd::kDirectMinBlocks<kOp>)
sweep_overlap_direct_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                            const float4* tbl, PushArgs p) {
  if (static_cast<int64_t>(blockIdx.x) < p.blocks) {
    push_chunk(p, blockIdx.x);
    return;
  }
  cfd::sweep_chunk_direct<true, kOp>(a, s, tbl, blockIdx.x - p.blocks);
}

// The gather forms' staged sweep blocks: one per listed entry
// (sweep_common.cuh::sweep_entry_staged), of kThreads like the push blocks
// (the push code is written for them); the launch's dynamic shared memory
// holds one staged table per block.  Resident blocks per SM asked of
// ptxas: the staged table (48 KB at the eight-shard 96^3 interior plan at
// bp 512) admits four, so the sweep keeps up to 128 registers (it takes
// 66-80) and spills nothing, where the first direct body (one lane a
// thread) at six blocks spilled 80 bytes.  The push blocks' waits drain
// at any occupancy a staged table leaves (push_common.cuh).
constexpr int kStagedMinBlocks = 4;

template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kThreads, kStagedMinBlocks)
sweep_overlap_staged_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                            const int32_t* ext_cnt, PushArgs p) {
  if (static_cast<int64_t>(blockIdx.x) < p.blocks) {
    push_chunk(p, blockIdx.x);
    return;
  }
  cfd::sweep_entry_staged<true, kOp>(a, s, ext_cnt, blockIdx.x - p.blocks);
}

// The cluster gather body's CUDA blocks (sweep_common.cuh::
// sweep_entry_cluster), and the push blocks that share its launch.  Every
// CUDA block of a cluster launch belongs to a cluster of kClusterCtas, so
// the push region is padded to an even number of blocks (`region`, the
// pad block returns at once): blocks region + 2g and region + 2g + 1 are
// entry g's cluster, whose block rank is blockIdx.x % 2.  The push blocks
// run at the cluster's threads and carry its dynamic shared memory, which
// they leave unused; their first kThreads threads copy a chunk as the
// one-block forms' push blocks do, and the rest return.  Fewer, wider
// chunks (all of a block's threads copying) timed within 1.2 % of this
// on an H100, neither ahead (PERF.md section 6).  ptxas is asked for one
// resident block per SM (up to 128 registers at 512 threads).
template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kClusterMaxThreads, 1)
sweep_overlap_cluster_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                             const int32_t* ext_cnt, PushArgs p,
                             int64_t region) {
  const int64_t blk = blockIdx.x;
  if (blk < region) {
    if (blk < p.blocks && threadIdx.x < cfd::kThreads) push_chunk(p, blk);
    return;
  }
  cfd::sweep_entry_cluster<true, kOp>(a, s, ext_cnt,
                                      (blk - region) / cfd::kClusterCtas);
}

// The quad gather body's CUDA blocks (sweep_common.cuh::sweep_entry_quad)
// and the push blocks that share its launch: sweep_overlap_cluster_kernel
// with clusters of kQuadCtas, the push region padded to a multiple of
// four blocks (the pad blocks return at once), entry g's cluster the
// blocks region + 4g .. region + 4g + 3, of rank blockIdx.x % 4.
template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kClusterMaxThreads, 1)
sweep_overlap_quad_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                          const int32_t* ext_cnt, PushArgs p,
                          int64_t region) {
  const int64_t blk = blockIdx.x;
  if (blk < region) {
    if (blk < p.blocks && threadIdx.x < cfd::kThreads) push_chunk(p, blk);
    return;
  }
  cfd::sweep_entry_quad<true, kOp>(a, s, ext_cnt,
                                   (blk - region) / cfd::kQuadCtas);
}

// A gather launch's body (cfd::Body), the live ext counts the staged,
// cluster and quad bodies read, and the cluster or quad body's threads.
struct GatherLaunch {
  const int32_t* ext_cnt;   // (P, nb) live ext columns, or null
  int body;
  int threads;              // the cluster or quad body's block, >= kThreads
  const float4* tbl;        // the direct body's table, or null
};

// CUDA blocks of one cluster of a gather launch's body: 2 (cluster), 4
// (quad), else 1.
inline int64_t body_ctas(int body) {
  return body == cfd::kCluster ? cfd::kClusterCtas
         : body == cfd::kQuad  ? cfd::kQuadCtas
                               : 1;
}

// `blocks` padded up to whole clusters of `ctas` blocks.
inline int64_t whole_clusters(int64_t blocks, int64_t ctas) {
  return blocks + (ctas - blocks % ctas) % ctas;
}

// The gather fetch policy, and its weight type.
template <class Src>
struct IsGather : std::false_type {};
template <class WT>
struct IsGather<cfd::GatherSrc<WT>> : std::true_type {
  using W = WT;
};

// The sweep blocks of a launch of one instance: a gather body's (one a
// staged entry, ctas a cluster entry, kDirectChunk lanes a direct block),
// else sweep_chunk's; sets a->chunks where the body reads it.
template <class Src, class O>
int64_t sweep_blocks_of(cfd::SweepArgs<O>* a, int64_t P, int body,
                        int64_t ctas) {
  if (body == cfd::kStaged) return P * a->nb;
  if (ctas > 1) return ctas * P * a->nb;
  return IsGather<Src>::value ? cfd::direct_grid(P, a->nb, a->bp, &a->chunks)
                              : cfd::sweep_grid(P, a->nb, a->bp, &a->chunks);
}

// Checks the push shape, sizes the grid and launches one instance: the
// staged, cluster, quad or direct gather body as `st.body` says (Src a
// GatherSrc), else sweep_chunk.
template <cfd::Op kOp, class Src, class O>
int launch_overlap(cfd::SweepArgs<O> a, int64_t P, const Src& s,
                   const void* sendbufs, int esize, const int32_t* dsts,
                   int64_t nph, int64_t s_max, void* recv,
                   cudaStream_t stream,
                   GatherLaunch st = {nullptr, cfd::kDirect, 0, nullptr}) {
  const int64_t ctas = body_ctas(st.body);
  if (ctas > 1 && st.threads < cfd::kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t sweep_blocks = sweep_blocks_of<Src>(&a, P, st.body, ctas);
  const int64_t row_bytes = s_max * esize;
  if ((esize != 2 && esize != 4) || row_bytes % kPushBytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t seg = cfd::op_rows(kOp) * row_bytes / kPushBytes;
  const int64_t push_chunks = (seg + kPushChunk - 1) / kPushChunk;
  const int64_t push_blocks = P * nph * push_chunks;
  const int64_t region = whole_clusters(push_blocks, ctas);
  const int64_t grid = region + sweep_blocks;
  if (grid == 0) return 0;
  if (!cfd::sweep_args_ok(a.K, a.bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PushArgs p{static_cast<const uint4*>(sendbufs), dsts, nph, seg,
                   push_chunks, push_blocks, static_cast<uint4*>(recv)};
  if constexpr (IsGather<Src>::value) {
    using W = typename IsGather<Src>::W;
    if (st.body == cfd::kCluster) {
      static bool raised = false;
      static cfd::Residency resident;
      return cfd::launch_cluster(
          sweep_overlap_cluster_kernel<kOp, W, O>, &raised, &resident, a.bp,
          s.ep, region, P * a.nb, st.threads, stream, a, s, st.ext_cnt, p,
          region);
    }
    if (st.body == cfd::kQuad) {
      static bool raised = false;
      static cfd::Residency resident;
      return cfd::launch_cluster<cfd::kQuadCtas>(
          sweep_overlap_quad_kernel<kOp, W, O>, &raised, &resident, a.bp,
          s.ep, region, P * a.nb, st.threads, stream, a, s, st.ext_cnt, p,
          region);
    }
    if (st.body == cfd::kStaged) {
      const auto kernel = sweep_overlap_staged_kernel<kOp, W, O>;
      static bool raised = false;
      int64_t smem = 0;
      if (!cfd::staged_launch_ok(kernel, &raised, a.bp, s.ep, &smem)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      kernel<<<static_cast<unsigned>(grid), cfd::kThreads,
               static_cast<size_t>(smem), stream>>>(a, s, st.ext_cnt, p);
      return static_cast<int>(cudaGetLastError());
    }
    sweep_overlap_direct_kernel<kOp, W, O><<<static_cast<unsigned>(grid),
                                             cfd::kThreads, 0, stream>>>(
        a, s, st.tbl, p);
  } else {
    sweep_overlap_kernel<kOp, Src, O><<<static_cast<unsigned>(grid),
                                        cfd::kThreads, 0, stream>>>(a, s, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The peer form: block 0 signals readiness, blocks [1, 1 + p.blocks) push
// to the table's addresses, the rest sweep; block 0 and the push blocks
// draw an exit ticket each and the last one waits for the arrivals
// (push_common.cuh).
template <cfd::Op kOp, class Src, class O>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_overlap_peer_kernel(cfd::SweepArgs<O> a, Src s, cfd::PeerPush p) {
  const int64_t blk = blockIdx.x;
  if (blk > p.blocks) {
    cfd::sweep_chunk<true, kOp>(a, s, blk - 1 - p.blocks);
    return;
  }
  if (blk == 0) {
    cfd::peer_signal_block(p);
  } else {
    cfd::peer_push_block(p, blk - 1);
  }
  cfd::peer_finish_block(p);
}

// The same with the direct gather body in the sweep blocks.
template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kThreads, cfd::kDirectMinBlocks<kOp>)
sweep_overlap_peer_direct_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                                 const float4* tbl, cfd::PeerPush p) {
  const int64_t blk = blockIdx.x;
  if (blk > p.blocks) {
    cfd::sweep_chunk_direct<true, kOp>(a, s, tbl, blk - 1 - p.blocks);
    return;
  }
  if (blk == 0) {
    cfd::peer_signal_block(p);
  } else {
    cfd::peer_push_block(p, blk - 1);
  }
  cfd::peer_finish_block(p);
}

// The same with the staged gather body in the sweep blocks.
template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kThreads, kStagedMinBlocks)
sweep_overlap_peer_staged_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                                 const int32_t* ext_cnt, cfd::PeerPush p) {
  const int64_t blk = blockIdx.x;
  if (blk > p.blocks) {
    cfd::sweep_entry_staged<true, kOp>(a, s, ext_cnt, blk - 1 - p.blocks);
    return;
  }
  if (blk == 0) {
    cfd::peer_signal_block(p);
  } else {
    cfd::peer_push_block(p, blk - 1);
  }
  cfd::peer_finish_block(p);
}

// The peer form with the cluster gather body (and, kCtas 4, the quad
// body): block 0 signals, blocks
// [1, 1 + p.blocks) push as above, at the cluster's threads (their first
// kPushThreads copy, every thread meets the push's block barriers), the pad
// block (where 1 + p.blocks is odd) returns at once and draws no exit
// ticket, so the ticket count stays 1 + p.blocks; clusters follow as in
// sweep_overlap_cluster_kernel.  The quad form pads the region to a
// multiple of four blocks, up to three pad blocks, none drawing a ticket;
// every rank computes the same p.blocks (push_common.cuh::peer_chunks),
// so the arrival target is the same on every rank.
//
// Why no launch can deadlock, under cluster scheduling (push_common.cuh
// argues the one-block forms).  The hardware hands out clusters, like
// blocks, in index order; a cluster needs two SMs of one GPC with room for
// its blocks at once.  Blocks 0 and 1 form the first cluster, resident
// before any other, on an idle card (the previous launch on the stream
// has ended), and block 0 waits for nothing before its ticket.  A push
// block waits only for readiness signals, each sent by block 0 of a grid
// (this one, or another rank's, which is resident first in its own grid),
// so every spinning push block is released; the pad block and the sweep
// clusters wait for nothing outside their own cluster (cluster.sync pairs
// two co-scheduled blocks), so fewer free SMs, or none paired in one GPC
// while push blocks spin, only delay them.  The one block that may wait
// across ranks after its ticket (the last-ticket block, for arrivals) holds
// one SM, as in the one-block forms.  The launch refuses to start where no
// cluster can be resident (cfd::cluster_fits).
//
// The same argument holds for clusters of four (the quad body).  Blocks
// 0-3 form the first cluster, resident first on an idle card; block 0
// still waits for nothing before its ticket, and the pad blocks of that
// or a later cluster return at once.  A quad sweep cluster waits only
// inside itself: its gg form synchronises no more than its own block, its
// flux form meets cluster.sync with its three co-scheduled partners, so
// fewer free SMs, or no four of one GPC free while push blocks spin, only
// delay it.  No push block waits for a sweep cluster, and no sweep cluster
// waits for a push block.
template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kClusterMaxThreads, 1)
sweep_overlap_peer_cluster_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                                  const int32_t* ext_cnt, cfd::PeerPush p,
                                  int64_t region) {
  const int64_t blk = blockIdx.x;
  if (blk >= region) {
    cfd::sweep_entry_cluster<true, kOp>(a, s, ext_cnt,
                                        (blk - region) / cfd::kClusterCtas);
    return;
  }
  if (blk > p.blocks) return;                // the pad block: no ticket
  if (blk == 0) {
    cfd::peer_signal_block(p);
  } else {
    cfd::peer_push_block<true>(p, blk - 1);
  }
  cfd::peer_finish_block(p);
}

template <cfd::Op kOp, class W, class O>
__global__ void __launch_bounds__(cfd::kClusterMaxThreads, 1)
sweep_overlap_peer_quad_kernel(cfd::SweepArgs<O> a, cfd::GatherSrc<W> s,
                               const int32_t* ext_cnt, cfd::PeerPush p,
                               int64_t region) {
  const int64_t blk = blockIdx.x;
  if (blk >= region) {
    cfd::sweep_entry_quad<true, kOp>(a, s, ext_cnt,
                                     (blk - region) / cfd::kQuadCtas);
    return;
  }
  if (blk > p.blocks) return;                // a pad block: no ticket
  if (blk == 0) {
    cfd::peer_signal_block(p);
  } else {
    cfd::peer_push_block<true>(p, blk - 1);
  }
  cfd::peer_finish_block(p);
}

// The peer push operands of an entry point, as one argument.
struct PeerOperands {
  const void* sendbufs;
  int esize;
  const void* table;
  void* flags;
  void* recv;
  int64_t nph;
  int64_t s_max;
  int mode;
};

template <cfd::Op kOp, class Src, class O>
int launch_overlap_peer(cfd::SweepArgs<O> a, int64_t P, const Src& s,
                        const PeerOperands& o, cudaStream_t stream,
                        GatherLaunch st = {nullptr, cfd::kDirect, 0,
                                           nullptr}) {
  static_assert(cfd::kPushThreads == cfd::kThreads,
                "push and sweep blocks share one launch");
  const int64_t ctas = body_ctas(st.body);
  if (ctas > 1 && st.threads < cfd::kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t sweep_blocks = sweep_blocks_of<Src>(&a, P, st.body, ctas);
  cfd::PeerPush p;
  if ((o.esize != 2 && o.esize != 4) ||
      !cfd::make_peer_push(&p, o.sendbufs, o.recv, o.table, o.flags, P,
                           o.nph, cfd::op_rows(kOp) * o.s_max * o.esize,
                           o.mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the push region: the signal block and the push blocks, padded to whole
  // clusters in the cluster and quad forms
  const int64_t region = whole_clusters(1 + p.blocks, ctas);
  const int64_t grid = region + sweep_blocks;
  if (!cfd::sweep_args_ok(a.K, a.bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (IsGather<Src>::value) {
    using W = typename IsGather<Src>::W;
    if (st.body == cfd::kCluster) {
      static bool raised = false;
      static cfd::Residency resident;
      return cfd::launch_cluster(
          sweep_overlap_peer_cluster_kernel<kOp, W, O>, &raised, &resident,
          a.bp, s.ep, region, P * a.nb, st.threads, stream, a, s,
          st.ext_cnt, p, region);
    }
    if (st.body == cfd::kQuad) {
      static bool raised = false;
      static cfd::Residency resident;
      return cfd::launch_cluster<cfd::kQuadCtas>(
          sweep_overlap_peer_quad_kernel<kOp, W, O>, &raised, &resident,
          a.bp, s.ep, region, P * a.nb, st.threads, stream, a, s,
          st.ext_cnt, p, region);
    }
    if (st.body == cfd::kStaged) {
      const auto kernel = sweep_overlap_peer_staged_kernel<kOp, W, O>;
      static bool raised = false;
      int64_t smem = 0;
      if (!cfd::staged_launch_ok(kernel, &raised, a.bp, s.ep, &smem)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      kernel<<<static_cast<unsigned>(grid), cfd::kThreads,
               static_cast<size_t>(smem), stream>>>(a, s, st.ext_cnt, p);
      return static_cast<int>(cudaGetLastError());
    }
    sweep_overlap_peer_direct_kernel<kOp, W, O>
        <<<static_cast<unsigned>(grid), cfd::kThreads, 0, stream>>>(
            a, s, st.tbl, p);
  } else {
    sweep_overlap_peer_kernel<kOp, Src, O><<<static_cast<unsigned>(grid),
                                             cfd::kThreads, 0, stream>>>(
        a, s, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sweep operands, op and dtype flags as in cfd_sweep_packed (`out` holds
// init on entry and the op's result on exit).  sendbufs/recv (P, nph, rows,
// s_max) of esize-byte elements (4: f32, 2: bf16), rows = cfd::op_rows,
// with s_max*esize a multiple of 16 and 16-byte aligned bases; dsts
// (P, nph) i32 on the device, every dsts[:, k] a permutation of [0, P)
// (checked by the wrapper).  Launches on `stream`; returns the launch's
// cudaError_t (0 = success).
extern "C" int cfd_sweep_overlap(const float* var_T, int64_t ndev,
                                 const void* srcs, const void* slot_w,
                                 const float* scale, const int32_t* block_ids,
                                 const int32_t* slots, int K, int64_t P,
                                 int64_t nb, int64_t L, int bp, int op,
                                 int w_bf16, int src_bf16d, int out_bf16,
                                 void* out, const void* sendbufs, int esize,
                                 const int32_t* dsts, int64_t nph,
                                 int64_t s_max, void* recv,
                                 cudaStream_t stream) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  const bool flags[] = {op == 1, w_bf16 != 0, src_bf16d != 0,
                        out_bf16 != 0};
  return cfd::with_flags(flags, [&](auto flux, auto w16, auto d16,
                                    auto o16) {
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    using W = cfd::Elt<decltype(w16)::value>;
    using S = cfd::Elt<decltype(d16)::value>;
    using O = cfd::Elt<decltype(o16)::value>;
    const cfd::SweepArgs<O> a{var_T, ndev, scale, block_ids, slots, K, nb,
                              bp, 0, static_cast<O*>(out)};
    const cfd::PackedSrc<W, S> s{static_cast<const S*>(srcs),
                                 static_cast<const W*>(slot_w), L};
    return launch_overlap<kOp>(a, P, s, sendbufs, esize, dsts, nph, s_max,
                               recv, stream);
  });
}

// The gather form: sweep operands (ext_cnt and the body included), op and
// dtype flags as in cfd_sweep_gather, the cluster or quad body's `threads`
// (as cfd_sweep_gather's, at least 128; read by those bodies alone), push
// operands as in cfd_sweep_overlap.  Returns
// cudaErrorInvalidConfiguration where no cluster of the cluster or quad
// body can be resident.
extern "C" int cfd_sweep_overlap_gather(
    const float* var_T, int64_t ndev, const float* exts, int64_t ep,
    const int32_t* slot_idx, const void* slot_w, const float* scale,
    const int32_t* block_ids, const int32_t* slots, int K, int64_t P,
    int64_t nb, int bp, const int32_t* ext_cnt, const void* tbl, int body,
    int op, int w_bf16, int out_bf16, int threads, void* out,
    const void* sendbufs, int esize, const int32_t* dsts, int64_t nph,
    int64_t s_max, void* recv, cudaStream_t stream) {
  if (ep <= 0 || !cfd::op_ok(op) || body < cfd::kDirect ||
      body > cfd::kQuad || reinterpret_cast<uintptr_t>(tbl) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool flags[] = {op == 1, w_bf16 != 0, out_bf16 != 0};
  return cfd::with_flags(flags, [&](auto flux, auto w16, auto o16) {
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    using W = cfd::Elt<decltype(w16)::value>;
    using O = cfd::Elt<decltype(o16)::value>;
    const cfd::SweepArgs<O> a{var_T, ndev, scale, block_ids, slots, K, nb,
                              bp, 0, static_cast<O*>(out)};
    const cfd::GatherSrc<W> s{exts, slot_idx, static_cast<const W*>(slot_w),
                              ep};
    return launch_overlap<kOp>(
        a, P, s, sendbufs, esize, dsts, nph, s_max, recv, stream,
        GatherLaunch{ext_cnt, body, threads,
                     static_cast<const float4*>(tbl)});
  });
}

// The peer forms.  Sweep operands, op and dtype flags as in
// cfd_sweep_overlap / cfd_sweep_overlap_gather.  sendbufs (P, nph, rows,
// s_max) of esize-byte elements; table (P*nph, 3) u64 on the device, flags
// and recv this rank's exchange memory (push_common.cuh; built by
// parallel/transport.py::Peer; the launch epochs are words of `flags`,
// read and advanced by the kernel); mode: the kPushBarrier | kPushCopy bit
// set.
extern "C" int cfd_sweep_overlap_peer(
    const float* var_T, int64_t ndev, const void* srcs, const void* slot_w,
    const float* scale, const int32_t* block_ids, const int32_t* slots, int K,
    int64_t P, int64_t nb, int64_t L, int bp, int op, int w_bf16,
    int src_bf16d, int out_bf16, void* out, const void* sendbufs, int esize,
    const void* table, void* flags, void* recv, int64_t nph, int64_t s_max,
    int mode, cudaStream_t stream) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  const PeerOperands o{sendbufs, esize, table, flags, recv, nph, s_max,
                       mode};
  const bool f[] = {op == 1, w_bf16 != 0, src_bf16d != 0, out_bf16 != 0};
  return cfd::with_flags(f, [&](auto flux, auto w16, auto d16, auto o16) {
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    using W = cfd::Elt<decltype(w16)::value>;
    using S = cfd::Elt<decltype(d16)::value>;
    using O = cfd::Elt<decltype(o16)::value>;
    const cfd::SweepArgs<O> a{var_T, ndev, scale, block_ids, slots, K, nb,
                              bp, 0, static_cast<O*>(out)};
    const cfd::PackedSrc<W, S> s{static_cast<const S*>(srcs),
                                 static_cast<const W*>(slot_w), L};
    return launch_overlap_peer<kOp>(a, P, s, o, stream);
  });
}

extern "C" int cfd_sweep_overlap_gather_peer(
    const float* var_T, int64_t ndev, const float* exts, int64_t ep,
    const int32_t* slot_idx, const void* slot_w, const float* scale,
    const int32_t* block_ids, const int32_t* slots, int K, int64_t P,
    int64_t nb, int bp, const int32_t* ext_cnt, const void* tbl, int body,
    int op, int w_bf16, int out_bf16, int threads, void* out,
    const void* sendbufs, int esize, const void* table, void* flags,
    void* recv, int64_t nph, int64_t s_max, int mode, cudaStream_t stream) {
  if (ep <= 0 || !cfd::op_ok(op) || body < cfd::kDirect ||
      body > cfd::kQuad || reinterpret_cast<uintptr_t>(tbl) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PeerOperands o{sendbufs, esize, table, flags, recv, nph, s_max,
                       mode};
  const bool f[] = {op == 1, w_bf16 != 0, out_bf16 != 0};
  return cfd::with_flags(f, [&](auto flux, auto w16, auto o16) {
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    using W = cfd::Elt<decltype(w16)::value>;
    using O = cfd::Elt<decltype(o16)::value>;
    const cfd::SweepArgs<O> a{var_T, ndev, scale, block_ids, slots, K, nb,
                              bp, 0, static_cast<O*>(out)};
    const cfd::GatherSrc<W> s{exts, slot_idx, static_cast<const W*>(slot_w),
                              ep};
    return launch_overlap_peer<kOp>(
        a, P, s, o, stream,
        GatherLaunch{ext_cnt, body, threads,
                     static_cast<const float4*>(tbl)});
  });
}

// Registers and local bytes per thread (spills and stack), static shared
// bytes and resident blocks per SM of the gg peer instance (packed, or
// gather: its direct body) with the given dtype flags, into out[0..3], and
// the resident blocks per SM its launch bounds ask for into out[4].
// Returns the cudaError_t.
extern "C" int cfd_overlap_peer_info(int gather, int w_bf16, int src_bf16d,
                                     int out_bf16, int* out) {
  auto info = [out](auto kernel, int asked) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[4] = asked;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 3, kernel, cfd::kThreads, 0));
  };
  if (gather) {
    const bool f[] = {w_bf16 != 0, out_bf16 != 0};
    return cfd::with_flags(f, [&](auto w16, auto o16) {
      using W = cfd::Elt<decltype(w16)::value>;
      using O = cfd::Elt<decltype(o16)::value>;
      return info(sweep_overlap_peer_direct_kernel<cfd::Op::kGG, W, O>,
                  cfd::kDirectMinBlocks<cfd::Op::kGG>);
    });
  }
  const bool f[] = {w_bf16 != 0, src_bf16d != 0, out_bf16 != 0};
  return cfd::with_flags(f, [&](auto w16, auto d16, auto o16) {
    using W = cfd::Elt<decltype(w16)::value>;
    using S = cfd::Elt<decltype(d16)::value>;
    using O = cfd::Elt<decltype(o16)::value>;
    return info(
        sweep_overlap_peer_kernel<cfd::Op::kGG, cfd::PackedSrc<W, S>, O>,
        kMinBlocks);
  });
}

// The same facts of a gather instance of the fused kernel, loopback or
// peer form, direct, staged, cluster or quad body (cfd::Body; at `smem`
// bytes of dynamic shared memory, and the cluster and quad bodies at
// `threads` threads a block), op and dtype flags as in
// cfd_sweep_overlap_gather; the cluster and quad bodies also the clusters
// that can be resident at once into out[4] (else 0).
extern "C" int cfd_overlap_gather_info(int peer, int body, int op,
                                       int w_bf16, int out_bf16, int smem,
                                       int threads, int* out) {
  if (!cfd::op_ok(op) || body < cfd::kDirect || body > cfd::kQuad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[4] = 0;
  auto info = [out, smem](auto kernel, int block) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        cfd::kStagedMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 3, kernel, block, smem));
  };
  auto cluster = [&](auto kernel, int ctas) {
    const int e = info(kernel, threads);
    if (e != 0) return e;
    return static_cast<int>(
        cfd::resident_clusters(kernel, threads, smem, out + 4, ctas));
  };
  const bool f[] = {peer != 0, op == 1, w_bf16 != 0, out_bf16 != 0};
  return cfd::with_flags(f, [&](auto pr, auto flux, auto w16, auto o16) {
    using W = cfd::Elt<decltype(w16)::value>;
    using O = cfd::Elt<decltype(o16)::value>;
    constexpr cfd::Op kOp =
        decltype(flux)::value ? cfd::Op::kFlux : cfd::Op::kGG;
    if constexpr (decltype(pr)::value) {
      if (body == cfd::kCluster) {
        return cluster(sweep_overlap_peer_cluster_kernel<kOp, W, O>,
                       cfd::kClusterCtas);
      }
      if (body == cfd::kQuad) {
        return cluster(sweep_overlap_peer_quad_kernel<kOp, W, O>,
                       cfd::kQuadCtas);
      }
      if (body == cfd::kStaged) {
        return info(sweep_overlap_peer_staged_kernel<kOp, W, O>,
                    cfd::kThreads);
      }
      return info(sweep_overlap_peer_direct_kernel<kOp, W, O>,
                  cfd::kThreads);
    } else {
      if (body == cfd::kCluster) {
        return cluster(sweep_overlap_cluster_kernel<kOp, W, O>,
                       cfd::kClusterCtas);
      }
      if (body == cfd::kQuad) {
        return cluster(sweep_overlap_quad_kernel<kOp, W, O>, cfd::kQuadCtas);
      }
      if (body == cfd::kStaged) {
        return info(sweep_overlap_staged_kernel<kOp, W, O>, cfd::kThreads);
      }
      return info(sweep_overlap_direct_kernel<kOp, W, O>, cfd::kThreads);
    }
  });
}
