// The one-sided push between shards that may live in different processes:
// peer stores behind a readiness barrier, arrival flags, a bounded wait.
// Shared by the cross-card form of K3 (sweep_overlap.cu) and by K6
// (push_bench.cu), so the bench times the very code the fused kernel runs.
//
// Replaces the push half of cfd_proxy_tpu/ops/blocksweep.py::
// sweep_blocks_overlap: the readiness barrier (:783-789), the
// make_async_remote_copy starts (:790-792) and the completion waits
// (:796-801).  On the TPU a DMA engine moves each phase's buffer to the
// destination chip and semaphores count readiness and arrival.  Here the
// destination is an ADDRESS: the receive buffer of shard dsts[p, k], which is
// this process's own memory or another process's, mapped through CUDA IPC
// (csrc/ipc.cu, parallel/transport.py::Peer).  CUDA blocks copy the bytes
// with ordinary 16-byte stores, and 64-bit words in the same mapped memory
// take the semaphores' place.
//
// Memory of one rank (allocated once per transport, so a peer maps it once):
//
//     recv   (P_local, nph, seg) uint4      the receive buffers
//     ready  (P_local, nph) u64             ready[q, k]: receiver of (q, k)'s
//                                           push has entered its launch
//     arrive (P_local, nph) u64             arrive[q, k]: push blocks that
//                                           finished storing into recv[q, k]
//     done   u64                            this launch's exit tickets
//     epochs u64[2]                         this rank's launches so far with
//                                           the barrier (epochs[0]) and with
//                                           the copy (epochs[1])
//     waits  u64[4]                         this rank's waits that spun: the
//                                           readiness waits' ns and count,
//                                           then the arrival waits' ns and
//                                           count
//
// `table` holds, per local (p, k): the address of recv[dsts[p, k], k], of
// that buffer's arrive word, and of ready[srcs[p, k], k] (the word the
// SENDER into this shard's recv[p, k] waits on).  dsts[:, k] is a permutation
// with inverse srcs[:, k] (checked on the host), so each word has exactly one
// writer rank per launch and each buffer exactly one sender.
//
// The epochs live in device memory, not in the launch's arguments: a launch
// reads them and its last block advances them, so a launch captured in a
// CUDA graph and replayed any number of times meets the flags of its own
// replay, and eager launches and replays share one count.  Capture launches
// nothing, so it moves no word.  In a graph a launch is a kernel node, and
// the nodes after it (the next step's launch among them) start after it
// ends, as on a stream.  Protocol of one launch, with e_r and e_a
// the stored epochs (launches before this one):
//
//   1. the SIGNAL block (CUDA block 0) adds 1 to ready[srcs[p, k], k] for
//      every local (p, k): "my recv[p, k] is free" — everything that read it
//      came before this launch in stream (or graph) order;
//   2. a PUSH block of (p, k) reads e_r, waits until ready[p, k] >= e_r + 1,
//      copies its share of sendbufs[p, k] to the destination, meets at a
//      block barrier, and its thread 0 fences once at system scope and adds
//      1 to the destination's arrive word;
//   3. the signal block and every push block draw an exit ticket as their
//      last act.  The one that draws the LAST ticket resets the ticket word
//      and advances the epochs by the launch's mode bits (kPushBarrier:
//      epochs[0], kPushCopy: epochs[1]; every block that reads them has
//      drawn its ticket, so none reads a half-advanced word, and the next
//      launch on the stream starts after this one ends).  With kPushCopy it
//      then waits until every local arrive[p, k] >= (e_a + 1) * chunks, so
//      when the launch has ended every push into this rank has landed.
//      Every mode draws the tickets, `empty` and `nodma` included (they
//      advance nothing).  (The reference waits at its last grid step; CUDA
//      has no last block, and a ticket needs no second launch.  The blocks
//      of a fused launch that sweep take no ticket: the wait concerns the
//      pushes alone, and a ticket per sweep block slowed the fused kernel
//      and added 40 B of spills on an H100.)
//
// The wait words.  A wait whose first poll finds its flag set costs one
// load and counts nothing.  One that spins adds the nanoseconds it spun (on
// the global timer, from its first failed poll to the poll that passed)
// and one wait to its pair of words, two atomics of the one waiting thread,
// so the sweep threads of a fused launch run no code of it.  The readiness
// waits (push blocks, side by side) and the arrival waits (the last-ticket
// block, one phase after another) keep a pair each.  The arrival words hold
// only the time the launch's end waited for its peers' pushes to land.  The
// readiness words also hold in-launch scheduling: a push block whose ready
// word is set by the signal block of its own launch (every buffer, in one
// process) spins until that block has run, so their ns sum that baseline
// over the push blocks beside any peer's lateness.
//
// The counters only grow (never reset), so no step races a reset.  Each
// rank's epochs advance in lock step with every other rank's because every
// rank launches the same modes in the same order (a rule of the callers):
// the n-th barrier launch of one rank waits for the n-th signals of the
// others.  Signals are red.release.sys, waits ld.acquire.sys: the block's
// ordinary stores, ordered before the signalling thread by the block
// barrier and made visible by its one __threadfence_system (as a grid
// barrier orders a block's stores), are visible to whoever has seen the
// signal, in this process or another.  A wait polls kSpinPolls times before
// it sleeps, and then sleeps at most kSleepMaxNs between polls, so a block
// oversleeps a signal by well under 1 us.
//
// The copy.  Push blocks stride over their buffer with four 16-byte loads
// in flight per thread (copy_share), at most kPeerPushBlocks blocks: about
// 2 MB in flight, 64 % of the copy bound at 4 x 32 MB on an H100 (700 W),
// against Tensor.copy_'s 87 %.  More in flight costs the fused kernel: a
// TMA bulk-copy ring per push block and eight loads per thread both grew
// the sweep body's spills (72 -> 104 B) and K3-peer's time by up to 29 %,
// though the ring made K6 alone 6-7 % faster (PERF.md section 6).
//
// Why no launch can deadlock on itself (one rank, where signaller and waiter
// are blocks of the same grid).  Only two kinds of block wait.  A push block
// waits for signals that block 0 sends without waiting for anything; block
// 0 has the lowest index, the hardware hands blocks out in index order, so
// it is resident before any push block and finishes.  The last-ticket block
// waits for arrivals from push blocks, all of which have drawn their tickets
// (and so finished) before it; across ranks it is the one block that may
// spin while the sweep blocks run beside it.  Push blocks are capped at
// kPeerPushBlocks in all, below the 132 x 6 blocks a card keeps resident in
// the packed forms, the 132 x 4 of the direct gather form under gg (132 x
// 5 under flux) and the 132 x 4 of the staged gather form at the 96^3
// eight-shard plans, whose 48 KB table every block of the launch carries.
// A staged table large enough to leave fewer resident blocks
// than push blocks only delays the sweep blocks: every wait of a push block
// is for a block 0 that is resident before it (the lowest index of its
// grid, here or on the other rank), so the spinning blocks always drain.
// The cluster form of K3's gather sweep (sweep_overlap.cu, two-block
// clusters, one or two blocks per SM) re-argues this for cluster
// scheduling beside its kernel.  Across ranks the same holds per launch
// as long as every rank launches (a rank that never does is a bug: the
// wait below traps).
//
// Every wait is bounded: past kSpinLimitNs on the global timer it traps, so
// a protocol bug is a launch error, not a hung card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cfd {

constexpr int kPushThreads = 128;            // = kThreads of the sweep
constexpr int64_t kPushPiece = 16;           // bytes per store (uint4)
constexpr int64_t kPushMinPieces = kPushThreads * 4;   // least share a block
constexpr int64_t kPeerPushBlocks = 264;     // push blocks per launch, at most
constexpr uint64_t kSpinLimitNs = 20ull * 1000 * 1000 * 1000;
constexpr int kSpinPolls = 64;               // polls of a wait before it sleeps
constexpr unsigned kSleepMaxNs = 128;        // its longest sleep between polls

// launch modes (bit set): the reference's debug rungs that are kernel modes
enum : int {
  kPushBarrier = 1,   // readiness signals and the wait before the stores
  kPushCopy = 2,      // the stores, the arrival signals and the final wait
  kPushLocal0 = 4     // without kPushCopy: phase 0 copied to the LOCAL recv
};

struct PeerPush {
  const uint4* sendbufs;    // (P_local, nph, seg)
  uint4* recv;              // this rank's (P_local, nph, seg)
  const uint64_t* table;    // (P_local*nph, 3): dst, dst's arrive, src's ready
  uint64_t* flags;          // ready[npk] | arrive[npk] | done
  int64_t npk;              // P_local*nph
  int64_t nph;
  int64_t seg;              // 16-byte pieces per (shard, phase) buffer
  int64_t chunks;           // push blocks per (shard, phase)
  int64_t blocks;           // push blocks in all: npk*chunks
  uint64_t* epochs;         // this rank's [barrier, copy] launches so far,
                            // then its wait words (epochs + 2)
  int mode;
};

// Push blocks per (shard, phase): enough that a block moves at least
// kPushMinPieces, at most kPeerPushBlocks in all.  Sender and receiver
// compute it from the same (seg, npk), so the arrival target agrees.
inline int64_t peer_chunks(int64_t seg, int64_t npk) {
  if (npk <= 0 || seg <= 0) return 0;
  int64_t want = (seg + kPushMinPieces - 1) / kPushMinPieces;
  int64_t cap = kPeerPushBlocks / npk;
  if (cap < 1) cap = 1;
  return want < cap ? want : cap;
}

__device__ __forceinline__ void signal_add(uint64_t* word) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;"
               :: "l"(word), "l"(1ull) : "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* word) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(word) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_timer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait (one thread) until *word >= target: kSpinPolls polls, then polls
// between sleeps doubling from 16 ns to kSleepMaxNs; traps past
// kSpinLimitNs.  A wait that spins adds its ns to waits[0] and one to
// waits[1].
__device__ __forceinline__ void spin_until(const uint64_t* word,
                                           uint64_t target, uint64_t* waits) {
  if (load_acquire(word) >= target) return;
  const uint64_t t0 = global_timer_ns();
  unsigned ns = 16;
  for (int polls = 0; load_acquire(word) < target; ++polls) {
    if (polls >= kSpinPolls) {
      __nanosleep(ns);
      if (ns < kSleepMaxNs) ns *= 2;
    }
    if (global_timer_ns() - t0 > kSpinLimitNs) __trap();
  }
  auto* w = reinterpret_cast<unsigned long long*>(waits);
  atomicAdd(w, static_cast<unsigned long long>(global_timer_ns() - t0));
  atomicAdd(w + 1, 1ull);
}

// This block's share of one buffer: pieces c*T + t, stride chunks*T.
__device__ __forceinline__ void copy_share(const uint4* src, uint4* to,
                                           int64_t seg, int64_t c,
                                           int64_t chunks) {
  const int64_t stride = chunks * kPushThreads;
  int64_t j = c * kPushThreads + threadIdx.x;
  for (; j + 3 * stride < seg; j += 4 * stride) {   // four loads in flight
    const uint4 v0 = __ldg(src + j);
    const uint4 v1 = __ldg(src + j + stride);
    const uint4 v2 = __ldg(src + j + 2 * stride);
    const uint4 v3 = __ldg(src + j + 3 * stride);
    to[j] = v0;
    to[j + stride] = v1;
    to[j + 2 * stride] = v2;
    to[j + 3 * stride] = v3;
  }
  for (; j < seg; j += stride) to[j] = __ldg(src + j);
}

// Step 1: CUDA block 0.
__device__ __forceinline__ void peer_signal_block(const PeerPush& p) {
  if (!(p.mode & kPushBarrier)) return;
  for (int64_t pk = threadIdx.x; pk < p.npk; pk += blockDim.x) {
    signal_add(reinterpret_cast<uint64_t*>(p.table[3 * pk + 2]));
  }
}

// Step 2: push block `blk` in [0, p.blocks).  Its first kPushThreads
// threads copy; kWide (the cluster form of K3, whose blocks are wider):
// the rest only meet both block barriers.
template <bool kWide = false>
__device__ __forceinline__ void peer_push_block(const PeerPush& p,
                                                int64_t blk) {
  const int64_t pk = blk / p.chunks;
  const int64_t c = blk % p.chunks;
  const uint4* src = p.sendbufs + pk * p.seg;
  const bool copies = !kWide || threadIdx.x < kPushThreads;
  if (!(p.mode & kPushCopy)) {
    if ((p.mode & kPushLocal0) && pk % p.nph == 0 && copies) {
      copy_share(src, p.recv + pk * p.seg, p.seg, c, p.chunks);
    }
    return;
  }
  if (p.mode & kPushBarrier) {
    if (threadIdx.x == 0) {
      spin_until(p.flags + pk, p.epochs[0] + 1, p.epochs + 2);
    }
    __syncthreads();
  }
  if (copies) {
    copy_share(src, reinterpret_cast<uint4*>(p.table[3 * pk]), p.seg, c,
               p.chunks);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    signal_add(reinterpret_cast<uint64_t*>(p.table[3 * pk + 1]));
  }
}

// Step 3: the signal block and every push block, as their last act.
__device__ __forceinline__ void peer_finish_block(const PeerPush& p) {
  if (threadIdx.x != 0) return;
  unsigned long long* done =
      reinterpret_cast<unsigned long long*>(p.flags + 2 * p.npk);
  if (atomicAdd(done, 1ull) != static_cast<unsigned long long>(p.blocks)) {
    return;
  }
  *done = 0;
  if (p.mode & kPushBarrier) p.epochs[0] += 1;
  if (!(p.mode & kPushCopy)) return;
  const uint64_t arrive = p.epochs[1] + 1;
  p.epochs[1] = arrive;
  const uint64_t target = arrive * static_cast<uint64_t>(p.chunks);
  for (int64_t pk = 0; pk < p.npk; ++pk) {
    spin_until(p.flags + p.npk + pk, target, p.epochs + 4);
  }
}

// Fill a PeerPush for buffers of `bytes` bytes per (shard, phase) (the
// epochs are the two words after `done`, the wait words the four after
// them); false if the shape cannot be pushed in 16-byte pieces.
inline bool make_peer_push(PeerPush* p, const void* sendbufs, void* recv,
                           const void* table, void* flags, int64_t P,
                           int64_t nph, int64_t bytes, int mode) {
  if (P < 0 || nph < 0 || bytes < 0 || bytes % kPushPiece != 0) return false;
  p->sendbufs = static_cast<const uint4*>(sendbufs);
  p->recv = static_cast<uint4*>(recv);
  p->table = static_cast<const uint64_t*>(table);
  p->flags = static_cast<uint64_t*>(flags);
  p->npk = P * nph;
  p->nph = nph;
  p->seg = bytes / kPushPiece;
  p->chunks = peer_chunks(p->seg, p->npk);
  p->blocks = p->npk * p->chunks;
  p->epochs = p->flags + 2 * p->npk + 1;
  p->mode = mode;
  return true;
}

}  // namespace cfd
