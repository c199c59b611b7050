// K3: fused interior sweep + halo push, P shards on one card, one launch,
// in both formulations (packed: the K1 body; gather: the K2 body) and both
// ops (gg and flux: the entry point's `op`).
//
// Replaces: cfd_proxy_tpu/ops/blocksweep.py::sweep_blocks_overlap (ops "gg"
// and "flux", f32; packed compact and gather bodies, :744-747) — the GASPI
// write-notify analogue.  On the TPU the kernel starts one make_async_remote_copy per
// phase at its first grid step, sweeps the interior blocks (K1 or K2
// accumulating onto the boundary result) while the copies fly, and waits
// for them at its last step.  Here all P shards live on one card, so a
// "remote" device is another shard's slice of the same buffer:
//
//     recv[dsts[p, k], k] = sendbufs[p, k]       (rows x s_max floats)
//     grad[p]             = K1/K2-accumulate of the interior plan onto init[p]
//
// The first CUDA blocks of the grid do the pushes (the block scheduler
// hands out low indices first, so the copies start first, as the
// reference's do); the rest run the interior sweep (sweep_common.cuh).
//
// No readiness barrier.  The reference signals every source and waits
// before its first push, because a remote write may not land while the
// receiver's buffer is still in use by earlier work on that chip.  Here the
// send buffers are written by the pack, which runs earlier on the same
// stream, so they are final before this kernel starts, and `recv` is a
// buffer of this launch alone (zero-filled by the wrapper, so a phase with
// no sender would read zeros).  Nothing needs a semaphore.
//
// `recv` is kept apart from the gradient array on purpose: the interior
// sweep writes the ghost columns of listed blocks (with zero scale), so a
// push straight into the ghost region would race with it.  The step copies
// `recv` into the ghost regions after the kernel, as the reference does.
//
// Bound: memory.  The sweep streams as K1/K2 with init; the push reads and
// writes rows*s_max*4 bytes per (shard, phase), a few percent of the
// sweep's bytes at the benchmark sizes, with 16-byte coalesced copies.
// rows is the op's output row count (3*NV gg, NV flux).

#include "sweep_common.cuh"

namespace {

constexpr int64_t kPushVec = 4;                       // float4 per thread
constexpr int64_t kPushChunk = cfd::kThreads * kPushVec;   // float4s per block

struct PushArgs {
  const float* sendbufs;    // (P, nph, rows, s_max)
  const int32_t* dsts;      // (P, nph) destination shard per phase
  int64_t nph;
  int64_t seg4;             // float4s per (shard, phase) buffer
  int64_t chunks;           // push blocks per (shard, phase)
  int64_t blocks;           // push blocks in all: P*nph*chunks
  float* recv;              // (P, nph, rows, s_max), zero-filled
};

__device__ __forceinline__ void push_chunk(const PushArgs& p, int64_t blk) {
  const int64_t pk = blk / p.chunks;                  // flat (shard, phase)
  const int64_t k = pk % p.nph;
  const int64_t dst = p.dsts[pk];
  const float4* src = reinterpret_cast<const float4*>(p.sendbufs) + pk * p.seg4;
  float4* to = reinterpret_cast<float4*>(p.recv) + (dst * p.nph + k) * p.seg4;
  const int64_t lo = (blk % p.chunks) * kPushChunk;
  const int64_t hi = lo + kPushChunk < p.seg4 ? lo + kPushChunk : p.seg4;
  for (int64_t j = lo + threadIdx.x; j < hi; j += cfd::kThreads) {
    to[j] = __ldg(src + j);
  }
}

// Resident blocks per SM that ptxas is asked to allow for (see
// sweep_packed.cu).  Measured on an H100 at the one-shard 96^3 shapes, in
// turns: no hint 0.240 ms, 5 0.243 ms, 6 0.190 ms, 8 0.241 ms.
// The gather and flux instances keep the same hint (untuned).
constexpr int kMinBlocks = 6;

template <cfd::Op kOp, class Src>
__global__ void __launch_bounds__(cfd::kThreads, kMinBlocks)
sweep_overlap_kernel(cfd::SweepArgs a, Src s, PushArgs p) {
  if (static_cast<int64_t>(blockIdx.x) < p.blocks) {
    push_chunk(p, blockIdx.x);
    return;
  }
  cfd::sweep_chunk<true, kOp>(a, s, blockIdx.x - p.blocks);
}

// Checks the push shape, sizes the grid and launches one instance.
template <cfd::Op kOp, class Src>
int launch_overlap(const cfd::SweepArgs& base, int64_t P, const Src& s,
                   const float* sendbufs, const int32_t* dsts, int64_t nph,
                   int64_t s_max, float* recv, cudaStream_t stream) {
  cfd::SweepArgs a = base;
  const int64_t sweep_blocks = cfd::sweep_grid(P, a.nb, a.bp, &a.chunks);
  if (s_max % kPushVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t seg4 = cfd::op_rows(kOp) * s_max / kPushVec;
  const int64_t push_chunks = (seg4 + kPushChunk - 1) / kPushChunk;
  const int64_t push_blocks = P * nph * push_chunks;
  const int64_t grid = push_blocks + sweep_blocks;
  if (grid == 0) return 0;
  if (!cfd::sweep_args_ok(a.K, a.bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PushArgs p{sendbufs, dsts, nph, seg4, push_chunks, push_blocks, recv};
  sweep_overlap_kernel<kOp, Src><<<static_cast<unsigned>(grid),
                                   cfd::kThreads, 0, stream>>>(a, s, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sweep operands and op as in cfd_sweep_packed (`out` holds init on entry
// and the op's result on exit).  sendbufs/recv (P, nph, rows, s_max) f32,
// rows = cfd::op_rows, with s_max a multiple of 4 and 16-byte aligned
// bases; dsts (P, nph) i32 on the device, every dsts[:, k] a permutation of
// [0, P) (checked by the wrapper).  Launches on `stream`; returns the
// launch's cudaError_t (0 = success).
extern "C" int cfd_sweep_overlap(const float* var_T, int64_t ndev,
                                 const float* srcs, const float* slot_w,
                                 const float* scale, const int32_t* block_ids,
                                 const int32_t* slots, int K, int64_t P,
                                 int64_t nb, int64_t L, int bp, int op,
                                 float* out, const float* sendbufs,
                                 const int32_t* dsts, int64_t nph,
                                 int64_t s_max, float* recv,
                                 cudaStream_t stream) {
  if (!cfd::op_ok(op)) return static_cast<int>(cudaErrorInvalidValue);
  const cfd::SweepArgs a{var_T, ndev, scale, block_ids, slots, K, nb, bp, 0,
                         out};
  const auto launch = op == 0
                          ? &launch_overlap<cfd::Op::kGG, cfd::PackedSrc>
                          : &launch_overlap<cfd::Op::kFlux, cfd::PackedSrc>;
  return launch(a, P, cfd::PackedSrc{srcs, slot_w, L}, sendbufs, dsts, nph,
                s_max, recv, stream);
}

// The gather form: sweep operands and op as in cfd_sweep_gather, push
// operands as in cfd_sweep_overlap.
extern "C" int cfd_sweep_overlap_gather(
    const float* var_T, int64_t ndev, const float* exts, int64_t ep,
    const int32_t* slot_idx, const float* slot_w, const float* scale,
    const int32_t* block_ids, const int32_t* slots, int K, int64_t P,
    int64_t nb, int bp, int op, float* out, const float* sendbufs,
    const int32_t* dsts, int64_t nph, int64_t s_max, float* recv,
    cudaStream_t stream) {
  if (ep <= 0 || !cfd::op_ok(op)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cfd::SweepArgs a{var_T, ndev, scale, block_ids, slots, K, nb, bp, 0,
                         out};
  const auto launch = op == 0
                          ? &launch_overlap<cfd::Op::kGG, cfd::GatherSrc>
                          : &launch_overlap<cfd::Op::kFlux, cfd::GatherSrc>;
  return launch(a, P, cfd::GatherSrc{exts, slot_idx, slot_w, ep}, sendbufs,
                dsts, nph, s_max, recv, stream);
}
