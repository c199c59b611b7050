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
// for them at its last step.  Here all P shards live on one card, so a
// "remote" device is another shard's slice of the same buffer:
//
//     recv[dsts[p, k], k] = sendbufs[p, k]       (rows x s_max elements)
//     grad[p]             = K1/K2-accumulate of the interior plan onto init[p]
//
// The first CUDA blocks of the grid do the pushes (the block scheduler
// hands out low indices first, so the copies start first, as the
// reference's do); the rest run the interior sweep (sweep_common.cuh).  The
// push is a copy of bytes, so one body serves f32 and bf16 buffers: each
// (shard, phase) buffer is rows*s_max*esize bytes, moved in 16-byte pieces.
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
// writes rows*s_max*esize bytes per (shard, phase), a few percent of the
// sweep's bytes at the benchmark sizes, with 16-byte coalesced copies.
// rows is the op's output row count (3*NV gg, NV flux).

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
// The gather, flux and reduced-precision instances keep the same hint
// (untuned).
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

// Checks the push shape, sizes the grid and launches one instance.
template <cfd::Op kOp, class Src, class O>
int launch_overlap(cfd::SweepArgs<O> a, int64_t P, const Src& s,
                   const void* sendbufs, int esize, const int32_t* dsts,
                   int64_t nph, int64_t s_max, void* recv,
                   cudaStream_t stream) {
  const int64_t sweep_blocks = cfd::sweep_grid(P, a.nb, a.bp, &a.chunks);
  const int64_t row_bytes = s_max * esize;
  if ((esize != 2 && esize != 4) || row_bytes % kPushBytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t seg = cfd::op_rows(kOp) * row_bytes / kPushBytes;
  const int64_t push_chunks = (seg + kPushChunk - 1) / kPushChunk;
  const int64_t push_blocks = P * nph * push_chunks;
  const int64_t grid = push_blocks + sweep_blocks;
  if (grid == 0) return 0;
  if (!cfd::sweep_args_ok(a.K, a.bp, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PushArgs p{static_cast<const uint4*>(sendbufs), dsts, nph, seg,
                   push_chunks, push_blocks, static_cast<uint4*>(recv)};
  sweep_overlap_kernel<kOp, Src, O><<<static_cast<unsigned>(grid),
                                      cfd::kThreads, 0, stream>>>(a, s, p);
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

// The gather form: sweep operands, op and dtype flags as in
// cfd_sweep_gather, push operands as in cfd_sweep_overlap.
extern "C" int cfd_sweep_overlap_gather(
    const float* var_T, int64_t ndev, const float* exts, int64_t ep,
    const int32_t* slot_idx, const void* slot_w, const float* scale,
    const int32_t* block_ids, const int32_t* slots, int K, int64_t P,
    int64_t nb, int bp, int op, int w_bf16, int out_bf16, void* out,
    const void* sendbufs, int esize, const int32_t* dsts, int64_t nph,
    int64_t s_max, void* recv, cudaStream_t stream) {
  if (ep <= 0 || !cfd::op_ok(op)) {
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
    return launch_overlap<kOp>(a, P, s, sendbufs, esize, dsts, nph, s_max,
                               recv, stream);
  });
}
