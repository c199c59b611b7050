// K6: N push phases in one launch and nothing else — the push bench's
// kernel (tools/icibench.py, ops/push.py::push_phases).
//
// Replaces: cfd_proxy_tpu/tools/icibench.py::build's kernel (:75-111), a
// minimal Pallas kernel that fires nph make_async_remote_copy phases of a
// (rows, S) f32 buffer behind the production readiness barrier and waits
// for them, with the barrier and the copies switched off by `--mode` to
// attribute the fixed cost.  Here the launch is the push half of the fused
// kernel's peer form and nothing more: the device code is push_common.cuh's,
// the code K3 runs (sweep_overlap.cu), so what this kernel costs is what the
// push costs there.  Modes (push_common.cuh's bit set):
//
//   full     kPushBarrier | kPushCopy   signals, wait, stores, arrival wait
//   nobar    kPushCopy                  stores and arrival wait only
//   baronly  kPushBarrier | kPushLocal0 signals; phase 0 copied locally
//   empty    kPushLocal0                phase 0 copied locally, no flag
//
// (the reference's baronly and empty keep one local copy of phase 0 so that
// its chained loop depends on the kernel; kept, so the rungs compare alike).
//
// Bound: memory.  Each phase reads and writes S bytes; at the smallest
// payloads the launch and the flag round trips are the whole cost, which is
// what the modes measure.  Design: push_common.cuh (at most kPeerPushBlocks
// blocks, each striding over its buffer with four 16-byte loads in flight;
// one system-scope fence per block; waits that poll before they sleep).
// PERF.md section 6 has its times per mode beside Tensor.copy_'s, and
// those of a bulk-copy ring that was measured and not kept.

#include "push_common.cuh"

namespace {

__global__ void __launch_bounds__(cfd::kPushThreads)
push_phases_kernel(cfd::PeerPush p) {
  if (blockIdx.x == 0) {
    cfd::peer_signal_block(p);
  } else {
    cfd::peer_push_block(p, static_cast<int64_t>(blockIdx.x) - 1);
  }
  cfd::peer_finish_block(p);
}

}  // namespace

// sendbufs (P, nph) buffers of `bytes` bytes each (a multiple of 16, bases
// 16-byte aligned); table, flags, recv and mode as in
// cfd_sweep_overlap_peer (the launch epochs are words of `flags`).
// Launches on `stream`; returns the launch's cudaError_t (0 = success).
extern "C" int cfd_push_phases(const void* sendbufs, int64_t P, int64_t nph,
                               int64_t bytes, const void* table, void* flags,
                               void* recv, int mode, cudaStream_t stream) {
  cfd::PeerPush p;
  if (!cfd::make_peer_push(&p, sendbufs, recv, table, flags, P, nph, bytes,
                           mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  push_phases_kernel<<<static_cast<unsigned>(1 + p.blocks),
                       cfd::kPushThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K6's registers and local bytes per thread, static shared bytes and
// resident blocks per SM, into out[0..4] (as cfd_overlap_peer_info).
// Returns the cudaError_t.
extern "C" int cfd_push_phases_info(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, push_phases_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, push_phases_kernel, cfd::kPushThreads, 0));
}
