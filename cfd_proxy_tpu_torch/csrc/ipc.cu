// Exchange memory that another process can map: cudaMalloc + CUDA IPC.
//
// No kernel here.  The peer transport (parallel/transport.py::Peer) keeps
// each rank's receive buffers and flag words in one allocation made by
// cudaMalloc itself, not by PyTorch's caching allocator: an IPC handle
// names a whole cudaMalloc block, so a handle of a cached tensor would name
// the allocator's block and need an offset, and expandable segments cannot
// be exported at all.  The 64-byte handle travels to the other ranks as
// bytes; cudaIpcOpenMemHandle refuses a handle made by the same process, so
// a rank uses its own allocation by its local address.  Every function
// returns a cudaError_t (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "handle travels as 64 bytes");

// A zero-filled allocation of `bytes` on `device`.
extern "C" int cfd_ipc_alloc(int device, int64_t bytes, void** ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int cfd_ipc_free(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaFree(ptr));
}

// The handle of an allocation made by cfd_ipc_alloc, as 64 bytes.
extern "C" int cfd_ipc_export(void* ptr, char* handle64) {
  cudaIpcMemHandle_t h;
  cudaError_t rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  memcpy(handle64, &h, sizeof(h));
  return 0;
}

// Map another process's allocation into this one, on `device` (peer access
// between two cards is enabled on demand).
extern "C" int cfd_ipc_open(int device, const char* handle64, void** ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle64, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int cfd_ipc_close(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}
