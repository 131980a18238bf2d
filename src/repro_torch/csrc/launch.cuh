// What the cluster kernels (sampling.cu, decode_attention.cu) share around
// their launches: the device a launch is made on, and the split cluster
// barrier that lets a block start its work before the others have started.

#pragma once

#include <cuda_runtime.h>

namespace fastcaps {

constexpr int kMaxDevices = 64;     // device indices a launch may name

// Makes `device` current for one launch and gives the caller's device back
// at the end of the scope; `err` holds a failure to do so.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
};

// A cluster barrier in two halves: every thread arrives at the start of the
// kernel and waits just before its first access to another block's shared
// memory, which is then known to have started (routing.cu arrives after its
// last such access and waits before it exits, so no peer's shared memory
// is gone while it is read).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace fastcaps
