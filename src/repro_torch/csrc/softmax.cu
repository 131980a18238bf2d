// Row softmax with the Eq. 2 polynomial exp, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/softmax/kernel.py (_softmax_kernel /
// taylor_softmax_pallas): over (rows, N), out = e / max(sum(e), 1e-30) with
// e = taylor_exp(x - max(x)), float32 inside whatever the I/O type.
//
// The function is bound by bytes (x read once, out written once; about 20
// operations per element), so the design only has to keep loads coalesced
// and the row out of device memory between the three passes (maximum, sum,
// write): a row is re-read from L1/L2 and the polynomial recomputed, which
// costs no traffic to device memory.  Two kernels:
//
//   * one warp per row for short rows (the routing softmax has N = 10):
//     a block holds threads / 32 rows, lanes stride over the row, and the
//     reductions are xor shuffles;
//   * one block per row for long rows (N up to 1024 and beyond): threads
//     stride over the row, reduce by warp, and the warps' results meet in
//     shared memory and are added in order of the warp index.
//
// Ragged row counts are masked by the kernel; reductions have a fixed order,
// so two runs give the same bits.

#include "approx_math.cuh"

namespace fastcaps {

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void taylor_softmax_warp_kernel(const T* __restrict__ x,
                                           T* __restrict__ out, int rows,
                                           int n) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long row = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  if (row >= rows) return;            // whole warps leave together
  const T* x_row = x + row * n;
  T* o_row = out + row * n;

  float m = -INFINITY;
  for (int k = lane; k < n; k += 32) m = fmaxf(m, load_f32(x_row + k));
  m = warp_max(m);
  float denom = 0.0f;
  for (int k = lane; k < n; k += 32) denom += taylor_exp(load_f32(x_row + k) - m);
  denom = fmaxf(warp_sum(denom), 1e-30f);
  for (int k = lane; k < n; k += 32)
    store_f32(o_row + k, taylor_exp(load_f32(x_row + k) - m) / denom);
}

template <typename T>
__global__ void __launch_bounds__(1024)
taylor_softmax_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int n) {
  __shared__ float red[32];
  __shared__ float bcast;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const T* x_row = x + (long long)blockIdx.x * n;
  T* o_row = out + (long long)blockIdx.x * n;

  float m = -INFINITY;
  for (int k = tid; k < n; k += blockDim.x) m = fmaxf(m, load_f32(x_row + k));
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float r = red[0];
    for (int w = 1; w < warps; ++w) r = fmaxf(r, red[w]);
    bcast = r;
  }
  __syncthreads();
  m = bcast;
  __syncthreads();                    // red and bcast are reused below

  float denom = 0.0f;
  for (int k = tid; k < n; k += blockDim.x)
    denom += taylor_exp(load_f32(x_row + k) - m);
  denom = warp_sum(denom);
  if (lane == 0) red[warp] = denom;
  __syncthreads();
  if (tid == 0) {
    float r = 0.0f;
    for (int w = 0; w < warps; ++w) r += red[w];
    bcast = fmaxf(r, 1e-30f);
  }
  __syncthreads();
  denom = bcast;

  for (int k = tid; k < n; k += blockDim.x)
    store_f32(o_row + k, taylor_exp(load_f32(x_row + k) - m) / denom);
}

template <typename T>
int launch_taylor_softmax(const void* x, void* out, int rows, int n,
                          int threads, int warp_rows, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (warp_rows) {
    int rows_per_block = threads / 32;
    int blocks = (rows + rows_per_block - 1) / rows_per_block;
    taylor_softmax_warp_kernel<T><<<blocks, threads, 0, stream>>>(xp, op, rows, n);
  } else {
    taylor_softmax_block_kernel<T><<<rows, threads, 0, stream>>>(xp, op, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace fastcaps

// x, out (rows, n) contiguous, float32 (is_bf16 = 0) or bfloat16 (1).
// warp_rows = 1 takes the warp-per-row kernel (threads / 32 rows a block),
// 0 the block-per-row kernel.  Launches on `stream`, does not synchronise,
// allocates nothing.  Returns the CUDA error code of the launch (0 = success).
extern "C" int taylor_softmax_launch(const void* x, void* out, int rows, int n,
                                     int is_bf16, int threads, int warp_rows,
                                     void* stream) {
  using namespace fastcaps;
  if (rows <= 0 || n <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_taylor_softmax<__nv_bfloat16>(x, out, rows, n, threads, warp_rows, s)
      : launch_taylor_softmax<float>(x, out, rows, n, threads, warp_rows, s);
}
