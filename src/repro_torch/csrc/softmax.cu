// Row softmax with the Eq. 2 polynomial exp, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/softmax/kernel.py (_softmax_kernel /
// taylor_softmax_pallas): over (rows, N), out = e / max(sum(e), 1e-30) with
// e = taylor_exp(x - max(x)), float32 inside whatever the I/O type.
//
// The function is bound by bytes (x read once, out written once; about 20
// operations per element), so the design has to keep loads coalesced and
// wide, and x out of device memory between the three passes (maximum, sum,
// write).  Three kernels, by row length:
//
//   * short rows (N <= kSoftmaxShortMax; the routing softmax has N = 10):
//     one thread per row out of a shared-memory tile.  A block of R threads
//     (R a multiple of 32) stages R whole rows, which are contiguous, with
//     16-byte copies, every thread computes its own row from the tile
//     (maximum, the exps kept in registers, their sum, the division) and
//     writes it back into the tile, and the tile is stored with 16-byte
//     copies.  x is read once, with no shuffles; a ragged last tile and an
//     unaligned tail are copied element by element.  The wrapper sizes R
//     so that the rows give about one block per SM;
//   * mid-length rows (up to 128): one warp per row, lanes stride over the
//     row, and the reductions are xor shuffles;
//   * long rows: one block per row; threads stride over the row, reduce by
//     warp, and the warps' results meet in shared memory and are added in
//     order of the warp index.
//
// Reductions have a fixed order, so two runs give the same bits.
//
// The backward (taylor_softmax_bwd_launch, at the end of the file) has no
// TPU kernel to replace: the reference differentiates its plain-jnp
// optimized routing (repro/core/approx_math.py:65, taylor_softmax) with
// jax.grad, and the Pallas softmax has no backward.  Given x and the
// output's cotangent g it writes
//
//   dx_j = e'(x_j - m) * (g_j - sum_i g_i o_i) / S,   S = sum_i e_i,
//
// with e = taylor_exp, o = e / S and m = max(x) held constant (the
// reference stops its gradient).  The polynomial exp is not its own
// derivative, so dx cannot be built from the output alone: every body
// recomputes m, e and S from x.  e'(z) is what jax.grad takes through
// clip, Horner and the five squarings: p^31 * E_A * poly'(t), t =
// clip(z, -32, 32) / 32, times the clip's derivative, which jax.grad of
// jnp.clip makes 1 inside, 1/2 on the edge (z = -32 exactly) and 0
// outside.  S >= p(0)^32 (about 1), so max(S, 1e-30) always takes S and
// its other branch carries no gradient.  The backward is bound by bytes
// like the forward (x and g read once, dx written once; about 40
// operations an element): its three bodies are the forward's, the tile
// body staging x and g side by side.

#include "approx_math.cuh"
#include "launch.cuh"

namespace fastcaps {

constexpr int kSoftmaxShortMax = 32;        // longest row one thread takes
constexpr int kSoftmaxTileBytes = 32768;    // most shared memory a tile uses
constexpr int kSoftmaxMaxSmem = 232448;     // bytes a block may ask for
// Both tile launches refuse a tile (forward) or pair of tiles (backward)
// past kSoftmaxTileBytes, so no block asks for more than this.
static_assert(kSoftmaxTileBytes <= kSoftmaxMaxSmem,
              "a softmax tile outgrows Hopper's shared memory");

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

// One thread per row of a tile of blockDim.x rows, staged in shared memory.
// kMaxN (16 or 32) bounds the row: every thread computes kMaxN lanes and
// masks those past n, so the lanes' exps are independent of each other and
// of n, and run side by side.  vec = 1 when x and out are 16-byte aligned:
// every tile then starts on a 16-byte boundary (blockDim.x is a multiple of
// 32).
template <typename T, int kMaxN>
__global__ void taylor_softmax_tile_kernel(const T* __restrict__ x,
                                           T* __restrict__ out,
                                           long long rows, int n, int vec) {
  extern __shared__ __align__(16) unsigned char tile_raw[];
  T* tile = reinterpret_cast<T*>(tile_raw);
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * blockDim.x;
  const int nrows = (int)min((long long)blockDim.x, rows - r0);
  const int count = nrows * n;                 // elements of this tile
  const T* src = x + r0 * n;
  T* dst = out + r0 * n;
  constexpr int kPer16 = 16 / sizeof(T);
  const int nvec = vec ? count / kPer16 : 0;

  for (int k = tid; k < nvec; k += blockDim.x)
    reinterpret_cast<uint4*>(tile)[k] = reinterpret_cast<const uint4*>(src)[k];
  for (int e = nvec * kPer16 + tid; e < count; e += blockDim.x)
    tile[e] = src[e];
  __syncthreads();

  if (tid < nrows) {
    T* row = tile + tid * n;
    float e[kMaxN];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxN; ++k) {
      e[k] = load_f32(row + (k < n ? k : 0));
      m = fmaxf(m, e[k]);
    }
    float denom = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxN; ++k) {
      e[k] = taylor_exp(e[k] - m);
      denom += k < n ? e[k] : 0.0f;
    }
    denom = fmaxf(denom, 1e-30f);
#pragma unroll
    for (int k = 0; k < kMaxN; ++k)
      if (k < n) store_f32(row + k, e[k] / denom);
  }
  __syncthreads();

  for (int k = tid; k < nvec; k += blockDim.x)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(tile)[k];
  for (int e = nvec * kPer16 + tid; e < count; e += blockDim.x)
    dst[e] = tile[e];
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
                          int threads, int body, int vec,
                          cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (body == 2) {
    const long long tile = (long long)threads * n * sizeof(T);
    if (n > kSoftmaxShortMax || tile > kSoftmaxTileBytes)
      return (int)cudaErrorInvalidValue;
    const int blocks = (rows + threads - 1) / threads;
    const size_t smem = (size_t)(tile + 15) / 16 * 16;
    if (n <= 16)
      taylor_softmax_tile_kernel<T, 16><<<blocks, threads, smem, stream>>>(
          xp, op, rows, n, vec);
    else
      taylor_softmax_tile_kernel<T, kSoftmaxShortMax>
          <<<blocks, threads, smem, stream>>>(xp, op, rows, n, vec);
  } else if (body == 1) {
    int rows_per_block = threads / 32;
    int blocks = (rows + rows_per_block - 1) / rows_per_block;
    taylor_softmax_warp_kernel<T><<<blocks, threads, 0, stream>>>(xp, op, rows, n);
  } else {
    taylor_softmax_block_kernel<T><<<rows, threads, 0, stream>>>(xp, op, n);
  }
  return (int)cudaGetLastError();
}

// -- backward ---------------------------------------------------------------

// e = taylor_exp(z) and, through *de, de/dz as jax.grad takes it (see the
// note at the top of the file).
__device__ __forceinline__ float taylor_exp_and_grad(float z, float* de) {
  const float t = fminf(fmaxf(z, -kReduceScale), kReduceScale) / kReduceScale;
  const float p = taylor_exp_raw(t);
  const float p2 = __fmul_rn(p, p);
  const float p4 = __fmul_rn(p2, p2);
  const float p8 = __fmul_rn(p4, p4);
  const float p16 = __fmul_rn(p8, p8);
  // poly'(t) in Horner form
  float dp = __fadd_rn(4.0f * kC4, __fmul_rn(5.0f * kC5, t));
  dp = __fadd_rn(3.0f * kC3, __fmul_rn(t, dp));
  dp = __fadd_rn(2.0f * kC2, __fmul_rn(t, dp));
  dp = __fadd_rn(kC1, __fmul_rn(t, dp));
  const float clip = (z > -kReduceScale && z < kReduceScale) ? 1.0f
                     : (z == -kReduceScale || z == kReduceScale) ? 0.5f
                                                                 : 0.0f;
  const float p31 = p16 * p8 * p4 * p2 * p;
  *de = p31 * kEA * dp * clip;
  return __fmul_rn(p16, p16);
}

// One thread per row, x and g staged side by side in shared memory (two
// tiles of blockDim.x rows); dx is written over the x tile and stored from
// there.
template <typename T, int kMaxN>
__global__ void taylor_softmax_bwd_tile_kernel(const T* __restrict__ x,
                                               const T* __restrict__ g,
                                               T* __restrict__ dx,
                                               long long rows, int n,
                                               int vec) {
  extern __shared__ __align__(16) unsigned char tile_raw[];
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * blockDim.x;
  const int nrows = (int)min((long long)blockDim.x, rows - r0);
  const int count = nrows * n;
  T* xt = reinterpret_cast<T*>(tile_raw);
  // the g tile starts 16-byte aligned after a full x tile
  T* gt = reinterpret_cast<T*>(
      tile_raw + ((size_t)blockDim.x * n * sizeof(T) + 15) / 16 * 16);
  const T* xs = x + r0 * n;
  const T* gs = g + r0 * n;
  T* dst = dx + r0 * n;
  constexpr int kPer16 = 16 / sizeof(T);
  const int nvec = vec ? count / kPer16 : 0;

  for (int k = tid; k < nvec; k += blockDim.x) {
    reinterpret_cast<uint4*>(xt)[k] = reinterpret_cast<const uint4*>(xs)[k];
    reinterpret_cast<uint4*>(gt)[k] = reinterpret_cast<const uint4*>(gs)[k];
  }
  for (int e = nvec * kPer16 + tid; e < count; e += blockDim.x) {
    xt[e] = xs[e];
    gt[e] = gs[e];
  }
  __syncthreads();

  if (tid < nrows) {
    T* xrow = xt + tid * n;
    const T* grow = gt + tid * n;
    float z[kMaxN], de[kMaxN], gv[kMaxN];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxN; ++k) {
      z[k] = load_f32(xrow + (k < n ? k : 0));
      gv[k] = k < n ? load_f32(grow + k) : 0.0f;
      m = fmaxf(m, z[k]);
    }
    float denom = 0.0f, dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxN; ++k) {
      const float e = taylor_exp_and_grad(z[k] - m, &de[k]);
      denom += k < n ? e : 0.0f;
      dot += k < n ? gv[k] * e : 0.0f;
    }
    dot /= denom;                     // sum_i g_i o_i
#pragma unroll
    for (int k = 0; k < kMaxN; ++k)
      if (k < n) store_f32(xrow + k, de[k] * (gv[k] - dot) / denom);
  }
  __syncthreads();

  for (int k = tid; k < nvec; k += blockDim.x)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(xt)[k];
  for (int e = nvec * kPer16 + tid; e < count; e += blockDim.x)
    dst[e] = xt[e];
}

template <typename T>
__global__ void taylor_softmax_bwd_warp_kernel(const T* __restrict__ x,
                                               const T* __restrict__ g,
                                               T* __restrict__ dx, int rows,
                                               int n) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long row = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  if (row >= rows) return;            // whole warps leave together
  const T* x_row = x + row * n;
  const T* g_row = g + row * n;
  T* d_row = dx + row * n;

  float m = -INFINITY;
  for (int k = lane; k < n; k += 32) m = fmaxf(m, load_f32(x_row + k));
  m = warp_max(m);
  float denom = 0.0f, dot = 0.0f, de;
  for (int k = lane; k < n; k += 32) {
    const float e = taylor_exp_and_grad(load_f32(x_row + k) - m, &de);
    denom += e;
    dot += load_f32(g_row + k) * e;
  }
  denom = warp_sum(denom);
  dot = warp_sum(dot) / denom;
  for (int k = lane; k < n; k += 32) {
    taylor_exp_and_grad(load_f32(x_row + k) - m, &de);
    store_f32(d_row + k, de * (load_f32(g_row + k) - dot) / denom);
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
taylor_softmax_bwd_block_kernel(const T* __restrict__ x,
                                const T* __restrict__ g, T* __restrict__ dx,
                                int n) {
  __shared__ float red[2][32];
  __shared__ float bcast[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const T* x_row = x + (long long)blockIdx.x * n;
  const T* g_row = g + (long long)blockIdx.x * n;
  T* d_row = dx + (long long)blockIdx.x * n;

  float m = -INFINITY;
  for (int k = tid; k < n; k += blockDim.x) m = fmaxf(m, load_f32(x_row + k));
  m = warp_max(m);
  if (lane == 0) red[0][warp] = m;
  __syncthreads();
  if (tid == 0) {
    float r = red[0][0];
    for (int w = 1; w < warps; ++w) r = fmaxf(r, red[0][w]);
    bcast[0] = r;
  }
  __syncthreads();
  m = bcast[0];
  __syncthreads();                    // red and bcast are reused below

  float denom = 0.0f, dot = 0.0f, de;
  for (int k = tid; k < n; k += blockDim.x) {
    const float e = taylor_exp_and_grad(load_f32(x_row + k) - m, &de);
    denom += e;
    dot += load_f32(g_row + k) * e;
  }
  denom = warp_sum(denom);
  dot = warp_sum(dot);
  if (lane == 0) {
    red[0][warp] = denom;
    red[1][warp] = dot;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f, d = 0.0f;
    for (int w = 0; w < warps; ++w) {
      s += red[0][w];
      d += red[1][w];
    }
    bcast[0] = s;
    bcast[1] = d / s;
  }
  __syncthreads();
  denom = bcast[0];
  dot = bcast[1];

  for (int k = tid; k < n; k += blockDim.x) {
    taylor_exp_and_grad(load_f32(x_row + k) - m, &de);
    store_f32(d_row + k, de * (load_f32(g_row + k) - dot) / denom);
  }
}

template <typename T>
int launch_taylor_softmax_bwd(const void* x, const void* g, void* dx,
                              int rows, int n, int threads, int body,
                              int vec, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  if (body == 2) {
    const long long tile = ((long long)threads * n * sizeof(T) + 15) / 16 * 16;
    if (n > kSoftmaxShortMax || 2 * tile > kSoftmaxTileBytes)
      return (int)cudaErrorInvalidValue;
    const int blocks = (rows + threads - 1) / threads;
    const size_t smem = (size_t)(2 * tile);
    if (n <= 16)
      taylor_softmax_bwd_tile_kernel<T, 16><<<blocks, threads, smem, stream>>>(
          xp, gp, dp, rows, n, vec);
    else
      taylor_softmax_bwd_tile_kernel<T, kSoftmaxShortMax>
          <<<blocks, threads, smem, stream>>>(xp, gp, dp, rows, n, vec);
  } else if (body == 1) {
    int rows_per_block = threads / 32;
    int blocks = (rows + rows_per_block - 1) / rows_per_block;
    taylor_softmax_bwd_warp_kernel<T><<<blocks, threads, 0, stream>>>(
        xp, gp, dp, rows, n);
  } else {
    taylor_softmax_bwd_block_kernel<T><<<rows, threads, 0, stream>>>(
        xp, gp, dp, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace fastcaps

// x, out (rows, n) contiguous, float32 (is_bf16 = 0) or bfloat16 (1), on
// CUDA device `device`.  body 2 takes the tile kernel (threads rows a block,
// n <= kSoftmaxShortMax, the tile within kSoftmaxTileBytes; vec = 1 when x
// and out are 16-byte aligned), 1 the warp-per-row kernel (threads / 32
// rows a block), 0 the block-per-row kernel.  Launches on `stream` (a
// stream of `device`, made current for the launch), does not synchronise,
// allocates nothing.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int taylor_softmax_launch(const void* x, void* out, int rows, int n,
                                     int is_bf16, int threads, int body,
                                     int vec, int device, void* stream) {
  using namespace fastcaps;
  if (rows <= 0 || n <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || body < 0 || body > 2 || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_taylor_softmax<__nv_bfloat16>(x, out, rows, n,
                                                       threads, body, vec, s)
                 : launch_taylor_softmax<float>(x, out, rows, n, threads,
                                                body, vec, s);
}

// x, g, dx (rows, n) contiguous, of one type (float32 or bfloat16, is_bf16);
// dx = the gradient of taylor_softmax(x) against the output cotangent g.
// body and threads as for taylor_softmax_launch (the tile body stages x and
// g: 2 * threads * n elements within kSoftmaxTileBytes); vec = 1 when x, g
// and dx are 16-byte aligned.  Launches on `stream`, does not synchronise,
// allocates nothing; returns the CUDA error code of the launch.
extern "C" int taylor_softmax_bwd_launch(const void* x, const void* g,
                                         void* dx, int rows, int n,
                                         int is_bf16, int threads, int body,
                                         int vec, int device, void* stream) {
  using namespace fastcaps;
  if (rows <= 0 || n <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || body < 0 || body > 2 || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_taylor_softmax_bwd<__nv_bfloat16>(
                       x, g, dx, rows, n, threads, body, vec, s)
                 : launch_taylor_softmax_bwd<float>(x, g, dx, rows, n,
                                                    threads, body, vec, s);
}
