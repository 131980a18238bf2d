// Fused token sampling for Hopper (sm_90a): temperature, top-k, top-p and
// the categorical draw of every row of a serving tick in one launch.
//
// Replaces the TPU kernel repro/kernels/sampling/kernel.py
// (_fused_sampling_kernel / fused_sampling_pallas), whose body is
// repro/kernels/sampling/ref.py:sample_tokens.  Per row of logits x (V,):
//
//   greedy = argmax x                      (first maximum; T <= 0 returns it)
//   z      = x / max(T, 1e-6)
//   keep_k = z >= lo_k   lo_k from 30 bisection steps on count(z >= mid) >= k
//   keep_p = z >  lo_p   lo_p from 30 bisection steps on sum(prob[z > mid]) >= p
//   h      = fmix32(seed ^ pos * 0x9E3779B9 ^ lane * 0x85EBCA6B)   (uint32)
//   u      = max((h >> 8) * 2^-24, 1e-7),  g = -log(-log(u))
//   token  = argmax over keep_k & keep_p | (lane == greedy) of z + g
//
// A bisection whose restriction keeps every lane (top_k <= 0 or >= V, top_p
// >= 1) is skipped: it would end with every lane kept, so the shortcut is
// exact.  Division and logarithm are IEEE (no fast math), so z and g round as
// the plain version's do on the card.
//
// What bounds it.  The function reads the logits once (4 * V bytes a row), so
// its bound is bytes, but its work depends on the row: a greedy row is one
// pass, a row with top-k and top-p is 2 + 30 + 30 passes over the row.
//
// Design.  One block per row, threads striding over the vocabulary.  z and
// the top-p probabilities are computed once into a scratch buffer that the
// wrapper allocates (a row of 128256 floats does not fit in shared memory),
// so the bisection passes read them back from L2 instead of redoing the
// division and the exponential.  Counts and sums are block-wide per step:
// per-thread partials in element order, xor shuffles inside each warp, then
// the warps' results in warp order, so every thread holds the same total and
// two runs give the same bits.  Ties of the final argmax go to the lowest
// lane, as jnp.argmax does.
//
// The top-p sum is taken in another order than the plain version's, so a
// bisection step can flip where the kept mass is within an ulp of p.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fastcaps {

constexpr float kSampleNegInf = -1e30f;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;
constexpr int kBisectSteps = 30;

struct ArgMax {
  float v;
  int i;
};

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Block-wide reductions.  `red` holds one slot per warp; the leading
// barrier keeps a new reduction from overwriting it while the last one is
// being read.
__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  return r;
}

__device__ __forceinline__ int block_count(int x, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  return r;
}

__device__ __forceinline__ float block_min(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fminf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ ArgMax block_argmax(ArgMax a, float* red_v,
                                               int* red_i) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = better(a, o);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red_v[threadIdx.x >> 5] = a.v;
    red_i[threadIdx.x >> 5] = a.i;
  }
  __syncthreads();
  ArgMax r = {red_v[0], red_i[0]};
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = better(r, ArgMax{red_v[w], red_i[w]});
  return r;
}

__device__ __forceinline__ float gumbel(uint32_t base, uint32_t lane) {
  uint32_t h = base ^ (lane * kMix1);
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  h ^= h >> 16;
  const float u = fmaxf((float)(h >> 8) * (1.0f / 16777216.0f), 1e-7f);
  return -logf(-logf(u));
}

__global__ void __launch_bounds__(1024)
fused_sampling_kernel(const float* __restrict__ logits,
                      const float* __restrict__ temperature,
                      const int* __restrict__ seeds, const int* __restrict__ pos,
                      const int* __restrict__ top_k,
                      const float* __restrict__ top_p,
                      float* __restrict__ scratch, int* __restrict__ out,
                      int V) {
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const float* x = logits + (size_t)row * V;

  ArgMax best = {-INFINITY, 0x7fffffff};
  for (int i = tid; i < V; i += nthr) best = better(best, ArgMax{x[i], i});
  const int greedy = block_argmax(best, red_f, red_i).i;
  const float temp = temperature[row];
  if (temp <= 0.0f) {
    if (tid == 0) out[row] = greedy;
    return;
  }

  // z = x / T once, with its range
  float* z = scratch + (size_t)row * 2 * V;
  float* prob = z + V;
  const float tdiv = fmaxf(temp, 1e-6f);
  float zmin = INFINITY, zmax = -INFINITY;
  for (int i = tid; i < V; i += nthr) {
    const float zi = x[i] / tdiv;
    z[i] = zi;
    zmin = fminf(zmin, zi);
    zmax = fmaxf(zmax, zi);
  }
  zmin = block_min(zmin, red_f);
  zmax = block_max(zmax, red_f);

  // top-k: the largest lo with count(z >= lo) >= k, by bisection
  const int k = top_k[row];
  const int k_eff = k <= 0 ? V : min(max(k, 1), V);
  float lo_k = zmin;
  if (k_eff < V) {
    float lo = zmin, hi = zmax;
    for (int step = 0; step < kBisectSteps; ++step) {
      const float mid = 0.5f * (lo + hi);
      int c = 0;
      for (int i = tid; i < V; i += nthr) c += z[i] >= mid;
      if (block_count(c, red_i) >= k_eff) lo = mid; else hi = mid;
    }
    lo_k = lo;
  }

  // top-p: the largest lo with sum(prob[z > lo]) >= p, by bisection
  const float p = top_p[row];
  const bool use_p = p < 1.0f;
  float lo_p = 0.0f;
  if (use_p) {
    float e_sum = 0.0f;
    for (int i = tid; i < V; i += nthr) e_sum += expf(z[i] - zmax);
    e_sum = block_sum(e_sum, red_f);
    for (int i = tid; i < V; i += nthr) prob[i] = expf(z[i] - zmax) / e_sum;
    float lo = zmin - 1.0f, hi = zmax;
    for (int step = 0; step < kBisectSteps; ++step) {
      const float mid = 0.5f * (lo + hi);
      float c = 0.0f;
      for (int i = tid; i < V; i += nthr) c += z[i] > mid ? prob[i] : 0.0f;
      if (block_sum(c, red_f) >= p) lo = mid; else hi = mid;
    }
    lo_p = lo;
  }

  // Gumbel-argmax over the kept lanes; the greedy lane is always kept
  const uint32_t base = (uint32_t)seeds[row] ^ ((uint32_t)pos[row] * kGold);
  ArgMax pick = {-INFINITY, 0x7fffffff};
  for (int i = tid; i < V; i += nthr) {
    const float zi = z[i];
    const bool keep = (zi >= lo_k && (!use_p || zi > lo_p)) || i == greedy;
    pick = better(pick, ArgMax{keep ? zi + gumbel(base, (uint32_t)i)
                                    : kSampleNegInf, i});
  }
  pick = block_argmax(pick, red_f, red_i);
  if (tid == 0) out[row] = pick.i;
}

}  // namespace fastcaps

// logits (B, V) float32; temperature, top_p (B,) float32; seeds, pos, top_k
// (B,) int32; scratch (B, 2, V) float32; out (B,) int32; all contiguous.
// threads a multiple of 32 in [32, 1024].  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int fused_sampling_launch(const void* logits,
                                     const void* temperature,
                                     const void* seeds, const void* pos,
                                     const void* top_k, const void* top_p,
                                     void* scratch, void* out, int B, int V,
                                     int threads, void* stream) {
  using namespace fastcaps;
  if (B <= 0 || V <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  fused_sampling_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(temperature),
      static_cast<const int*>(seeds), static_cast<const int*>(pos),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<float*>(scratch), static_cast<int*>(out), V);
  return (int)cudaGetLastError();
}
