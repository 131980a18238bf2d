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
// its bound is bytes, but a row with top-k and top-p needs 60 bisection steps
// over the row, and each step is a reduction over the whole row: with one
// block per row the steps' barriers and one SM's bandwidth set the time.
//
// Design.  One thread-block cluster per row, `cluster` blocks of it (1 to
// 8, the portable limit), launched with cudaLaunchKernelEx.  Block `rank`
// owns the contiguous slice [rank * S, rank * S + S) of the row, S =
// ceil(V / cluster) rounded up to 4, and keeps that slice's z and
// probabilities in its own shared memory (at V = 128256 over 8 blocks,
// 128 KB), so the bisection passes never touch device memory and no global
// work space exists.  Eight blocks hold rows of up to 230144 logits; a
// longer row is refused.  Lanes past V hold z = -inf, which no count, mass
// or draw takes.
//
//   pass A  float4 loads of x: argmax, z = x / T, min and max of z;
//   pass B  (top-p only) the exponentials into the probability slice and
//           their sum, then the division by the row's sum;
//   passes  the two bisections together, kSampleLevels steps a pass: the
//           2^L - 1 midpoints the next L steps can take are fixed floats
//           given lo and hi (each one 0.5f * (lo' + hi') of its own
//           interval, as the sequential loop computes it), every one is
//           counted (top-k) and summed (top-p) in one sweep (a lane below
//           lo adds nothing to any of them and is skipped), and the L
//           decisions are then walked.  That takes the decisions of L
//           sequential steps, so lo_k and lo_p are the floats of the 30-step
//           loop: counts are exact (float sums of integers below 2^24), and
//           each threshold's mass is summed element by element in a fixed
//           order.  30 steps are 10 passes;
//   pass D  the Gumbel draw over the kept lanes (the hash and the two
//           logarithms only where a lane is kept) and its argmax.
//
// Every reduction runs in one fixed order: per-thread partials in element
// order, xor shuffles inside each warp, the warps in warp order, then the
// blocks' results, which every block reads over distributed shared memory in
// rank order.  Two runs give the same bits.  A block publishes its result in
// one of two slots (double buffering), so a pass costs one cluster barrier.
// The last step writes each block's argmax into rank 0's shared memory,
// which joins them after one more barrier: a greedy row costs one barrier
// in all, and no block waits for another to finish reading it.
// Ties of an argmax go to the lowest lane, as jnp.argmax does.
//
// The top-p sum is taken in another order than the plain version's, so a
// bisection step can flip where the kept mass is within an ulp of p.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace fastcaps {

constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;
constexpr int kBisectSteps = 30;
constexpr int kSampleLevels = 3;                 // bisection steps a pass
constexpr int kSampleNodes = (1 << kSampleLevels) - 1;
constexpr int kSampleVals = 16;                  // values a block publishes
constexpr int kSampleMaxWarps = 32;
constexpr int kSampleMaxCluster = 8;             // the portable limit
constexpr int kSampleMaxSmem = 232448;           // bytes a block may ask for

static_assert(kBisectSteps % kSampleLevels == 0, "whole passes");
static_assert(2 * kSampleNodes <= kSampleVals, "a pass's values fit a slot");

// The slice a block owns and its shared memory, in floats: z and prob of
// the slice, kSampleVals partials per warp, two publication slots, the
// totals, and the blocks' argmaxes that rank 0 joins.  sampling_slice and
// sampling_smem_bytes in kernels/sampling/kernel.py plan cluster sizes by
// the same sums; a CPU test holds the two equal.
__host__ __device__ inline int sampling_slice(int V, int cluster) {
  return ((V + cluster - 1) / cluster + 3) / 4 * 4;
}

__host__ __device__ inline long long sampling_smem_floats(int V,
                                                           int cluster) {
  return 2LL * sampling_slice(V, cluster) +
         (long long)(kSampleMaxWarps + 3) * kSampleVals +
         2LL * kSampleMaxCluster;
}

struct ArgMax {
  float v;
  int i;
};

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
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

// The shared memory of one block.
struct SampleSmem {
  float* z;       // S
  float* prob;    // S
  float* red;     // kSampleMaxWarps x kSampleVals
  float* slot;    // 2 x kSampleVals, published to the cluster
  float* tot;     // kSampleVals, the cluster's totals
  float* join;    // 2 x kSampleMaxCluster, the blocks' argmaxes (rank 0)
};

// Sums of NV per-thread values over the cluster, in the fixed order; every
// thread returns with the totals in s.tot.  `buf` picks the slot.  The
// warps' and the blocks' partials are loaded eight at a time and then added
// in order, so a sum waits for a few load latencies, not one per term.
template <int NV>
__device__ __forceinline__ void cluster_sums(const float (&v)[NV],
                                             const SampleSmem& s, int buf,
                                             const cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int C = (int)cluster.num_blocks();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float x = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) s.red[warp * kSampleVals + j] = x;
  }
  __syncthreads();
  float* slot = s.slot + buf * kSampleVals;
  const int t = threadIdx.x;
  if (t < NV) {
    float x = 0.0f;
    for (int w0 = 0; w0 < warps; w0 += 8) {
      float part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        part[i] = w0 + i < warps ? s.red[(w0 + i) * kSampleVals + t] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (w0 + i < warps) x += part[i];
    }
    slot[t] = x;
  }
  cluster.sync();
  if (t < NV) {
    float x = 0.0f;
    for (int r0 = 0; r0 < C; r0 += 8) {
      float part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        part[i] = r0 + i < C ? cluster.map_shared_rank(slot, r0 + i)[t] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (r0 + i < C) x += part[i];
    }
    s.tot[t] = x;
  }
  __syncthreads();
}

__device__ __forceinline__ void warp_argmax(ArgMax& a, float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = better(a, o);
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// The block's argmax of per-thread (value, index) pairs, minimum of lo and
// maximum of hi; every lane of warp 0 returns with them.  Maxima and minima
// do not depend on the order, so the warps' results are joined by shuffles.
__device__ __forceinline__ void block_argmax(ArgMax& a, float& lo, float& hi,
                                             const SampleSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  warp_argmax(a, lo, hi);
  if (lane == 0) {
    float* r = s.red + warp * kSampleVals;
    r[0] = a.v;
    r[1] = __int_as_float(a.i);
    r[2] = lo;
    r[3] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const float* r = s.red + lane * kSampleVals;
    a = lane < warps ? ArgMax{r[0], __float_as_int(r[1])}
                     : ArgMax{-INFINITY, 0x7fffffff};
    lo = lane < warps ? r[2] : INFINITY;
    hi = lane < warps ? r[3] : -INFINITY;
    warp_argmax(a, lo, hi);
  }
}

// The same over the cluster: every thread returns with them in s.tot[0..3]
// (the index as int bits); warp 0 of each block joins the blocks' results.
__device__ __forceinline__ void cluster_argmax(ArgMax a, float lo, float hi,
                                               const SampleSmem& s, int buf,
                                               const cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = (int)cluster.num_blocks();
  block_argmax(a, lo, hi, s);
  float* slot = s.slot + buf * kSampleVals;
  if (warp == 0 && lane == 0) {
    slot[0] = a.v;
    slot[1] = __int_as_float(a.i);
    slot[2] = lo;
    slot[3] = hi;
  }
  cluster.sync();
  if (warp == 0) {
    a = ArgMax{-INFINITY, 0x7fffffff};
    lo = INFINITY;
    hi = -INFINITY;
    if (lane < C) {
      const float* o = cluster.map_shared_rank(slot, lane);
      a = ArgMax{o[0], __float_as_int(o[1])};
      lo = o[2];
      hi = o[3];
    }
    warp_argmax(a, lo, hi);
    if (lane == 0) {
      s.tot[0] = a.v;
      s.tot[1] = __int_as_float(a.i);
      s.tot[2] = lo;
      s.tot[3] = hi;
    }
  }
  __syncthreads();
}

// The 2^L - 1 midpoints of the next L bisection steps from (lo, hi), heap
// order: node n's interval splits at mid[n]; a step that keeps the upper
// half (lo = mid) goes to node 2n + 2, the lower half to 2n + 1.
__device__ __forceinline__ void bisect_mids(float lo, float hi,
                                            float (&mid)[kSampleNodes]) {
  float nlo[kSampleNodes], nhi[kSampleNodes];
  nlo[0] = lo;
  nhi[0] = hi;
#pragma unroll
  for (int n = 0; n < kSampleNodes; ++n) {
    mid[n] = 0.5f * (nlo[n] + nhi[n]);
    if (2 * n + 2 < kSampleNodes) {
      nlo[2 * n + 1] = nlo[n];
      nhi[2 * n + 1] = mid[n];
      nlo[2 * n + 2] = mid[n];
      nhi[2 * n + 2] = nhi[n];
    }
  }
}

// a[i] for a run-time i, by selects (an indexed load would put `a` in
// local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float r = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = i == j ? a[j] : r;
  return r;
}

// The row's token: the block's argmax goes to rank 0's shared memory, and
// after one cluster barrier rank 0 joins the blocks' argmaxes and writes it.
// The blocks are known to have started (the caller waited on the first
// phase of the cluster barrier); rank 0's `join` is touched by nothing else.
__device__ __forceinline__ void finish_row(ArgMax a, const SampleSmem& s,
                                           const cg::cluster_group& cluster,
                                           int* out) {
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  float lo = 0.0f, hi = 0.0f;
  block_argmax(a, lo, hi, s);
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(s.join, 0);
    dst[2 * rank] = a.v;
    dst[2 * rank + 1] = __int_as_float(a.i);
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < 32) {
    const int r = threadIdx.x;
    a = r < C ? ArgMax{s.join[2 * r], __float_as_int(s.join[2 * r + 1])}
              : ArgMax{-INFINITY, 0x7fffffff};
    warp_argmax(a, lo, hi);
    if (r == 0) *out = a.i;
  }
}

__global__ void __launch_bounds__(1024)
fused_sampling_kernel(const float* __restrict__ logits,
                      const float* __restrict__ temperature,
                      const int* __restrict__ seeds, const int* __restrict__ pos,
                      const int* __restrict__ top_k,
                      const float* __restrict__ top_p, int* __restrict__ out,
                      int V, int S, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  // every block must have started before another touches its shared memory
  cluster_arrive_relaxed();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  extern __shared__ float4 smem4[];
  SampleSmem s;
  s.z = reinterpret_cast<float*>(smem4);
  s.prob = s.z + S;
  s.red = s.prob + S;
  s.slot = s.red + kSampleMaxWarps * kSampleVals;
  s.tot = s.slot + 2 * kSampleVals;
  s.join = s.tot + kSampleVals;
  const int start = rank * S;
  const int end = min(V, start + S);
  const int groups = S / 4;                      // float4 groups of the slice
  const float* x = logits + (size_t)row * V;
  const float temp = temperature[row];
  const bool sample = temp > 0.0f;
  const float tdiv = fmaxf(temp, 1e-6f);
  float4* z4 = reinterpret_cast<float4*>(s.z);
  float4* p4 = reinterpret_cast<float4*>(s.prob);

  // pass A: argmax of x; z and its range for a sampled row
  ArgMax best = {-INFINITY, 0x7fffffff};
  float zmin = INFINITY, zmax = -INFINITY;
#pragma unroll 4
  for (int g = tid; g < groups; g += nthr) {
    const int i0 = start + 4 * g;
    float xv[4];
    if (vec && i0 + 4 <= end) {
      const float4 t = *reinterpret_cast<const float4*>(x + i0);
      xv[0] = t.x;
      xv[1] = t.y;
      xv[2] = t.z;
      xv[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[e] = i0 + e < end ? x[i0 + e] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i0 + e < end) best = better(best, ArgMax{xv[e], i0 + e});
    if (sample) {
      float zv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        zv[e] = i0 + e < end ? xv[e] / tdiv : -INFINITY;
        if (i0 + e < end) {
          zmin = fminf(zmin, zv[e]);
          zmax = fmaxf(zmax, zv[e]);
        }
      }
      z4[g] = make_float4(zv[0], zv[1], zv[2], zv[3]);
    }
  }
  cluster_wait();
  if (!sample) {                    // a greedy row: one cluster barrier
    finish_row(best, s, cluster, out + row);
    return;
  }
  int buf = 0;
  cluster_argmax(best, zmin, zmax, s, buf, cluster);
  const int greedy = __float_as_int(s.tot[1]);
  zmin = s.tot[2];
  zmax = s.tot[3];

  const int k = top_k[row];
  const int k_eff = k <= 0 ? V : min(max(k, 1), V);
  const bool use_k = k_eff < V;
  const float p = top_p[row];
  const bool use_p = p < 1.0f;

  // pass B: the probabilities of the slice
  if (use_p) {
    float e_sum[1] = {0.0f};
    for (int g = tid; g < groups; g += nthr) {
      const float4 zz = z4[g];
      const float4 e = make_float4(expf(zz.x - zmax), expf(zz.y - zmax),
                                   expf(zz.z - zmax), expf(zz.w - zmax));
      e_sum[0] += e.x;
      e_sum[0] += e.y;
      e_sum[0] += e.z;
      e_sum[0] += e.w;
      p4[g] = e;
    }
    buf ^= 1;
    cluster_sums<1>(e_sum, s, buf, cluster);
    const float total = s.tot[0];
    for (int g = tid; g < groups; g += nthr) {   // this thread's own groups
      const float4 e = p4[g];
      p4[g] = make_float4(e.x / total, e.y / total, e.z / total, e.w / total);
    }
  }

  // the bisections, kSampleLevels steps a pass
  float lo_k = zmin, hi_k = zmax;
  float lo_p = zmin - 1.0f, hi_p = zmax;
  if (use_k || use_p) {
    const float kf = (float)k_eff;
    for (int pass = 0; pass < kBisectSteps / kSampleLevels; ++pass) {
      float mk[kSampleNodes], mp[kSampleNodes];
      bisect_mids(lo_k, hi_k, mk);
      bisect_mids(lo_p, hi_p, mp);
      float acc[2 * kSampleNodes];
#pragma unroll
      for (int n = 0; n < 2 * kSampleNodes; ++n) acc[n] = 0.0f;
      // a lane below lo adds 0 to every count and mass (every midpoint
      // is >= lo), and adding 0 leaves a sum's bits as they are: skip it
      for (int g = tid; g < groups; g += nthr) {
        const float4 zz = z4[g];
        const float zv[4] = {zz.x, zz.y, zz.z, zz.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (use_k && zv[e] >= lo_k) {
#pragma unroll
            for (int n = 0; n < kSampleNodes; ++n)
              acc[n] += zv[e] >= mk[n] ? 1.0f : 0.0f;
          }
          if (use_p && zv[e] > lo_p) {
            const float pe = s.prob[4 * g + e];
#pragma unroll
            for (int n = 0; n < kSampleNodes; ++n)
              acc[kSampleNodes + n] += zv[e] > mp[n] ? pe : 0.0f;
          }
        }
      }
      buf ^= 1;
      cluster_sums<2 * kSampleNodes>(acc, s, buf, cluster);
      int nk = 0, np = 0;
#pragma unroll
      for (int l = 0; l < kSampleLevels; ++l) {
        const float mid_k = pick(mk, nk), mid_p = pick(mp, np);
        if (s.tot[nk] >= kf) {
          lo_k = mid_k;
          nk = 2 * nk + 2;
        } else {
          hi_k = mid_k;
          nk = 2 * nk + 1;
        }
        if (s.tot[kSampleNodes + np] >= p) {
          lo_p = mid_p;
          np = 2 * np + 2;
        } else {
          hi_p = mid_p;
          np = 2 * np + 1;
        }
      }
    }
  }
  if (!use_k) lo_k = zmin;

  // pass D: Gumbel-argmax over the kept lanes; the greedy lane is kept
  const uint32_t base = (uint32_t)seeds[row] ^ ((uint32_t)pos[row] * kGold);
  ArgMax draw = {-INFINITY, 0x7fffffff};
  for (int g = tid; g < groups; g += nthr) {
    const float4 zz = z4[g];
    const float zv[4] = {zz.x, zz.y, zz.z, zz.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = start + 4 * g + e;
      const bool keep = (zv[e] >= lo_k && (!use_p || zv[e] > lo_p)) ||
                        i == greedy;
      if (keep)
        draw = better(draw, ArgMax{zv[e] + gumbel(base, (uint32_t)i), i});
    }
  }
  finish_row(draw, s, cluster, out + row);
}

}  // namespace fastcaps

// logits (B, V) float32; temperature, top_p (B,) float32; seeds, pos, top_k
// (B,) int32; out (B,) int32; all contiguous, on CUDA device `device`.
// cluster in {1, 2, 4, 8} with the slice's shared memory within a
// block's 227 KB, threads a multiple of 32 in [32, 1024]; vec = 1 when
// V % 4 == 0 and logits is 16-byte aligned (float4 loads).  Launches B
// clusters on `stream` (a stream of `device`, made current for the launch),
// does not synchronise, allocates nothing.  Returns the CUDA error code of
// the launch (0 = success).
extern "C" int fused_sampling_launch(const void* logits,
                                     const void* temperature,
                                     const void* seeds, const void* pos,
                                     const void* top_k, const void* top_p,
                                     void* out, int B, int V, int cluster,
                                     int threads, int vec, int device,
                                     void* stream) {
  using namespace fastcaps;
  if (B <= 0 || V <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || cluster < 1 || cluster > kSampleMaxCluster ||
      (cluster & (cluster - 1)) != 0 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const long long smem = sampling_smem_floats(V, cluster) * sizeof(float);
  if (smem > kSampleMaxSmem) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  // the shared-memory attribute, set once per device (a failure is
  // returned on every launch)
  static cudaError_t attr_err[kMaxDevices];
  static bool attr_set[kMaxDevices];
  if (!attr_set[device]) {
    attr_err[device] = cudaFuncSetAttribute(
        fused_sampling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSampleMaxSmem);
    attr_set[device] = true;
  }
  if (attr_err[device] != cudaSuccess) return (int)attr_err[device];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(
      &cfg, fused_sampling_kernel, static_cast<const float*>(logits),
      static_cast<const float*>(temperature), static_cast<const int*>(seeds),
      static_cast<const int*>(pos), static_cast<const int*>(top_k),
      static_cast<const float*>(top_p), static_cast<int*>(out), V,
      sampling_slice(V, cluster), vec);
  const cudaError_t last = cudaGetLastError();   // and clear it
  return (int)(launch != cudaSuccess ? launch : last);
}
