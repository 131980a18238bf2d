// Fused dynamic routing for Hopper (sm_90a): every routing iteration of one
// image in one launch, the image's input capsules split over a thread-block
// cluster.
//
// Replaces the TPU kernel repro/kernels/routing/routing_kernel.py
// (_routing_kernel / fused_routing_pallas).  It computes the same function,
//
//   b = 0
//   repeat n_iters times:
//     c_i: = softmax_J(b_i:)            exact exp, or the Eq. 2 polynomial
//     s_j  = sum_i c_ij * u_ij
//     v_j  = s_j * (|s_j|^2 * rsqrt(|s_j|^2 + 1e-9) / (1 + |s_j|^2))
//     b_ij += <u_ij, v_j>               except on the last iteration
//
// and returns the last v (in u_hat's type) and the last c (float32).
//
// What bounds it.  The function reads u_hat once and writes v and c once
// (about 4 operations per element of u_hat and phase), so its bound is
// bytes.  A kernel that re-reads u_hat in every phase (2 n_iters - 1
// passes), or gives one image to one SM (at batch 32, 100 of 132 SMs
// idle), is bound by one SM's bandwidth instead.  Once u_hat is on chip,
// what is left is latency: each phase is short, and its time is the chain
// of dependent shared-memory loads, shuffles and barriers of one thread.
//
// Design.  One thread-block cluster per image, `splits` blocks of it (1, 2,
// 4 or 8, the portable limit), launched with cudaLaunchKernelEx.  Block
// `rank` owns the contiguous input capsules [i0, i1), i0 = rank * I /
// splits, so the ranges differ by at most one capsule.  At the start it
// starts the copy of its slice u_hat[b, i0:i1] (contiguous, in u_hat's own
// type) into shared memory: one 1-D bulk copy (TMA, completion on an
// mbarrier) where the slice's address and length are multiples of 16
// bytes, else cp.async copies of 8 or 4 bytes, else element by element;
// the first softmax (of b = 0) runs while it lands.  Every later phase
// reads u_hat from shared memory, so device memory sees one read of u_hat
// and one write of v and c.  The block keeps its rows of b and c in shared
// memory.  At I = 1152 float32 one image's u_hat (737 KB) fits no block,
// an eighth of it (92 KB, two blocks an SM) does.
//
// Each iteration:
//   1. softmax over J of the block's own rows, one thread a row;
//   2. the FC partial s_j over the block's rows: `groups` groups of threads
//      each add every groups-th row in registers, and the groups' sums are
//      added in group order;
//   3. the partial goes into one of two publication slots (the parity of
//      the iteration), so no block overwrites a slot a peer may still read;
//   4. one cluster barrier;
//   5. every block reads the `splits` partials over distributed shared
//      memory (all loads issued first) and adds them in rank order, so
//      every rank computes the same s and the same v, bit for bit, with no
//      broadcast;
//   6. squash;
//   7. agreement on the block's own rows (skipped on the last iteration).
// Every CapsNet of the repo routes to J = 10 parents of D = 16, which take
// the quad body (kQuadJ, kQuadD at compile time): a thread owns a quad of
// four consecutive d of one j, so shared memory is read 16 bytes a lane
// with neighbouring lanes on neighbouring quads (no bank conflict), the
// softmax row stays in registers, |s_j|^2 and the agreement's dot products
// are added over the quads of j by xor shuffles, the agreement keeps its
// v_j quad in registers and has four rounds' loads and shuffles in flight.
// Other shapes take the run-time body: a thread per column, per j or per
// (i, j), sums over d in order.
// At the end each block writes its rows of c and rank 0 writes v.  A
// cluster barrier, arrived at after the last read of a peer's slot and
// waited for before exit, keeps every block alive until its peers have
// read it.  There is no float atomic: two runs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "approx_math.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace fastcaps {

constexpr int kRoutingMaxCluster = 8;       // the portable limit
constexpr int kRoutingMaxThreads = 1024;
constexpr int kRoutingMaxSmem = 232448;     // bytes a block may ask for
constexpr int kRoutingBarBytes = 16;        // the mbarrier, 16-byte padded
constexpr int kAgreeBatch = 4;              // agreement rounds issued at once
// The shape every CapsNet of the repo routes (J = 10 classes, D = 16), which
// takes the body with both known at compile time.
constexpr int kQuadJ = 10;
constexpr int kQuadD = 16;

// Input capsules of the largest rank of a cluster of `splits` blocks, and
// where rank r's range starts.
__host__ __device__ inline int routing_rows(int n_in, int splits) {
  return (n_in + splits - 1) / splits;
}
__host__ __device__ inline int routing_row0(int n_in, int splits, int rank) {
  return (int)((long long)n_in * rank / splits);
}

// Shared memory of one block: the mbarrier, the u_hat slice (16-byte
// padded), then float32 b and c of the rows (each padded to 16 bytes), the
// groups' partial sums (at most max(kRoutingMaxThreads, J * D) floats
// whatever the block size), two publication slots, s / v, and the squash
// factors.
// routing_smem_bytes in kernels/routing/routing_kernel.py plans cluster
// sizes by the same sum; a CPU test holds the two equal.
__host__ __device__ inline long long routing_slice_bytes(int rows, int jd,
                                                         int elem_bytes) {
  return ((long long)rows * jd * elem_bytes + 15) / 16 * 16;
}

__host__ __device__ inline int routing_pad4(int floats) {
  return (floats + 3) / 4 * 4;
}

__host__ __device__ inline long long routing_smem_bytes(int n_in, int n_out,
                                                        int dim,
                                                        int elem_bytes,
                                                        int splits) {
  const int rows = routing_rows(n_in, splits);
  const long long jd = (long long)n_out * dim;
  const long long floats = 2LL * routing_pad4(rows * n_out) +
                           (jd > kRoutingMaxThreads ? jd : kRoutingMaxThreads) +
                           3 * jd + n_out;
  return kRoutingBarBytes + routing_slice_bytes(rows, (int)jd, elem_bytes) +
         4 * floats;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Starts the copy of [src, src + nbytes) into shared memory at dst: one
// 1-D bulk copy by the tensor memory accelerator, completing on the
// mbarrier `bar`, when address and length are multiples of 16 bytes; else
// cp.async copies of 8 or 4 bytes a thread; else plain 2-byte copies, done
// on return.  Every thread calls it; stage_wait ends it.
__device__ __forceinline__ void stage_issue(void* dst, const void* src,
                                            unsigned nbytes, uint64_t* bar) {
  const int tid = threadIdx.x;
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(src) | nbytes);
  if (nbytes == 0) return;
  if ((mis & 15) == 0) {
    if (tid == 0) {
      const uint32_t b = smem_u32(bar);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(nbytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
          "l"(src), "r"(nbytes), "r"(b)
          : "memory");
    }
    return;
  }
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if ((mis & 3) == 0) {
    const unsigned chunk = (mis & 7) == 0 ? 8u : 4u;
    for (unsigned k = tid; k < nbytes / chunk; k += blockDim.x) {
      if (chunk == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         smem_u32(d + k * 8)),
                     "l"(s + k * 8)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         smem_u32(d + k * 4)),
                     "l"(s + k * 4)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return;
  }
  const unsigned short* s2 = reinterpret_cast<const unsigned short*>(s);
  unsigned short* d2 = reinterpret_cast<unsigned short*>(d);
  for (unsigned k = tid; k < nbytes / 2; k += blockDim.x) d2[k] = s2[k];
}

// Waits for stage_issue's copy; the caller has passed a __syncthreads since
// the issue (which makes the mbarrier's initialisation visible) and passes
// another after, before any thread reads the slice.
__device__ __forceinline__ void stage_wait(const void* src, unsigned nbytes,
                                           uint64_t* bar) {
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(src) | nbytes);
  if (nbytes == 0) return;
  if ((mis & 15) == 0) {
    const uint32_t b = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"(0u)
          : "memory");
    }
  } else if ((mis & 3) == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Four consecutive elements of u_hat (16-byte aligned float32, 8-byte
// aligned bf16) as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Softmax over J of rows [0, rows) of b into c, one thread a row: the
// row's maximum, the exps, their sum in j order, the division.  With J
// known at compile time the row stays in registers, so no store to c waits
// for a load of b it might alias.
template <bool kTaylor, int kJ>
__device__ __forceinline__ void softmax_rows(const float* b_s, float* c_s,
                                             int rows, int n_out) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    if constexpr (kJ > 0) {
      float e[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) e[j] = b_s[i * kJ + j];
      float m = e[0];
#pragma unroll
      for (int j = 1; j < kJ; ++j) m = fmaxf(m, e[j]);
      float denom = 0.0f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        e[j] = softmax_exp<kTaylor>(e[j] - m);
        denom += e[j];
      }
      denom = fmaxf(denom, 1e-30f);
#pragma unroll
      for (int j = 0; j < kJ; ++j) c_s[i * kJ + j] = e[j] / denom;
    } else {
      const float* b_row = b_s + i * n_out;
      float* c_row = c_s + i * n_out;
      float m = b_row[0];
      for (int j = 1; j < n_out; ++j) m = fmaxf(m, b_row[j]);
      float denom = 0.0f;
      for (int j = 0; j < n_out; ++j) {
        const float e = softmax_exp<kTaylor>(b_row[j] - m);
        c_row[j] = e;
        denom += e;
      }
      denom = fmaxf(denom, 1e-30f);
      for (int j = 0; j < n_out; ++j) c_row[j] = c_row[j] / denom;
    }
  }
}

// kJ = kD = 0: the run-time body.  kJ, kD > 0: the quad body, one thread
// per quad (j, q) of four consecutive d of one j (kD / 4 quads a j, a power
// of two, so the quads of a j are an aligned group of lanes).
template <typename T, bool kTaylor, int kJ, int kD>
__global__ void __launch_bounds__(kRoutingMaxThreads)
fused_routing_kernel(const T* __restrict__ u_hat, T* __restrict__ v_out,
                     float* __restrict__ c_out, int n_in, int n_out_rt,
                     int dim_rt, int n_iters) {
  constexpr bool kQuad = kD > 0;
  constexpr int kQ = kQuad ? kD / 4 : 1;      // quads of one (i, j)
  static_assert(!kQuad || (kD % 4 == 0 && (kQ & (kQ - 1)) == 0 && kQ <= 32),
                "quads of a j are an aligned group of lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / splits;
  const int i0 = routing_row0(n_in, splits, rank);
  const int rows = routing_row0(n_in, splits, rank + 1) - i0;
  const int rows_max = routing_rows(n_in, splits);
  const int n_out = kQuad ? kJ : n_out_rt;
  const int dim = kQuad ? kD : dim_rt;
  const int jd = n_out * dim;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* u_s = reinterpret_cast<T*>(smem + kRoutingBarBytes);
  float* b_s = reinterpret_cast<float*>(
      smem + kRoutingBarBytes + routing_slice_bytes(rows_max, jd, sizeof(T)));
  float* c_s = b_s + routing_pad4(rows_max * n_out);   // (rows, J) couplings
  float* part = c_s + routing_pad4(rows_max * n_out);  // (groups, J * D)
  float* slot = part + (jd > kRoutingMaxThreads ? jd : kRoutingMaxThreads);
  float* v_s = slot + 2 * jd;                // (J, D) s, then v
  float* f_s = v_s + jd;                     // (J,) squash factors

  // The copy of the slice runs while b is zeroed and the first softmax,
  // which needs no u_hat, is taken.
  const T* src = u_hat + ((size_t)img * n_in + i0) * jd;
  const unsigned nbytes = (unsigned)((size_t)rows * jd * sizeof(T));
  stage_issue(u_s, src, nbytes, bar);
  for (int p = tid; p < rows * n_out; p += nthreads) b_s[p] = 0.0f;
  __syncthreads();

  // The FC step's thread groups: each adds every groups-th row of its
  // columns (quads), at most as many groups as `part` holds.  With fewer
  // threads than columns, one group walks them in steps of the block size.
  const int lanes = jd / (kQuad ? 4 : 1);    // columns or quads of a row
  const int groups = max(1, min(nthreads / lanes, kRoutingMaxThreads / jd));
  const int group = tid / lanes;
  const int lane0 = tid % lanes;
  const int lane_step = nthreads >= lanes ? lanes : nthreads;

  for (int it = 0; it < n_iters; ++it) {
    // ---- softmax over parents: one thread per input capsule --------------
    softmax_rows<kTaylor, kJ>(b_s, c_s, rows, n_out);
    if (it == 0) stage_wait(src, nbytes, bar);
    __syncthreads();

    // ---- FC: this block's part of s[j, d] = sum_i c[i, j] * u[i, j, d] ---
    if (group < groups) {
      for (int l = lane0; l < lanes; l += lane_step) {
        if constexpr (kQuad) {
          const int j = l / kQ;
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
          for (int i = group; i < rows; i += groups) {
            const float c = c_s[i * kJ + j];
            const float4 x = load4(u_s + i * (kJ * kD) + 4 * l);
            acc.x += c * x.x;
            acc.y += c * x.y;
            acc.z += c * x.z;
            acc.w += c * x.w;
          }
          *reinterpret_cast<float4*>(part + group * jd + 4 * l) = acc;
        } else {
          const int j = l / dim;
          float acc = 0.0f;
#pragma unroll 4
          for (int i = group; i < rows; i += groups)
            acc += c_s[i * n_out + j] * load_f32(u_s + i * jd + l);
          part[group * jd + l] = acc;
        }
      }
    }
    __syncthreads();
    float* pub = slot + (it & 1) * jd;
    for (int col = tid; col < jd; col += nthreads) {
      // the groups in order, eight loads issued before their adds
      float acc = 0.0f;
      for (int g0 = 0; g0 < groups; g0 += 8) {
        float x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          x[k] = g0 + k < groups ? part[(g0 + k) * jd + col] : 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (g0 + k < groups) acc += x[k];
      }
      pub[col] = acc;
    }
    cluster.sync();                   // every rank's partial is published

    // ---- the ranks' partials, added in rank order by every rank, and the
    // squash: v = s * squash_factor(|s|^2) ----------------------------------
    if constexpr (kQuad) {
      // one thread per quad, in the warps that hold one; |s_j|^2 by xor
      // shuffles over the quads of j, taken from the group's first lane so
      // that every d of j scales by the same factor
      if ((tid & ~31) < lanes) {
        const int l = tid;
        // every rank's load is issued before the first add
        float4 x[kRoutingMaxCluster];
#pragma unroll
        for (int r = 0; r < kRoutingMaxCluster; ++r)
          if (r < splits && l < lanes)
            x[r] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(pub, r) + 4 * l);
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < kRoutingMaxCluster; ++r)
          if (r < splits && l < lanes) {
            s.x += x[r].x;
            s.y += x[r].y;
            s.z += x[r].z;
            s.w += x[r].w;
          }
        float sq = s.x * s.x;
        sq += s.y * s.y;
        sq += s.z * s.z;
        sq += s.w * s.w;
#pragma unroll
        for (int off = 1; off < kQ; off <<= 1)
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        sq = __shfl_sync(0xffffffffu, sq, (tid & 31) & ~(kQ - 1));
        const float f = squash_factor(sq);
        if (l < lanes)
          *reinterpret_cast<float4*>(v_s + 4 * l) =
              make_float4(s.x * f, s.y * f, s.z * f, s.w * f);
      }
    } else {
      for (int col = tid; col < jd; col += nthreads) {
        float x[kRoutingMaxCluster];
#pragma unroll
        for (int r = 0; r < kRoutingMaxCluster; ++r)
          if (r < splits) x[r] = cluster.map_shared_rank(pub, r)[col];
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < kRoutingMaxCluster; ++r)
          if (r < splits) s += x[r];
        v_s[col] = s;
      }
      __syncthreads();
      for (int j = tid; j < n_out; j += nthreads) {
        float sq = 0.0f;
        for (int d = 0; d < dim; ++d) {
          float x = v_s[j * dim + d];
          sq += x * x;
        }
        f_s[j] = squash_factor(sq);
      }
      __syncthreads();
      for (int col = tid; col < jd; col += nthreads)
        v_s[col] = v_s[col] * f_s[col / dim];
    }
    // The last read of a peer's slot is behind (its value is in hand): arrive
    // at the cluster barrier that lets the peers leave, and wait for it at
    // the very end.
    if (it == n_iters - 1) cluster_arrive_relaxed();
    __syncthreads();

    // ---- agreement: b[i, j] += sum_d u[i, j, d] * v[j, d] -----------------
    if (it < n_iters - 1) {
      if constexpr (kQuad) {
        // Thread (r, j, q) holds quad q of v_j and takes rows r, r + per,
        // ... of column j: kQ neighbouring lanes read one (i, j)'s 16 bytes
        // each, and xor shuffles add their dot products.
        const int per = nthreads / lanes;    // rows a round
        const int r = tid / lanes;
        const int l = tid % lanes;
        const int j = l / kQ;
        const bool active = r < per;
        const float4 vq = active ? *reinterpret_cast<const float4*>(v_s + 4 * l)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int rounds = (rows + per - 1) / per;
        for (int k0 = 0; k0 < rounds; k0 += kAgreeBatch) {
          float dot[kAgreeBatch];
#pragma unroll
          for (int k = 0; k < kAgreeBatch; ++k) {
            const int i = (k0 + k) * per + r;
            dot[k] = 0.0f;
            if (active && i < rows) {
              const float4 x = load4(u_s + i * (kJ * kD) + 4 * l);
              dot[k] = x.x * vq.x;
              dot[k] += x.y * vq.y;
              dot[k] += x.z * vq.z;
              dot[k] += x.w * vq.w;
            }
          }
#pragma unroll
          for (int off = 1; off < kQ; off <<= 1) {
#pragma unroll
            for (int k = 0; k < kAgreeBatch; ++k)
              dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], off);
          }
#pragma unroll
          for (int k = 0; k < kAgreeBatch; ++k) {
            const int i = (k0 + k) * per + r;
            if (active && i < rows && (l & (kQ - 1)) == 0)
              b_s[i * kJ + j] += dot[k];
          }
        }
      } else {
        for (int p = tid; p < rows * n_out; p += nthreads) {
          const int j = p % n_out;
          const T* u_row = u_s + p * dim;
          float acc = 0.0f;
          for (int d = 0; d < dim; ++d)
            acc += load_f32(u_row + d) * v_s[j * dim + d];
          b_s[p] += acc;
        }
      }
      __syncthreads();
    }
  }

  float* c_rows = c_out + ((size_t)img * n_in + i0) * n_out;
  for (int e = tid; e < rows * n_out; e += nthreads) c_rows[e] = c_s[e];
  if (rank == 0) {
    T* v_img = v_out + (size_t)img * jd;
    for (int col = tid; col < jd; col += nthreads)
      store_f32(v_img + col, v_s[col]);
  }
  cluster_wait();                     // no peer still reads this block's slot
}

template <typename T, bool kTaylor, int kJ, int kD>
int launch_fused_routing(const void* u_hat, void* v_out, float* c_out,
                         int batch, int n_in, int n_out, int dim, int n_iters,
                         int splits, int threads, int device,
                         cudaStream_t stream) {
  auto kernel = fused_routing_kernel<T, kTaylor, kJ, kD>;
  // the dynamic shared memory limit, set once per template instance and
  // device (a failure is returned on every launch)
  static cudaError_t err[kMaxDevices];
  static bool set[kMaxDevices];
  if (!set[device]) {
    err[device] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRoutingMaxSmem);
    set[device] = true;
  }
  if (err[device] != cudaSuccess) return (int)err[device];
  const long long smem =
      routing_smem_bytes(n_in, n_out, dim, (int)sizeof(T), splits);
  if (smem > kRoutingMaxSmem) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * splits, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(u_hat), static_cast<T*>(v_out),
      c_out, n_in, n_out, dim, n_iters);
  const cudaError_t last = cudaGetLastError();   // and clear it
  return (int)(launch != cudaSuccess ? launch : last);
}

// The quad body for J = kQuadJ, D = kQuadD with a whole row's quads in the
// block; the run-time body otherwise.
template <typename T, bool kTaylor>
int dispatch_fused_routing(const void* u_hat, void* v_out, float* c_out,
                           int batch, int n_in, int n_out, int dim,
                           int n_iters, int splits, int threads, int device,
                           cudaStream_t stream) {
  if (n_out == kQuadJ && dim == kQuadD && threads >= kQuadJ * kQuadD / 4)
    return launch_fused_routing<T, kTaylor, kQuadJ, kQuadD>(
        u_hat, v_out, c_out, batch, n_in, n_out, dim, n_iters, splits,
        threads, device, stream);
  return launch_fused_routing<T, kTaylor, 0, 0>(
      u_hat, v_out, c_out, batch, n_in, n_out, dim, n_iters, splits, threads,
      device, stream);
}

}  // namespace fastcaps

// Shared memory in bytes one block of a cluster of `i_splits` needs for
// these sizes (elem_bytes 4 for float32 u_hat, 2 for bfloat16).
extern "C" long long fused_routing_smem_bytes(int n_in, int n_out, int dim,
                                               int elem_bytes, int i_splits) {
  return fastcaps::routing_smem_bytes(n_in, n_out, dim, elem_bytes, i_splits);
}

// u_hat (B, I, J, D) contiguous, float32 (is_bf16 = 0) or bfloat16 (1);
// v_out (B, J, D) in the same type; c_out (B, I, J) float32; all on CUDA
// device `device`.  i_splits in {1, 2, 4, 8} with the block's shared
// memory within 227 KB, threads a multiple of 32 in [32, 1024].  Launches
// B clusters of i_splits blocks on `stream` (a stream of `device`, made
// current for the launch), does not synchronise, allocates nothing.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int fused_routing_launch(const void* u_hat, void* v_out,
                                    void* c_out, int batch, int n_in,
                                    int n_out, int dim, int n_iters,
                                    int taylor, int is_bf16, int i_splits,
                                    int threads, int device, void* stream) {
  using namespace fastcaps;
  if (batch <= 0 || n_in <= 0 || n_out <= 0 || dim <= 0 || n_iters <= 0 ||
      threads < 32 || threads > kRoutingMaxThreads || threads % 32 != 0 ||
      i_splits < 1 || i_splits > kRoutingMaxCluster ||
      (i_splits & (i_splits - 1)) != 0 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* c = static_cast<float*>(c_out);
  if (is_bf16) {
    return taylor
        ? dispatch_fused_routing<__nv_bfloat16, true>(
              u_hat, v_out, c, batch, n_in, n_out, dim, n_iters, i_splits,
              threads, device, s)
        : dispatch_fused_routing<__nv_bfloat16, false>(
              u_hat, v_out, c, batch, n_in, n_out, dim, n_iters, i_splits,
              threads, device, s);
  }
  return taylor
      ? dispatch_fused_routing<float, true>(u_hat, v_out, c, batch, n_in,
                                            n_out, dim, n_iters, i_splits,
                                            threads, device, s)
      : dispatch_fused_routing<float, false>(u_hat, v_out, c, batch, n_in,
                                             n_out, dim, n_iters, i_splits,
                                             threads, device, s);
}
