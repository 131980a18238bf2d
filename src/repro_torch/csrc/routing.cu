// Fused dynamic routing for Hopper (sm_90a): every routing iteration of one
// image in one launch.
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
// and returns the last v (in u_hat's type) and the last c (float32), but not
// the TPU kernel's block structure: there a grid step held batch_block whole
// images in on-chip memory, and one image's u_hat (737 KB at I = 1152) does
// not fit a thread block's 227 KB of shared memory.
//
// Design.  One thread block per image.  The logits b and the couplings c live
// in shared memory for the whole launch (2 * I * J floats), as do s and v; the
// only traffic to device memory is u_hat, read once per phase (n_iters times
// for the FC step and n_iters - 1 times for the agreement step; after the
// first read it comes from L2), and one write of v and c at the end.  The
// kernel is bound by those bytes, not by arithmetic: about 4 operations per
// byte of u_hat and phase.  Threads run along the contiguous (j, d) axis of
// u_hat, so every warp reads whole rows.
//
// The sum over input capsules i is taken in a fixed order: each thread adds
// up a strided share of the rows in a register, the shares meet in shared
// memory, and one thread per (j, d) adds them in order of their index.  The
// agreement step reduces over d with xor shuffles inside aligned groups of D
// lanes.  There is no float atomic, so two runs give the same bits.

#include "approx_math.cuh"

namespace fastcaps {

template <typename T, bool kTaylor>
__global__ void __launch_bounds__(1024, 1)
fused_routing_kernel(const T* __restrict__ u_hat, T* __restrict__ v_out,
                     float* __restrict__ c_out, int n_in, int n_out, int dim,
                     int n_iters) {
  extern __shared__ float smem[];
  const int jd = n_out * dim;
  const int ij = n_in * n_out;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  float* b_s = smem;                  // (I, J) logits
  float* c_s = b_s + ij;              // (I, J) couplings
  float* s_s = c_s + ij;              // (J, D) weighted sums
  float* v_s = s_s + jd;              // (J, D) squashed parents
  float* f_s = v_s + jd;              // (J,)   squash factors
  float* part = f_s + n_out;          // (groups, J * D) partial sums over i

  const T* u = u_hat + (size_t)blockIdx.x * n_in * jd;

  for (int e = tid; e < ij; e += nthreads) b_s[e] = 0.0f;
  __syncthreads();

  // How the threads cover the (j, d) axis in the FC step: with at least J * D
  // threads, `groups` groups of J * D threads each take every groups-th row;
  // with fewer, one group walks the axis in steps of the block size.
  const bool wide = nthreads >= jd;
  const int groups = wide ? nthreads / jd : 1;
  const int group = wide ? tid / jd : 0;
  const int col0 = wide ? tid % jd : tid;
  const int col_step = wide ? jd : nthreads;

  // xor shuffles reduce over d when a group of D lanes is aligned in a warp
  const bool shuffle_d = dim <= 32 && (dim & (dim - 1)) == 0;

  for (int it = 0; it < n_iters; ++it) {
    // ---- softmax over parents: one thread per input capsule --------------
    for (int i = tid; i < n_in; i += nthreads) {
      const float* b_row = b_s + i * n_out;
      float* c_row = c_s + i * n_out;
      float m = b_row[0];
      for (int j = 1; j < n_out; ++j) m = fmaxf(m, b_row[j]);
      float denom = 0.0f;
      for (int j = 0; j < n_out; ++j) {
        float e = softmax_exp<kTaylor>(b_row[j] - m);
        c_row[j] = e;
        denom += e;
      }
      denom = fmaxf(denom, 1e-30f);
      for (int j = 0; j < n_out; ++j) c_row[j] = c_row[j] / denom;
    }
    __syncthreads();

    // ---- FC: s[j, d] = sum_i c[i, j] * u[i, j, d] -------------------------
    if (group < groups) {
      for (int col = col0; col < jd; col += col_step) {
        const int j = col / dim;
        float acc = 0.0f;
        // unrolled so that several loads are in flight; the adds keep their
        // order, so the sum is the same
#pragma unroll 8
        for (int i = group; i < n_in; i += groups)
          acc += c_s[i * n_out + j] * load_f32(u + (size_t)i * jd + col);
        part[group * jd + col] = acc;
      }
    }
    __syncthreads();
    for (int col = tid; col < jd; col += nthreads) {
      float acc = 0.0f;
      for (int g = 0; g < groups; ++g) acc += part[g * jd + col];
      s_s[col] = acc;
    }
    __syncthreads();

    // ---- squash ------------------------------------------------------------
    for (int j = tid; j < n_out; j += nthreads) {
      float sq = 0.0f;
      for (int d = 0; d < dim; ++d) {
        float x = s_s[j * dim + d];
        sq += x * x;
      }
      f_s[j] = squash_factor(sq);
    }
    __syncthreads();
    for (int col = tid; col < jd; col += nthreads)
      v_s[col] = s_s[col] * f_s[col / dim];
    __syncthreads();

    // ---- agreement: b[i, j] += sum_d u[i, j, d] * v[j, d] -----------------
    if (it < n_iters - 1) {
      if (shuffle_d) {
        // Element e = (i, j, d) of the image goes to thread e % nthreads.
        // The block size is a multiple of 32 and D divides 32, so the D
        // lanes of one (i, j) are an aligned group of one warp.
        const int total = n_in * jd;
        const int rounds = (total + nthreads - 1) / nthreads;
#pragma unroll 4
        for (int r = 0; r < rounds; ++r) {
          const int e = r * nthreads + tid;
          float prod = 0.0f;
          if (e < total) prod = load_f32(u + e) * v_s[e % jd];
          for (int off = dim >> 1; off > 0; off >>= 1)
            prod += __shfl_xor_sync(0xffffffffu, prod, off);
          if (e < total && (e & (dim - 1)) == 0) b_s[e / dim] += prod;
        }
      } else {
        for (int e = tid; e < ij; e += nthreads) {
          const int j = e % n_out;
          const T* u_row = u + (size_t)e * dim;
          float acc = 0.0f;
          for (int d = 0; d < dim; ++d)
            acc += load_f32(u_row + d) * v_s[j * dim + d];
          b_s[e] += acc;
        }
      }
      __syncthreads();
    }
  }

  T* v_img = v_out + (size_t)blockIdx.x * jd;
  float* c_img = c_out + (size_t)blockIdx.x * ij;
  for (int col = tid; col < jd; col += nthreads) store_f32(v_img + col, v_s[col]);
  for (int e = tid; e < ij; e += nthreads) c_img[e] = c_s[e];
}

template <typename T, bool kTaylor>
int launch_fused_routing(const void* u_hat, void* v_out, float* c_out,
                         int batch, int n_in, int n_out, int dim, int n_iters,
                         int threads, size_t smem_bytes, cudaStream_t stream) {
  auto kernel = fused_routing_kernel<T, kTaylor>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, threads, smem_bytes, stream>>>(
      static_cast<const T*>(u_hat), static_cast<T*>(v_out), c_out, n_in,
      n_out, dim, n_iters);
  return (int)cudaGetLastError();
}

}  // namespace fastcaps

// Shared memory in bytes one block needs for these sizes; the Python wrapper
// asks before it launches and raises when a block cannot have that much.
extern "C" long long fused_routing_smem_bytes(int n_in, int n_out, int dim,
                                               int threads) {
  long long jd = (long long)n_out * dim;
  long long ij = (long long)n_in * n_out;
  long long groups = threads >= jd ? threads / jd : 1;
  return (2 * ij + 2 * jd + n_out + groups * jd) * (long long)sizeof(float);
}

// u_hat (B, I, J, D) contiguous, float32 (is_bf16 = 0) or bfloat16 (1);
// v_out (B, J, D) in the same type; c_out (B, I, J) float32.  Launches on
// `stream`, does not synchronise, allocates nothing.  Returns the CUDA error
// code of the launch (0 = success).
extern "C" int fused_routing_launch(const void* u_hat, void* v_out,
                                    void* c_out, int batch, int n_in,
                                    int n_out, int dim, int n_iters,
                                    int taylor, int is_bf16, int threads,
                                    void* stream) {
  using namespace fastcaps;
  if (batch <= 0 || n_in <= 0 || n_out <= 0 || dim <= 0 || n_iters <= 0 ||
      threads <= 0 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)fused_routing_smem_bytes(n_in, n_out, dim, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* c = static_cast<float*>(c_out);
  if (is_bf16) {
    return taylor
        ? launch_fused_routing<__nv_bfloat16, true>(
              u_hat, v_out, c, batch, n_in, n_out, dim, n_iters, threads, smem, s)
        : launch_fused_routing<__nv_bfloat16, false>(
              u_hat, v_out, c, batch, n_in, n_out, dim, n_iters, threads, smem, s);
  }
  return taylor
      ? launch_fused_routing<float, true>(
            u_hat, v_out, c, batch, n_in, n_out, dim, n_iters, threads, smem, s)
      : launch_fused_routing<float, false>(
            u_hat, v_out, c, batch, n_in, n_out, dim, n_iters, threads, smem, s);
}
