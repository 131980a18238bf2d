// q_len = 1 GQA decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py
// (_decode_kernel / decode_attention_pallas), the dense body only.  For each
// slot b it computes, over the first n = min(valid[b], T) cache rows,
//
//   out[b, h] = sum_{t < n} softmax_t(<q[b, h], k[b, t, h / G]> / sqrt(D)) v[b, t, h / G]
//
// float32 inside, exact exp or the Eq. 2 polynomial, and zeros for a slot
// with n = 0 (the TPU kernel's init state is never overwritten for it).
//
// What bounds it.  Bytes: every valid cache row of K and V is read once
// (2 * n * D elements per slot and KV head) for 4 * G * D operations per row,
// far below the card's ratio of operations to bytes.  The design reads each
// slot's cache only up to its own valid length (the TPU body reads every slot
// up to the largest length of the batch) and reads each row once for all G
// query heads of its KV head.
//
// Design.  One block per (slot, kv-head), which loops over the cache itself
// (no split across blocks: there is no second pass).  The block's warps take
// 32-row tiles of the slot's valid rows in turn, each warp with its own online
// softmax state (m, l, acc for the G heads), and the warps' states are joined
// at the end by a log-sum-exp combine in a fixed order.
//
//   scores  a warp copies its K tile to shared memory as float32 (row stride
//           D + 1: no bank conflicts), then lane j scores row j against the
//           G query rows (broadcast from shared memory);
//   softmax maximum and sum over the tile by xor shuffles;
//   PV      the warp copies its V tile to shared memory beside the K tile
//           (both loads coalesced along D and in flight together); lane j
//           owns output dims j, j + 32, ...; p comes from a per-warp shared
//           buffer.
//
// No atomics and fixed orders throughout, so two runs give the same bits.

#include <cmath>

#include "approx_math.cuh"

namespace fastcaps {

constexpr float kDecodeNegInf = -1e30f;
constexpr int kDecodeMaxG = 8;       // query heads per KV head
constexpr int kDecodeTile = 32;      // cache rows per warp tile

__device__ __forceinline__ float decode_warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float decode_warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory of one block, in floats: the scaled queries, and per warp
// one K tile, one V tile and one p buffer.  The combine at the end reuses
// the tiles.  decode_smem_bytes in kernels/attention/kernel.py plans block
// sizes by the same sum; a CPU test holds the two equal.
__host__ __device__ inline long long decode_warp_floats(int d) {
  return (long long)kDecodeTile * (d + 1) + (long long)kDecodeTile * d +
         (long long)kDecodeMaxG * kDecodeTile;
}

__host__ __device__ inline long long decode_smem_floats(int d, int warps) {
  return (long long)kDecodeMaxG * d + warps * decode_warp_floats(d);
}

template <typename TQ, typename TKV, int D, bool kTaylor>
__global__ void __launch_bounds__(512)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int* __restrict__ valid, TQ* __restrict__ out,
                        int T_len, int K, int G, float scale) {
  constexpr int DPL = (D + 31) / 32;
  constexpr int KS = D + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kw = Qs + kDecodeMaxG * D;               // per warp: K, V, p
  const int warps = blockDim.x >> 5;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / K;
  const int h = blockIdx.x % K;
  const int H = K * G;
  const int n = max(0, min(valid[b], T_len));

  for (int e = tid; e < G * D; e += blockDim.x)
    Qs[e] = load_f32(q + ((size_t)b * H + h * G) * D + e) * scale;
  __syncthreads();

  float m[kDecodeMaxG], l[kDecodeMaxG], acc[kDecodeMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kDecodeMaxG; ++g) {
    m[g] = kDecodeNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[g][c] = 0.0f;
  }

  float* Kt = Kw + warp * decode_warp_floats(D);
  float* Vt = Kt + kDecodeTile * KS;
  float* P = Vt + kDecodeTile * D;
  const size_t row_stride = (size_t)K * D;
  const TKV* kb = k + (size_t)b * T_len * row_stride + (size_t)h * D;
  const TKV* vb = v + (size_t)b * T_len * row_stride + (size_t)h * D;

  for (int t0 = warp * kDecodeTile; t0 < n; t0 += warps * kDecodeTile) {
    const int rows = min(kDecodeTile, n - t0);
#pragma unroll 8
    for (int e = lane; e < kDecodeTile * D; e += 32) {
      const int j = e / D, d = e % D;
      float kk = 0.0f, vv = 0.0f;
      if (j < rows) {
        kk = load_f32(kb + (t0 + j) * row_stride + d);
        vv = load_f32(vb + (t0 + j) * row_stride + d);
      }
      Kt[j * KS + d] = kk;
      Vt[j * D + d] = vv;
    }
    __syncwarp();

    const bool ok = lane < rows;
    float s[kDecodeMaxG];
#pragma unroll
    for (int g = 0; g < kDecodeMaxG; ++g) s[g] = 0.0f;
    const float* kr = Kt + lane * KS;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int g = 0; g < kDecodeMaxG; ++g)
        if (g < G) s[g] += Qs[g * D + d] * kd;
    }

#pragma unroll
    for (int g = 0; g < kDecodeMaxG; ++g) {
      if (g >= G) break;
      const float sg = ok ? s[g] : kDecodeNegInf;
      const float m_new = fmaxf(m[g], decode_warp_max(sg));
      const float alpha = softmax_exp<kTaylor>(m[g] - m_new);
      const float p = ok ? softmax_exp<kTaylor>(sg - m_new) : 0.0f;
      l[g] = l[g] * alpha + decode_warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[g][c] *= alpha;
      P[g * kDecodeTile + lane] = p;
    }
    __syncwarp();

    for (int j = 0; j < rows; ++j) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d >= D) break;
        const float vd = Vt[j * D + d];
#pragma unroll
        for (int g = 0; g < kDecodeMaxG; ++g)
          if (g < G) acc[g][c] += P[g * kDecodeTile + j] * vd;
      }
    }
    __syncwarp();
  }

  // join the warps' states: (m, l) then acc, per warp and head, in the
  // tiles' space
  __syncthreads();
  float* Ms = Kw;                                 // warps x G
  float* Ls = Ms + warps * kDecodeMaxG;           // warps x G
  float* As = Ls + warps * kDecodeMaxG;           // warps x G x D
#pragma unroll
  for (int g = 0; g < kDecodeMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      Ms[warp * kDecodeMaxG + g] = m[g];
      Ls[warp * kDecodeMaxG + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) As[(warp * kDecodeMaxG + g) * D + d] = acc[g][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mt = kDecodeNegInf;
    for (int w = 0; w < warps; ++w) mt = fmaxf(mt, Ms[w * kDecodeMaxG + g]);
    float lt = 0.0f, at = 0.0f;
    for (int w = 0; w < warps; ++w) {
      const float f = softmax_exp<kTaylor>(Ms[w * kDecodeMaxG + g] - mt);
      lt += Ls[w * kDecodeMaxG + g] * f;
      at += As[(w * kDecodeMaxG + g) * D + d] * f;
    }
    store_f32(out + ((size_t)b * H + h * G) * D + e, at / fmaxf(lt, 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, bool kTaylor>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* valid, void* out, int B, int T_len, int K,
                  int G, int threads, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TKV, D, kTaylor>;
  const size_t smem = decode_smem_floats(D, threads / 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<B * K, threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), valid, static_cast<TQ*>(out), T_len, K, G,
      scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, bool kTaylor>
int dispatch_decode(int D, const void* q, const void* k, const void* v,
                    const int* valid, void* out, int B, int T_len, int K,
                    int G, int threads, cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<TQ, TKV, 16, kTaylor>(q, k, v, valid, out, B, T_len, K, G, threads, s);
    case 32: return launch_decode<TQ, TKV, 32, kTaylor>(q, k, v, valid, out, B, T_len, K, G, threads, s);
    case 64: return launch_decode<TQ, TKV, 64, kTaylor>(q, k, v, valid, out, B, T_len, K, G, threads, s);
    case 128: return launch_decode<TQ, TKV, 128, kTaylor>(q, k, v, valid, out, B, T_len, K, G, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
int dispatch_decode_mode(int taylor, int D, const void* q, const void* k,
                         const void* v, const int* valid, void* out, int B,
                         int T_len, int K, int G, int threads,
                         cudaStream_t s) {
  return taylor
      ? dispatch_decode<TQ, TKV, true>(D, q, k, v, valid, out, B, T_len, K, G, threads, s)
      : dispatch_decode<TQ, TKV, false>(D, q, k, v, valid, out, B, T_len, K, G, threads, s);
}

}  // namespace fastcaps

// q, out (B, 1, H, D) with H = K * G; k, v (B, T, K, D); valid (B,) int32;
// all contiguous.  q and out are float32 (q_bf16 = 0) or bfloat16 (1); k and
// v share a type, float32 (kv_bf16 = 0) or bfloat16 (1); bfloat16 q takes a
// bfloat16 cache only.  D in {16, 32, 64, 128}, G <= kDecodeMaxG, threads a
// multiple of 32 in [32, 512] whose shared memory fits a block.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* out, int B, int T_len, int H,
                                       int K, int D, int taylor, int q_bf16,
                                       int kv_bf16, int threads,
                                       void* stream) {
  using namespace fastcaps;
  if (B <= 0 || T_len <= 0 || K <= 0 || H % K != 0 || H / K > kDecodeMaxG ||
      threads < 32 || threads > 512 || threads % 32 != 0 ||
      (q_bf16 && !kv_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid);
  const int G = H / K;
  if (q_bf16)
    return dispatch_decode_mode<__nv_bfloat16, __nv_bfloat16>(
        taylor, D, q, k, v, vl, out, B, T_len, K, G, threads, s);
  if (kv_bf16)
    return dispatch_decode_mode<float, __nv_bfloat16>(
        taylor, D, q, k, v, vl, out, B, T_len, K, G, threads, s);
  return dispatch_decode_mode<float, float>(
      taylor, D, q, k, v, vl, out, B, T_len, K, G, threads, s);
}
