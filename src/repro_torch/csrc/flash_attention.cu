// Blocked GQA flash attention for Hopper (sm_90a), float32 inside.
//
// Replaces the TPU kernels repro/kernels/attention/kernel.py
// (_flash_kernel / flash_attention_pallas) and, with an int8 K/V type,
// (_flash_dequant_kernel / flash_attention_dequant_pallas).  It computes, for
// q (B, S, H, D) and k, v (B, T, K, D) with H = K * G,
//
//   out[b, i, h] = sum_t softmax_t(<q[b, i, h], k[b, t, h / G]> / sqrt(D)) v[b, t, h / G]
//
// with the causal mask t <= i + q_offset when asked, the exact exp or the
// Eq. 2 polynomial, and the online softmax of the TPU body: a running maximum
// m, denominator l and accumulator acc per query row, acc / max(l, 1e-30) at
// the end, NEG_INF = -1e30 (finite), p re-zeroed under the mask after the exp.
// The inputs are read in their own layout; the TPU entry's transposes to
// (B*K, G, S, D) are gone.  Dequantizing (TKV = int8_t): k, v hold int8 rows
// and ks, vs (B, T) one float32 scale per cache row, shared by the KV heads;
// each element is multiplied by its row's scale as the tile is converted to
// float32 (the TPU entry repeats the scales per KV head; here they are indexed
// by batch row).  The scales are per row, so the KV tiles need no alignment to
// the page length the rows were written in.
//
// What bounds it.  At the serving shapes the function is bound by operations
// (4 * S * T * D per query head, halved by the causal mask, against about
// 2 bytes per element of q, k, v and out), and the arithmetic is float32 on the
// FMA units: q is scaled by 1 / sqrt(D) in float32 before the dot, as in the
// TPU body, which the bf16 tensor cores could not reproduce.  A wgmma version
// with its own tolerance is later work.
//
// Design.  One block of 256 threads per (batch, kv-head, tile of q_block
// query positions).  The block holds all G query heads of its tile: 64 rows at
// most (G * q_block), 8 per warp, so K and V are read once per G heads.  The
// block walks the KV axis in tiles of 64 rows inside a loop (the TPU grid's
// sequential axis), converts each tile to float32 in shared memory, and keeps
// m, l and acc in registers.  Under the causal mask it stops at the last tile
// that the block's last query position can see.  A ragged last q tile or KV
// tile is masked, so no block size has to divide S or T.
//
//   scores  lane j of a warp owns KV columns j and j + 32 of the tile; q rows
//           come from shared memory as broadcast float4 loads, K rows from
//           shared memory with a row stride of D + 4 floats (no bank
//           conflicts for the 16-byte loads);
//   softmax row maximum and sum by xor shuffles (fixed order);
//   PV      lane j owns output dims j, j + 32, ...; p goes through a per-warp
//           shared buffer, V is read from shared memory.
//
// Every sum has a fixed order and there is no atomic, so two runs give the
// same bits.

#include <cmath>
#include <type_traits>

#include "approx_math.cuh"

namespace fastcaps {

constexpr float kNegInf = -1e30f;
constexpr int kFlashThreads = 256;
constexpr int kFlashWarps = kFlashThreads / 32;
constexpr int kFlashRows = 64;                  // query rows per block
constexpr int kRowsPerWarp = kFlashRows / kFlashWarps;
constexpr int kFlashKv = 64;                    // KV rows per tile

__device__ __forceinline__ float flash_warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float flash_warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr long long flash_smem_floats() {
  return (long long)kFlashRows * D            // Qs, scaled by 1 / sqrt(D)
         + (long long)kFlashKv * (D + 4)      // Ks, padded rows
         + (long long)kFlashKv * D            // Vs
         + (long long)kFlashRows * kFlashKv;  // Ps, kRowsPerWarp rows per warp
}

template <typename T, typename TKV, int D, bool kTaylor>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const T* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs, T* __restrict__ out, int S,
                       int T_len, int H, int K, int G, int q_block, int causal,
                       int q_offset, float scale) {
  constexpr bool kDequant = std::is_same<TKV, int8_t>::value;
  constexpr int DPL = (D + 31) / 32;            // output dims per lane
  constexpr int KS = D + 4;                     // Ks row stride
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kFlashRows * D;
  float* Vs = Ks + kFlashKv * KS;
  float* Ps = Vs + kFlashKv * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y / K;
  const int kvh = blockIdx.y % K;
  const int q0 = blockIdx.x * q_block;
  const int rows = G * q_block;                 // <= kFlashRows

  // row r of the block is position q0 + r / G of query head kvh * G + r % G
  for (int e = tid; e < kFlashRows * D; e += kFlashThreads) {
    const int r = e / D, d = e % D;
    const int i = q0 + r / G;
    float val = 0.0f;
    if (r < rows && i < S)
      val = load_f32(q + (((size_t)b * S + i) * H + kvh * G + r % G) * D + d) *
            scale;
    Qs[e] = val;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int i = q0 + r / G;
    live[rr] = r < rows && i < S;
    qpos[rr] = i + q_offset;
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[rr][c] = 0.0f;
  }

  const int q_last = min(q0 + q_block, S) - 1 + q_offset;
  const int kv_end = causal ? min(T_len, q_last + 1) : T_len;
  const int n_tiles = (kv_end + kFlashKv - 1) / kFlashKv;
  float* P = Ps + warp * kRowsPerWarp * kFlashKv;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kFlashKv;
    __syncthreads();                  // the last tile's Ks / Vs are read
    for (int e = tid; e < kFlashKv * D; e += kFlashThreads) {
      const int j = e / D, d = e % D;
      const int t = t0 + j;
      float kk = 0.0f, vv = 0.0f;
      if (t < T_len) {
        const size_t off = (((size_t)b * T_len + t) * K + kvh) * D + d;
        kk = load_f32(k + off);
        vv = load_f32(v + off);
        if (kDequant) {
          kk *= ks[(size_t)b * T_len + t];
          vv *= vs[(size_t)b * T_len + t];
        }
      }
      Ks[j * KS + d] = kk;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    // scores of this warp's rows against columns lane and lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr][0] = s[rr][1] = 0.0f;
    const float* k0 = Ks + lane * KS;
    const float* k1 = Ks + (lane + 32) * KS;
    const float* qw = Qs + warp * kRowsPerWarp * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(k0 + d);
      const float4 a1 = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 x = *reinterpret_cast<const float4*>(qw + rr * D + d);
        s[rr][0] += x.x * a0.x + x.y * a0.y + x.z * a0.z + x.w * a0.w;
        s[rr][1] += x.x * a1.x + x.y * a1.y + x.z * a1.z + x.w * a1.w;
      }
    }

    // online softmax, row by row
    const int tc0 = t0 + lane, tc1 = t0 + lane + 32;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool ok0 = tc0 < T_len && (!causal || tc0 <= qpos[rr]);
      const bool ok1 = tc1 < T_len && (!causal || tc1 <= qpos[rr]);
      const float s0 = ok0 ? s[rr][0] : kNegInf;
      const float s1 = ok1 ? s[rr][1] : kNegInf;
      const float m_new = fmaxf(m[rr], flash_warp_max(fmaxf(s0, s1)));
      const float alpha = softmax_exp<kTaylor>(m[rr] - m_new);
      const float p0 = ok0 ? softmax_exp<kTaylor>(s0 - m_new) : 0.0f;
      const float p1 = ok1 ? softmax_exp<kTaylor>(s1 - m_new) : 0.0f;
      l[rr] = l[rr] * alpha + flash_warp_sum(p0 + p1);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[rr][c] *= alpha;
      P[rr * kFlashKv + lane] = p0;
      P[rr * kFlashKv + lane + 32] = p1;
    }
    __syncwarp();

    // acc += p @ V
#pragma unroll 2
    for (int j = 0; j < kFlashKv; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          vv[u][c] = d < D ? Vs[(j + u) * D + d] : 0.0f;
        }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 p = *reinterpret_cast<const float4*>(P + rr * kFlashKv + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[rr][c] += p.x * vv[0][c] + p.y * vv[1][c] + p.z * vv[2][c] +
                        p.w * vv[3][c];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (!live[rr]) continue;
    const int r = warp * kRowsPerWarp + rr;
    const int i = q0 + r / G;
    const float den = fmaxf(l[rr], 1e-30f);
    T* o = out + (((size_t)b * S + i) * H + kvh * G + r % G) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store_f32(o + d, acc[rr][c] / den);
    }
  }
}

template <typename T, typename TKV, int D, bool kTaylor>
int launch_flash(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, void* out, int B, int S, int T_len, int H,
                 int K, int q_block, int causal, int q_offset,
                 cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, TKV, D, kTaylor>;
  const size_t smem = flash_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + q_block - 1) / q_block, B * K);
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, static_cast<T*>(out), S, T_len, H,
      K, H / K, q_block, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TKV, bool kTaylor>
int dispatch_flash(int D, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, void* out, int B, int S,
                   int T_len, int H, int K, int q_block, int causal,
                   int q_offset, cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash<T, TKV, 16, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    case 32: return launch_flash<T, TKV, 32, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    case 64: return launch_flash<T, TKV, 64, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    case 128: return launch_flash<T, TKV, 128, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TKV>
int dispatch_flash_mode(int taylor, int D, const void* q, const void* k,
                        const void* v, const float* ks, const float* vs,
                        void* out, int B, int S, int T_len, int H, int K,
                        int q_block, int causal, int q_offset,
                        cudaStream_t s) {
  return taylor
      ? dispatch_flash<T, TKV, true>(D, q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s)
      : dispatch_flash<T, TKV, false>(D, q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
}

inline bool flash_shape_ok(int B, int S, int T_len, int H, int K, int q_block,
                    int q_offset) {
  return B > 0 && S > 0 && T_len > 0 && K > 0 && H % K == 0 && q_block > 0 &&
         (H / K) * q_block <= kFlashRows && q_offset >= 0;
}

}  // namespace fastcaps

// q, out (B, S, H, D); k, v (B, T, K, D); all contiguous, one type: float32
// (is_bf16 = 0) or bfloat16 (1).  H a multiple of K, D in {16, 32, 64, 128},
// q_block a power of two with (H / K) * q_block <= kFlashRows (FLASH_ROWS in
// kernels/attention/kernel.py, which a CPU test holds equal to this file).
// Launches on `stream`, does not synchronise, allocates nothing.  Returns the
// CUDA error code of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T_len, int H, int K, int D,
                                      int q_block, int causal, int q_offset,
                                      int taylor, int is_bf16, void* stream) {
  using namespace fastcaps;
  if (!flash_shape_ok(B, S, T_len, H, K, q_block, q_offset))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_flash_mode<__nv_bfloat16, __nv_bfloat16>(
        taylor, D, q, k, v, nullptr, nullptr, out, B, S, T_len, H, K, q_block,
        causal, q_offset, s);
  return dispatch_flash_mode<float, float>(
      taylor, D, q, k, v, nullptr, nullptr, out, B, S, T_len, H, K, q_block,
      causal, q_offset, s);
}

// The dequantizing variant: q, out (B, S, H, D) float32 (q_bf16 = 0) or
// bfloat16 (1); kq, vq (B, T, K, D) int8; ks, vs (B, T) float32 per-row
// scales; all contiguous.  The other arguments and the return value are
// flash_attention_launch's.
extern "C" int flash_attention_dequant_launch(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, void* out, int B, int S, int T_len, int H, int K, int D,
    int q_block, int causal, int q_offset, int taylor, int q_bf16,
    void* stream) {
  using namespace fastcaps;
  if (!flash_shape_ok(B, S, T_len, H, K, q_block, q_offset) || ks == nullptr ||
      vs == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  if (q_bf16)
    return dispatch_flash_mode<__nv_bfloat16, int8_t>(
        taylor, D, q, kq, vq, ksf, vsf, out, B, S, T_len, H, K, q_block,
        causal, q_offset, s);
  return dispatch_flash_mode<float, int8_t>(
      taylor, D, q, kq, vq, ksf, vsf, out, B, S, T_len, H, K, q_block, causal,
      q_offset, s);
}
