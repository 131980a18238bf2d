// q_len = 1 GQA decode attention for Hopper (sm_90a): one templated body for
// the four cache layouts of the TPU kernels it replaces.
//
// Replaces, in repro/kernels/attention/kernel.py:
//   dense      decode_attention_pallas                (_decode_kernel)
//   int8       decode_attention_dequant_pallas        (_decode_dequant_kernel)
//   paged      decode_attention_paged_pallas          (_decode_kernel over pages)
//   paged_int8 decode_attention_paged_dequant_pallas  (_decode_dequant_kernel over pages)
//
// For each slot b it computes, over the first n = min(valid[b], T) cache rows,
//
//   out[b, h] = sum_{t < n} softmax_t(<q[b, h], k[b, t, h / G]> / sqrt(D)) v[b, t, h / G]
//
// float32 inside, exact exp or the Eq. 2 polynomial, and zeros for a slot
// with n = 0 (the TPU kernel's init state is never overwritten for it).
//
// Cache layouts.  Dense: k, v (B, T, K, D), row t of slot b at storage row
// b * T + t.  Paged (kPaged): k, v are the pool's (n_pages, page, K, D)
// leaves and tables (B, P) maps a slot's page index to a pool page; row t of
// slot b is at storage row pid * page + t % page with
// pid = clamp(tables[b, t / page], 0, n_pages - 1), so T = P * page.  The
// TPU's scalar-prefetch index_map becomes a plain load of the table inside
// the loop.  int8 (TKV = int8_t): k, v hold int8 rows and ks, vs one float32
// scale per storage row, shared by the KV heads ((B, T) dense, (n_pages, page)
// paged: in both layouts the scale's index is the storage row's).
//
// What bounds it.  Bytes: every valid cache row of K and V is read once
// (2 * n * D elements per slot and KV head, plus one scale per row for int8)
// for 4 * G * D operations per row, far below the card's ratio of operations
// to bytes.  The design reads each slot's cache only up to its own valid
// length (the TPU body reads every slot up to the largest length of the
// batch; its paged grid skips pages past the length with pl.when), so a paged
// slot touches only its own resident pages, and reads each row once for all
// G query heads of its KV head.
//
// Design.  One block per (slot, kv-head), which loops over the cache itself
// (no split across blocks: there is no second pass).  The block's warps take
// 32-row tiles of the slot's valid rows in turn, each warp with its own online
// softmax state (m, l, acc for the G heads), and the warps' states are joined
// at the end by a log-sum-exp combine in a fixed order.
//
//   rows    lane j of a warp resolves the storage row of the tile's row j
//           (the page-table load, paged) and, int8, its two scales; the tile
//           load takes each row's address from its lane by a shuffle, so a
//           tile may straddle pages (page < 32) at no extra cost;
//   scores  a warp copies its K tile to shared memory as float32 (row stride
//           D + 1: no bank conflicts), then lane j scores row j against the
//           G query rows (broadcast from shared memory); int8 multiplies the
//           score by the row's K scale;
//   softmax maximum and sum over the tile by xor shuffles;
//   PV      the warp copies its V tile to shared memory beside the K tile
//           (both loads coalesced along D and in flight together); lane j
//           owns output dims j, j + 32, ...; p comes from a per-warp shared
//           buffer, int8 with the row's V scale folded in.
//
// No atomics and fixed orders throughout, so two runs give the same bits;
// the dense and paged bodies of one cache type run the same sums in the same
// order, so they agree bit for bit on the same rows.

#include <cmath>
#include <type_traits>

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

// One launch's operands.  tables is null for a dense cache, ks and vs are
// null unless the cache is int8.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* valid;
  const int* tables;
  const float* ks;
  const float* vs;
  void* out;
  int T_len;      // rows per slot (P * page when paged)
  int K;
  int G;
  int P;          // pages per slot (paged)
  int page;       // rows per page (paged)
  int n_pages;    // pool pages (paged)
  float scale;
};

template <typename TQ, typename TKV, int D, bool kTaylor, bool kPaged>
__global__ void __launch_bounds__(512)
decode_attention_kernel(const DecodeArgs a) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int DPL = (D + 31) / 32;
  constexpr int KS = D + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kw = Qs + kDecodeMaxG * D;               // per warp: K, V, p
  const int warps = blockDim.x >> 5;
  const TQ* q = static_cast<const TQ*>(a.q);
  TQ* out = static_cast<TQ*>(a.out);
  const int K = a.K, G = a.G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / K;
  const int h = blockIdx.x % K;
  const int H = K * G;
  const int n = max(0, min(a.valid[b], a.T_len));

  for (int e = tid; e < G * D; e += blockDim.x)
    Qs[e] = load_f32(q + ((size_t)b * H + h * G) * D + e) * a.scale;
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
  const long long row_stride = (long long)K * D;
  const TKV* kh = static_cast<const TKV*>(a.k) + (size_t)h * D;
  const TKV* vh = static_cast<const TKV*>(a.v) + (size_t)h * D;

  for (int t0 = warp * kDecodeTile; t0 < n; t0 += warps * kDecodeTile) {
    const int rows = min(kDecodeTile, n - t0);
    // lane j: the storage row of cache row t0 + j, and its scales
    long long my_row = 0;
    float my_ks = 1.0f, my_vs = 1.0f;
    if (lane < rows) {
      const int t = t0 + lane;
      if (kPaged) {
        int pid = a.tables[(size_t)b * a.P + t / a.page];
        pid = min(max(pid, 0), a.n_pages - 1);
        my_row = (long long)pid * a.page + t % a.page;
      } else {
        my_row = (long long)b * a.T_len + t;
      }
      if (kInt8) {
        my_ks = a.ks[my_row];
        my_vs = a.vs[my_row];
      }
    }
#pragma unroll 8
    for (int e = lane; e < kDecodeTile * D; e += 32) {
      const int j = e / D, d = e % D;
      const long long row = __shfl_sync(0xffffffffu, my_row, j);
      float kk = 0.0f, vv = 0.0f;
      if (j < rows) {
        kk = load_f32(kh + row * row_stride + d);
        vv = load_f32(vh + row * row_stride + d);
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
      const float sg = ok ? (kInt8 ? s[g] * my_ks : s[g]) : kDecodeNegInf;
      const float m_new = fmaxf(m[g], decode_warp_max(sg));
      const float alpha = softmax_exp<kTaylor>(m[g] - m_new);
      const float p = ok ? softmax_exp<kTaylor>(sg - m_new) : 0.0f;
      l[g] = l[g] * alpha + decode_warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[g][c] *= alpha;
      P[g * kDecodeTile + lane] = kInt8 ? p * my_vs : p;
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

template <typename TQ, typename TKV, int D, bool kTaylor, bool kPaged>
int launch_decode(const DecodeArgs& a, int B, int threads,
                  cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TKV, D, kTaylor, kPaged>;
  const size_t smem = decode_smem_floats(D, threads / 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * a.K, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, bool kTaylor, bool kPaged>
int dispatch_decode_d(int D, const DecodeArgs& a, int B, int threads,
                      cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<TQ, TKV, 16, kTaylor, kPaged>(a, B, threads, s);
    case 32: return launch_decode<TQ, TKV, 32, kTaylor, kPaged>(a, B, threads, s);
    case 64: return launch_decode<TQ, TKV, 64, kTaylor, kPaged>(a, B, threads, s);
    case 128: return launch_decode<TQ, TKV, 128, kTaylor, kPaged>(a, B, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
int dispatch_decode(int taylor, int paged, int D, const DecodeArgs& a, int B,
                    int threads, cudaStream_t s) {
  if (paged)
    return taylor ? dispatch_decode_d<TQ, TKV, true, true>(D, a, B, threads, s)
                  : dispatch_decode_d<TQ, TKV, false, true>(D, a, B, threads, s);
  return taylor ? dispatch_decode_d<TQ, TKV, true, false>(D, a, B, threads, s)
                : dispatch_decode_d<TQ, TKV, false, false>(D, a, B, threads, s);
}

}  // namespace fastcaps

// q, out (B, 1, H, D) with H = K * G, contiguous.  Dense cache (tables null):
// k, v (B, T, K, D).  Paged cache: k, v (n_pages, page, K, D) and tables
// (B, P) int32 with T = P * page.  kv_type 0 = float32, 1 = bfloat16,
// 2 = int8 with ks, vs float32 per-row scales ((B, T) dense, (n_pages, page)
// paged; null otherwise).  valid (B,) int32.  q and out are float32
// (q_bf16 = 0) or bfloat16 (1); bfloat16 q takes a bfloat16 or int8 cache.
// D in {16, 32, 64, 128}, G <= kDecodeMaxG, threads a multiple of 32 in
// [32, 512] whose shared memory fits a block.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid,
    const void* tables, const void* ks, const void* vs, void* out, int B,
    int T_len, int H, int K, int D, int P, int page, int n_pages, int taylor,
    int q_bf16, int kv_type, int threads, void* stream) {
  using namespace fastcaps;
  const bool paged = tables != nullptr;
  const bool int8 = kv_type == 2;
  if (B <= 0 || T_len <= 0 || K <= 0 || H % K != 0 || H / K > kDecodeMaxG ||
      threads < 32 || threads > 512 || threads % 32 != 0 || kv_type < 0 ||
      kv_type > 2 || (q_bf16 && kv_type == 0) ||
      int8 != (ks != nullptr && vs != nullptr) ||
      (paged && (P <= 0 || page <= 0 || n_pages <= 0 || T_len != P * page)))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid = static_cast<const int*>(valid);
  a.tables = static_cast<const int*>(tables);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.out = out;
  a.T_len = T_len;
  a.K = K;
  a.G = H / K;
  a.P = P;
  a.page = page;
  a.n_pages = n_pages;
  a.scale = (float)(1.0 / std::sqrt((double)D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return int8 ? dispatch_decode<__nv_bfloat16, int8_t>(taylor, paged, D, a, B, threads, s)
                : dispatch_decode<__nv_bfloat16, __nv_bfloat16>(taylor, paged, D, a, B, threads, s);
  if (int8)
    return dispatch_decode<float, int8_t>(taylor, paged, D, a, B, threads, s);
  if (kv_type == 1)
    return dispatch_decode<float, __nv_bfloat16>(taylor, paged, D, a, B, threads, s);
  return dispatch_decode<float, float>(taylor, paged, D, a, B, threads, s);
}
