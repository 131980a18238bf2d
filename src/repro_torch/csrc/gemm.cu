// Fixed-order matrix product for Hopper (sm_90a): y = x @ w.
//
// Replaces no TPU kernel: the reference leaves its projections to XLA's dot
// (src/repro/models/mlp.py, attention.py, common.py).  It was added because
// a cuBLAS GEMM gives one request's rows other bits when other rows share
// the call: cuBLAS picks its tile, split-K and reduction order from M, so a
// prompt prefilled alone and the same prompt prefilled among seven others
// got other logits (ROADMAP §C Open 1).  Here nothing that decides a row's
// sums reads M:
//
//   * one CTA tile (kGemmBM x kGemmBN, kGemmBK deep) and one instruction
//     shape for every M; output row r always lands in CTA row r / kGemmBM,
//     in the same warp and thread, whatever the other rows are;
//   * each output tile's K loop runs whole inside its CTA, over K in
//     ascending kGemmBK steps (k16 steps inside): no split-K, no stream-K;
//   * rows past M, columns past N and depth past K are loaded as zeros
//     (cp.async zero fill) and not stored; a zero term adds nothing to a
//     sum, so the ragged edge changes no row's bits;
//   * where M <= kGemmSmallM (a decode tick's slots) every row lies in warp
//     0's first 16-row block, and only that block is multiplied: the other
//     blocks hold rows past M alone.  Rows never share an accumulator, so a
//     stored row gets the same instructions in the same order as in the
//     full body, whose codegen this instance leaves as it is (a runtime
//     test of each block inside the full body slowed it by a fifth).
//
// x (M, K) row-major; w either (K, N) row-major ("kn": a projection's
// weight as stored, N contiguous) or (N, K) row-major ("nk": a tied
// embedding table read as its transpose), read as stored, with no copy.
// bf16 operands, float32 accumulation in the tensor cores (mma.sync
// m16n8k16), one rounding to bf16 at the end.  A float32 body (FMA,
// 64 x 64 tiles, K ascending one element at a time) serves float32 compute
// under the same rule.
//
// Bound: at prefill shapes by operations (2 M N K at the bf16 tensor-core
// peak), at decode shapes (M = a tick's slots) by the bytes of w.  This
// first body is a plain multistage mma.sync GEMM: a ring of kGemmStages
// cp.async stages of A and B tiles in swizzled shared memory (conflict-free
// ldmatrix), 8 warps of 64 x 32 outputs each.  No wgmma or TMA yet; its
// time against cuBLAS is in PERF.md.

#include "launch.cuh"
#include "wgmma.cuh"

namespace fastcaps {

constexpr int kGemmBM = 128;            // output rows of a CTA
constexpr int kGemmBN = 128;            // output columns of a CTA
constexpr int kGemmBK = 64;             // depth of one pipeline stage
constexpr int kGemmStages = 6;          // stages in the ring
constexpr int kGemmSmallM = 16;         // rows of the one-block instance
constexpr int kGemmThreads = 256;       // 8 warps: 2 (M) x 4 (N)
constexpr int kGemmTileBytes = kGemmBM * kGemmBK * 2;   // A or B of a stage
static_assert(kGemmBN * kGemmBK * 2 == kGemmTileBytes, "B tile size");
constexpr int kGemmSmem = kGemmStages * 2 * kGemmTileBytes;
constexpr int kGemmMaxSmem = 232448;    // bytes a block may ask for
static_assert(kGemmSmem <= kGemmMaxSmem, "gemm shared memory");
constexpr int kGemmF32Tile = 64;        // the float32 body's tile
constexpr int kGemmF32K = 16;

// A tile, and B in "nk": rows of kGemmBK elements (128 bytes, 8 chunks of
// 16), the chunk index XORed with the row's low 3 bits: the 8 rows one
// ldmatrix reads fall in 8 distinct 4-bank groups.
__device__ __forceinline__ uint32_t row128_offset(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}
// B in "kn": kGemmBK rows (k) of kGemmBN elements (256 bytes, 16 chunks),
// the chunk index XORed with the row's low 3 bits.
__device__ __forceinline__ uint32_t row256_offset(int row, int chunk) {
  return (uint32_t)(row * 256 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kLive: the 16-row blocks a warp multiplies, 4 (all) or 1 (warp 0's
// first, M <= kGemmSmallM; the other warps only load)
template <bool kNK, int kLive>
__global__ void __launch_bounds__(kGemmThreads)
    fixed_order_gemm_bf16(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, int M, int N,
                          int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;        // warp's 64 x 32 outputs
  const long long m0 = (long long)blockIdx.y * kGemmBM;
  const long long n0 = (long long)blockIdx.x * kGemmBN;
  const int kt_n = (K + kGemmBK - 1) / kGemmBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kGemmBK;
    const uint32_t sa = base + stage * 2 * kGemmTileBytes;
    const uint32_t sb = sa + kGemmTileBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {                  // A: 128 rows x 8 chunks
      const int e = tid + i * kGemmThreads, r = e >> 3, c = e & 7;
      const long long gr = m0 + r;
      const int gk = k0 + c * 8;
      const bool ok = gr < M && gk < K;
      cp_async16(sa + row128_offset(r, c), ok ? x + gr * K + gk : x, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kGemmThreads;
      if constexpr (kNK) {                         // 128 rows (n) x 8 chunks
        const int r = e >> 3, c = e & 7;
        const long long gn = n0 + r;
        const int gk = k0 + c * 8;
        const bool ok = gn < N && gk < K;
        cp_async16(sb + row128_offset(r, c), ok ? w + gn * K + gk : w, ok);
      } else {                                     // 64 rows (k) x 16 chunks
        const int r = e >> 4, c = e & 15;
        const long long gk = k0 + r;
        const long long gn = n0 + c * 8;
        const bool ok = gk < K && gn < N;
        cp_async16(sb + row256_offset(r, c), ok ? w + gk * N + gn : w, ok);
      }
    }
  };

  static_assert(kLive == 4 || kLive * 16 == kGemmSmallM, "live blocks");
  const bool computes = kLive == 4 || wm == 0;
  float acc[kLive][4][4];
#pragma unroll
  for (int i = 0; i < kLive; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < kt_n) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait_group<kGemmStages - 2>();        // stage kt has landed
    __syncthreads();                               // ... for every thread,
    const int next = kt + kGemmStages - 1;         // and kt - 1's is free
    if (next < kt_n) load(next % kGemmStages, next);
    cp_async_commit();
    const uint32_t sa = base + (kt % kGemmStages) * 2 * kGemmTileBytes;
    const uint32_t sb = sa + kGemmTileBytes;
#pragma unroll
    for (int ks = 0; ks < kGemmBK / 16; ++ks) {
      if (!computes) break;                        // warp-uniform
      uint32_t a[kLive][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < kLive; ++mi)
        ldmatrix_x4(a[mi], sa + row128_offset(wm * 64 + mi * 16 + (lane & 15),
                                              ks * 2 + (lane >> 4)));
#pragma unroll
      for (int nj2 = 0; nj2 < 2; ++nj2) {
        uint32_t r[4];
        if constexpr (kNK) {
          ldmatrix_x4(r, sb + row128_offset(
                             wn * 32 + nj2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                             ks * 2 + ((lane >> 3) & 1)));
        } else {
          ldmatrix_x4_trans(r, sb + row256_offset(
                                   ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   (wn * 32 + nj2 * 16) / 8 + (lane >> 4)));
        }
        b[nj2 * 2][0] = r[0];
        b[nj2 * 2][1] = r[1];
        b[nj2 * 2 + 1][0] = r[2];
        b[nj2 * 2 + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kLive; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16_16816(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
    }
  }
  cp_async_wait_all();
  if (!computes) return;

#pragma unroll
  for (int mi = 0; mi < kLive; ++mi) {
    const long long r = m0 + wm * 64 + mi * 16 + (lane >> 2);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const long long c = n0 + wn * 32 + nj * 8 + (lane & 3) * 2;
      if (c >= N) continue;
      if (r < M)
        *reinterpret_cast<uint32_t*>(y + r * N + c) =
            pack_bf16x2(acc[mi][nj][0], acc[mi][nj][1]);
      if (r + 8 < M)
        *reinterpret_cast<uint32_t*>(y + (r + 8) * N + c) =
            pack_bf16x2(acc[mi][nj][2], acc[mi][nj][3]);
    }
  }
}

// The float32 body: a 64 x 64 tile a CTA, 4 x 4 outputs a thread, each a
// chain of fmaf over k = 0, 1, ..., K - 1.
template <bool kNK>
__global__ void __launch_bounds__(256)
    fixed_order_gemm_f32(const float* __restrict__ x,
                         const float* __restrict__ w, float* __restrict__ y,
                         int M, int N, int K) {
  constexpr int T = kGemmF32Tile, BK = kGemmF32K;
  __shared__ float as[BK][T + 4];                 // [k][m]
  __shared__ float bs[BK][T + 4];                 // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * T;
  const long long n0 = (long long)blockIdx.x * T;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < T * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      const long long gr = m0 + r;
      const int gk = k0 + c;
      as[c][r] = (gr < M && gk < K) ? x[gr * K + gk] : 0.f;
      if constexpr (kNK) {
        const long long gn = n0 + r;
        bs[c][r] = (gn < N && gk < K) ? w[gn * K + gk] : 0.f;
      } else {
        const int kk = e / T, n = e % T;
        const long long gn = n0 + n;
        bs[kk][n] = (k0 + kk < K && gn < N) ? w[(long long)(k0 + kk) * N + gn]
                                            : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[kk][ty * 4 + i];
        b[i] = bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = n0 + tx * 4 + j;
      if (c < N) y[r * N + c] = acc[i][j];
    }
  }
}

template <bool kNK, int kLive>
int launch_gemm_bf16(const void* x, const void* w, void* y, int m, int n,
                     int k, int device, cudaStream_t stream) {
  auto kernel = fixed_order_gemm_bf16<kNK, kLive>;
  // the dynamic shared memory limit, set once per instance and device
  static cudaError_t err[kMaxDevices];
  static bool set[kMaxDevices];
  if (!set[device]) {
    err[device] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    set[device] = true;
  }
  if (err[device] != cudaSuccess) return (int)err[device];
  const dim3 grid((n + kGemmBN - 1) / kGemmBN, (m + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      m, n, k);
  return (int)cudaGetLastError();
}

template <bool kNK>
int launch_gemm_f32(const void* x, const void* w, void* y, int m, int n,
                    int k, cudaStream_t stream) {
  const dim3 grid((n + kGemmF32Tile - 1) / kGemmF32Tile,
                  (m + kGemmF32Tile - 1) / kGemmF32Tile);
  fixed_order_gemm_f32<kNK><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace fastcaps

// x (m, k) and y (m, n) contiguous; w (k, n) contiguous, or with w_nk = 1
// (n, k) contiguous; one type, bf16 (is_bf16 = 1: n and k multiples of 8,
// every operand 16-byte aligned) or float32.  y = x @ w with float32
// accumulation, one K order for every m.  Launches on `stream`, does not
// synchronise, allocates nothing; returns the CUDA error code of the launch.
extern "C" int fixed_order_matmul_launch(const void* x, const void* w,
                                         void* y, int m, int n, int k,
                                         int w_nk, int is_bf16, int device,
                                         void* stream) {
  using namespace fastcaps;
  if (m <= 0 || n <= 0 || k <= 0 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && (n % 8 || k % 8)) return (int)cudaErrorInvalidValue;
  const int tile = is_bf16 ? kGemmBM : kGemmF32Tile;
  if ((m + tile - 1) / tile > 65535) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && m <= kGemmSmallM)
    return w_nk ? launch_gemm_bf16<true, 1>(x, w, y, m, n, k, device, s)
                : launch_gemm_bf16<false, 1>(x, w, y, m, n, k, device, s);
  if (is_bf16)
    return w_nk ? launch_gemm_bf16<true, 4>(x, w, y, m, n, k, device, s)
                : launch_gemm_bf16<false, 4>(x, w, y, m, n, k, device, s);
  return w_nk ? launch_gemm_f32<true>(x, w, y, m, n, k, s)
              : launch_gemm_f32<false>(x, w, y, m, n, k, s);
}
