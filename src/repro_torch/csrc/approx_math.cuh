// FastCaps approximate math as __device__ functions, shared by every kernel
// of the port (routing.cu, softmax.cu).
//
// Eq. 2: Taylor expansion of exp around a = 0.5 in Horner form (5 multiplies,
// 5 adds, one scale by e^0.5), range-reduced as exp(x) = exp(x / 32)^32: clip
// to +-32, divide by 32, evaluate the polynomial, square five times.  The
// constants and the order of the operations are those of
// repro_torch/core/approx_math.py (taylor_exp with range_reduce=True).
//
// The polynomial is written with __fmul_rn / __fadd_rn so that the compiler
// cannot contract a multiply and an add into one fused multiply-add: the five
// squarings multiply a relative rounding difference by 32, and the plain
// PyTorch version (one elementwise kernel per operation, so every product is
// rounded before its add) would otherwise differ by more than the 1e-6 the
// softmax kernel is held to.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fastcaps {

constexpr float kEA = 1.6487212707001282f;  // e^0.5
constexpr float kC0 = 0.60653f;
constexpr float kC1 = 0.60659f;
constexpr float kC2 = 0.30260f;
constexpr float kC3 = 0.10347f;
constexpr float kC4 = 0.02118f;
constexpr float kC5 = 0.00833f;
constexpr float kReduceScale = 32.0f;       // 2^5
constexpr int kReduceK = 5;

__device__ __forceinline__ float taylor_exp_raw(float x) {
  float p = __fadd_rn(kC4, __fmul_rn(kC5, x));
  p = __fadd_rn(kC3, __fmul_rn(x, p));
  p = __fadd_rn(kC2, __fmul_rn(x, p));
  p = __fadd_rn(kC1, __fmul_rn(x, p));
  p = __fadd_rn(kC0, __fmul_rn(x, p));
  return __fmul_rn(kEA, p);
}

// Eq. 2 with range reduction; usable on about [-48, 48].
__device__ __forceinline__ float taylor_exp(float x) {
  x = fminf(fmaxf(x, -kReduceScale), kReduceScale) / kReduceScale;
  float y = taylor_exp_raw(x);
#pragma unroll
  for (int k = 0; k < kReduceK; ++k) y = __fmul_rn(y, y);
  return y;
}

// exp(z) for z <= 0 (after the row maximum was subtracted), in the mode the
// caller asked for.
template <bool kTaylor>
__device__ __forceinline__ float softmax_exp(float z) {
  if (kTaylor) return taylor_exp(z);
  return expf(z);
}

// Factor f with squash(s) = s * f, from sq = |s|^2: one rsqrt
// (approx_math.squash_fast, eps = 1e-9 inside the root).
__device__ __forceinline__ float squash_factor(float sq) {
  float inv = rsqrtf(sq + 1e-9f);
  return sq * inv / (1.0f + sq);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const int8_t* p) {
  return (float)*p;
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a tensor cast does
}

}  // namespace fastcaps
