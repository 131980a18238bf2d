// Blocked GQA flash attention for Hopper (sm_90a): a bf16 tensor-core body
// and a float32 FMA body.
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
// and ks, vs (B, T) one float32 scale per cache row, shared by the KV heads
// (the TPU entry repeats the scales per KV head; here they are indexed by
// batch row).  The scales are per row, so the KV tiles need no alignment to
// the page length the rows were written in.
//
// Which body runs follows from q's type: bfloat16 q takes the tensor-core
// body (bf16 K/V for flash_attention, int8 K/V for the dequantizing entry),
// float32 q the FMA body (float32 or int8 K/V), whose 2e-5 agreement the
// bf16 tensor cores cannot give.
//
// What bounds it.  At the serving shapes the function is bound by operations
// (4 * S * T * D per query head, halved by the causal mask, against about
// 2 bytes per element of q, k, v and out): 989 TFLOP/s on the bf16 tensor
// cores, 67 TFLOP/s on the FMA units.  The tensor-core body spends most of
// its time on the CUDA-core work around its products (per thread and tile
// 32 exps, the p split, the mask, two barriers) with one warpgroup per
// 64-row block and four blocks on an SM (D <= 64).
//
// Both bodies: one block per (batch, kv-head, tile of q_block query
// positions) holding all G query heads of its tile, 64 rows at most
// (G * q_block; row r is position r / G of head r % G), so K and V are read
// once per G heads.  The block walks the KV axis in tiles of 64 rows inside
// a loop (the TPU grid's sequential axis) and keeps m, l and acc in
// registers.  Under the causal mask it stops at the last tile that the
// block's last query position can see.  A ragged last q tile or KV tile is
// masked, so no block size has to divide S or T.  Every sum has a fixed
// order and there is no atomic, so two runs give the same bits.
//
// Tensor-core body (flash_attention_kernel_tc, one warpgroup of 128 threads):
//
//   Q       bf16 in shared memory, staged once (cp.async), in the swizzled
//           wgmma layout of wgmma.cuh;
//   K, V    64-row tiles in the same layout, loaded by cp.async two stages
//           deep, so tile n + 1 arrives while tile n is computed.  int8 rows
//           arrive in a plain staging buffer (two stages, with their scales)
//           and become bf16 tiles in shared memory, exactly (|x| <= 127);
//   scores  S = Q K^T by wgmma m64n64k16 (A and B from shared memory) into
//           float32 registers, multiplied by 1 / sqrt(D) after the dot (and,
//           int8, by the column's ks first).  A bf16 x bf16 product is exact
//           in float32, so this is the TPU body's float32 dot up to the
//           order of the float32 sums;
//   softmax on the accumulator fragment: each thread holds 16 columns of 2
//           rows; row maxima and sums over the quad by xor shuffles (fixed
//           order), l summed from the float32 p.  A tile that every row of
//           the block sees whole (below the causal diagonal, inside T)
//           skips the per-element mask, which is most tiles of a long
//           causal prefill;
//   PV      acc += P V by wgmma m64nDk16 with A from registers (the score
//           fragment is the A fragment) and V read MN-major from shared
//           memory.  p (times vs for int8) is split as p_hi = bf16(p) and
//           p_lo = bf16(p - p_hi), two products into one float32
//           accumulator: p keeps about 2^-16 of its relative precision, which
//           holds the bf16 outputs at the 1e-2 of the float32 oracle that a
//           single bf16 p (2^-9) would not at magnitudes >= 2;
//   order   under the causal mask the q tiles run heaviest first (the tile
//           index is reversed and is the grid's slow axis).
//   D = 80  (hubert-xlarge's 1280 / 16 heads) is padded to 128 columns in
//           shared memory: an 80-column bf16 row is 160 bytes, which no
//           swizzle of wgmma.cuh lays out, so Q, K and V tiles are stored
//           in the D = 128 layout (a B128 panel of 64 columns and one of
//           which 16 columns are used).  Only the 80 columns are copied.
//           QK^T runs the 5 k16 steps of the real columns, so the scores
//           are exact and cost what D = 80 costs; P V runs at N = 128, and
//           the accumulator's columns 80..127 (whatever the unwritten V
//           columns hold: a column of the product depends on its own V
//           column only) are never stored.  What it wastes: 1.6x the P V
//           products and registers of D = 80, and 1.6x the shared memory
//           of its tiles (int8 K/V, flash_attention_dequant, and the
//           decode kernel keep D in {16, 32, 64, 128}).
//
// FMA body (flash_attention_kernel, 256 threads, float32 q):
//
//   scores  lane j of a warp owns KV columns j and j + 32 of the tile; q rows
//           come from shared memory as broadcast float4 loads, K rows from
//           shared memory with a row stride of D + 4 floats (no bank
//           conflicts for the 16-byte loads); q is scaled before the dot as
//           in the TPU body;
//   softmax row maximum and sum by xor shuffles (fixed order);
//   PV      lane j owns output dims j, j + 32, ...; p goes through a per-warp
//           shared buffer, V is read from shared memory.

#include <cmath>
#include <type_traits>

#include "approx_math.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core body
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;                 // one warpgroup

// One stage of int8 rows: K and V tiles (64 x D bytes each), then the 64
// rows' ks and vs.
template <int D>
__host__ __device__ constexpr int tc_stage_bytes() {
  return 2 * kFlashKv * D + 2 * kFlashKv * (int)sizeof(float);
}

// Q, then two stages of bf16 K and V tiles; or (int8) one bf16 K and V pair
// and two stages of int8 rows.  Plus the slack that aligns the first tile
// to 1024 bytes.
template <int D, bool kDequant>
__host__ __device__ constexpr int tc_smem_bytes() {
  return (kDequant ? 3 * TileGeom<D>::kTileBytes + 2 * tc_stage_bytes<D>()
                   : 5 * TileGeom<D>::kTileBytes) +
         1024;
}

// The width a head of D columns is stored at in shared memory: 80 -> 128.
template <int D>
__host__ __device__ constexpr int tc_tile_dim() {
  return D == 80 ? 128 : D;
}

// Four blocks on an SM for D <= 64 (at most 128 registers a thread).
template <typename TKV, int D, bool kTaylor>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 4 : 1)
flash_attention_kernel_tc(const __nv_bfloat16* __restrict__ q,
                          const TKV* __restrict__ k, const TKV* __restrict__ v,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          __nv_bfloat16* __restrict__ out, int S, int T_len,
                          int H, int K, int G, int q_block, int causal,
                          int q_offset, float scale) {
  constexpr bool kDequant = std::is_same<TKV, int8_t>::value;
  constexpr int DP = tc_tile_dim<D>();          // the tiles' width
  static_assert(DP == D || !kDequant, "int8 K/V take D in {16, 32, 64, 128}");
  constexpr int kTile = TileGeom<DP>::kTileBytes;
  constexpr int CPR = D / 8;                    // 16-byte bf16 chunks a row
  constexpr int NO = DP / 2;                    // accumulator floats a thread
  extern __shared__ uint8_t tc_smem[];
  const uint32_t raw = smem_addr(tc_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = tc_smem + (base - raw);
  const uint32_t q_tile = base;
  // bf16: K, V of stage s at base + (1 + 2s) * kTile, base + (2 + 2s) * kTile;
  // int8: the bf16 K, V tiles, then the stages
  const uint32_t stage0 = base + 3 * kTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / K;
  const int kvh = blockIdx.x % K;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * q_block;
  const int rows = G * q_block;                 // <= kFlashRows

  // Q: row r is position q0 + r / G of query head kvh * G + r % G
  for (int e = tid; e < kFlashRows * CPR; e += kTcThreads) {
    const int r = e / CPR, c = e % CPR;
    const int i = q0 + r / G;
    const bool ok = r < rows && i < S;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * S + i) * H + kvh * G + r % G) * D + c * 8 : q;
    cp_async16(q_tile + tile_offset<DP>(r, c * 8), src, ok);
  }

  auto load_tile = [&](int tile, int st) {
    const int t0 = tile * kFlashKv;
    if constexpr (!kDequant) {
      const uint32_t kt = base + (1 + 2 * st) * kTile;
      const uint32_t vt = kt + kTile;
      for (int e = tid; e < kFlashKv * CPR; e += kTcThreads) {
        const int j = e / CPR, c = e % CPR;
        const int t = t0 + j;
        const bool ok = t < T_len;
        const size_t off = ok ? (((size_t)b * T_len + t) * K + kvh) * D + c * 8 : 0;
        const uint32_t so = tile_offset<DP>(j, c * 8);
        cp_async16(kt + so, k + off, ok);
        cp_async16(vt + so, v + off, ok);
      }
    } else {
      constexpr int CPR8 = D / 16;              // 16-byte int8 chunks a row
      const uint32_t sg = stage0 + st * tc_stage_bytes<D>();
      for (int e = tid; e < kFlashKv * CPR8; e += kTcThreads) {
        const int j = e / CPR8, c = e % CPR8;
        const int t = t0 + j;
        const bool ok = t < T_len;
        const size_t off = ok ? (((size_t)b * T_len + t) * K + kvh) * D + c * 16 : 0;
        cp_async16(sg + j * D + c * 16, k + off, ok);
        cp_async16(sg + kFlashKv * D + j * D + c * 16, v + off, ok);
      }
      const int j = tid % kFlashKv;             // tid < 64: ks, else vs
      const int t = t0 + j;
      const bool ok = t < T_len;
      const size_t off = ok ? (size_t)b * T_len + t : 0;
      cp_async4(sg + 2 * kFlashKv * D + (tid / kFlashKv) * kFlashKv * 4 + j * 4,
                (tid < kFlashKv ? ks : vs) + off, ok);
    }
  };

  // int8 rows of a stage -> the bf16 K and V tiles (exact)
  auto convert_tile = [&](int st) {
    const uint8_t* sg = base_ptr + 3 * kTile + st * tc_stage_bytes<D>();
#pragma unroll 2
    for (int e = tid; e < 2 * kFlashKv * CPR; e += kTcThreads) {
      const int which = e / (kFlashKv * CPR);   // 0: K, 1: V
      const int f = e % (kFlashKv * CPR);
      const int j = f / CPR, c = f % CPR;
      const uint2 w = *reinterpret_cast<const uint2*>(
          sg + which * kFlashKv * D + j * D + c * 8);
      const int8_t* x = reinterpret_cast<const int8_t*>(&w);
      uint4 y;
      y.x = pack_bf16x2((float)x[0], (float)x[1]);
      y.y = pack_bf16x2((float)x[2], (float)x[3]);
      y.z = pack_bf16x2((float)x[4], (float)x[5]);
      y.w = pack_bf16x2((float)x[6], (float)x[7]);
      *reinterpret_cast<uint4*>(base_ptr + (1 + which) * kTile +
                                tile_offset<DP>(j, c * 8)) = y;
    }
  };

  // This thread's accumulator rows and its columns in each 8-column chunk.
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = q0 + (r_lo + 8 * h) / G + q_offset;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;

  const int q_last = min(q0 + q_block, S) - 1 + q_offset;
  const int kv_end = causal ? min(T_len, q_last + 1) : T_len;
  const int n_tiles = (kv_end + kFlashKv - 1) / kFlashKv;

  load_tile(0, 0);
  cp_async_commit();                            // Q and tile 0

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    cp_async_wait_all();                        // tile n (and Q) arrived
    fence_proxy_async();
    __syncthreads();                            // ... for every thread; tile
                                                // n - 1's buffers are free
    if (tile + 1 < n_tiles) load_tile(tile + 1, st ^ 1);
    cp_async_commit();
    uint32_t kt, vt;
    if constexpr (kDequant) {
      convert_tile(st);
      fence_proxy_async();
      __syncthreads();
      kt = base + kTile;
      vt = base + 2 * kTile;
    } else {
      kt = base + (1 + 2 * st) * kTile;
      vt = kt + kTile;
    }

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc<DP>(q_tile, kk), kmajor_desc<DP>(kt, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    // the int8 rows' ks, then vs, read where they are used (held in
    // registers they would cost the block its fourth place on an SM)
    const float* sc = reinterpret_cast<const float*>(
        base_ptr + 3 * kTile + st * tc_stage_bytes<D>() + 2 * kFlashKv * D);

    // online softmax on the fragment: s[4i + 2h + e] is row r_lo + 8h,
    // column 8i + cq + e of the tile.  A tile that every row of the block
    // sees whole (below the causal diagonal, inside T) needs no mask.
    const int t0 = tile * kFlashKv;
    const bool whole = t0 + kFlashKv <= T_len &&
                       (!causal || t0 + kFlashKv - 1 <= q0 + q_offset);
    auto softmax = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t okbits = 0;
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * i + 2 * h + e;
            float x = s[idx];
            if constexpr (kDequant) x *= sc[8 * i + cq + e];
            x *= scale;
            if constexpr (kMasked) {
              const int t = t0 + 8 * i + cq + e;
              const bool ok = t < T_len && (!causal || t <= qpos[h]);
              x = ok ? x : kNegInf;
              okbits |= (ok ? 1u : 0u) << (2 * i + e);
            }
            s[idx] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = softmax_exp<kTaylor>(m[h] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * i + 2 * h + e;
            float p = softmax_exp<kTaylor>(s[idx] - m_new);
            if constexpr (kMasked) p = (okbits >> (2 * i + e)) & 1u ? p : 0.0f;
            sum += p;
            s[idx] = kDequant ? p * sc[kFlashKv + 8 * i + cq + e] : p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i + 2 * h] *= alpha;
          o[4 * i + 2 * h + 1] *= alpha;
        }
      }
    };
    if (whole)
      softmax(std::false_type{});
    else
      softmax(std::true_type{});

    // P as the A fragments of the four k16 steps, split into bf16 hi + lo:
    // register a of step j holds chunk 2j + (a >> 1), row half a & 1
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int idx = 4 * (2 * j + (a >> 1)) + 2 * (a & 1);
        const float x = s[idx], y = s[idx + 1];
        ahi[j][a] = pack_bf16x2(x, y);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&ahi[j][a]);
        alo[j][a] = pack_bf16x2(x - __low2float(hv), y - __high2float(hv));
      }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dv = mnmajor_desc<DP>(vt, j);
      wgmma_rs<DP>(o, ahi[j], dv);
      wgmma_rs<DP>(o, alo[j], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fence_operands(ahi[j]);
      fence_operands(alo[j]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    const int i = q0 + r / G;
    if (r >= rows || i >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* o_row = out + (((size_t)b * S + i) * H + kvh * G + r % G) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(o_row + 8 * c + cq) =
          pack_bf16x2(o[4 * c + 2 * h] / den, o[4 * c + 2 * h + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename TKV, int D, bool kTaylor>
int launch_flash_fma(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, void* out, int B, int S,
                     int T_len, int H, int K, int q_block, int causal,
                     int q_offset, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<float, TKV, D, kTaylor>;
  const int smem = (int)(flash_smem_floats<D>() * sizeof(float));
  // the dynamic shared memory limit, set once per template instance (a
  // failure is returned on every launch)
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + q_block - 1) / q_block, B * K);
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, static_cast<float*>(out), S, T_len,
      H, K, H / K, q_block, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename TKV, int D, bool kTaylor>
int launch_flash_tc(const void* q, const void* k, const void* v,
                    const float* ks, const float* vs, void* out, int B, int S,
                    int T_len, int H, int K, int q_block, int causal,
                    int q_offset, cudaStream_t stream) {
  auto kernel = flash_attention_kernel_tc<TKV, D, kTaylor>;
  constexpr int smem =
      tc_smem_bytes<tc_tile_dim<D>(), std::is_same<TKV, int8_t>::value>();
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + q_block - 1) / q_block;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;   // the grid's y axis
  const dim3 grid(B * K, n_qt);
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, static_cast<__nv_bfloat16*>(out), S,
      T_len, H, K, H / K, q_block, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// The body for q's type: bf16 q -> tensor cores, float32 q -> FMA.
template <bool kBf16, typename TKV, int D, bool kTaylor>
int launch_flash(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, void* out, int B, int S, int T_len, int H,
                 int K, int q_block, int causal, int q_offset,
                 cudaStream_t s) {
  if constexpr (kBf16)
    return launch_flash_tc<TKV, D, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
  else
    return launch_flash_fma<TKV, D, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
}

template <bool kBf16, typename TKV, bool kTaylor>
int dispatch_flash(int D, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, void* out, int B, int S,
                   int T_len, int H, int K, int q_block, int causal,
                   int q_offset, cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash<kBf16, TKV, 16, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    case 32: return launch_flash<kBf16, TKV, 32, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    case 64: return launch_flash<kBf16, TKV, 64, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    case 80:
      // hubert-xlarge's heads; not for int8 K/V (no model path reads them)
      if constexpr (std::is_same<TKV, int8_t>::value) return (int)cudaErrorInvalidValue;
      else return launch_flash<kBf16, TKV, 80, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    case 128: return launch_flash<kBf16, TKV, 128, kTaylor>(q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kBf16, typename TKV>
int dispatch_flash_mode(int taylor, int D, const void* q, const void* k,
                        const void* v, const float* ks, const float* vs,
                        void* out, int B, int S, int T_len, int H, int K,
                        int q_block, int causal, int q_offset,
                        cudaStream_t s) {
  return taylor
      ? dispatch_flash<kBf16, TKV, true>(D, q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s)
      : dispatch_flash<kBf16, TKV, false>(D, q, k, v, ks, vs, out, B, S, T_len, H, K, q_block, causal, q_offset, s);
}

inline bool flash_shape_ok(int B, int S, int T_len, int H, int K, int q_block,
                    int q_offset) {
  return B > 0 && S > 0 && T_len > 0 && K > 0 && H % K == 0 && q_block > 0 &&
         (H / K) * q_block <= kFlashRows && q_offset >= 0;
}

}  // namespace fastcaps

// q, out (B, S, H, D); k, v (B, T, K, D); all contiguous, one type: float32
// (is_bf16 = 0, the FMA body) or bfloat16 (1, the tensor-core body).  H a
// multiple of K, D in {16, 32, 64, 80, 128}, q_block a power of two with
// (H / K) * q_block <= kFlashRows (FLASH_ROWS in
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
    return dispatch_flash_mode<true, __nv_bfloat16>(
        taylor, D, q, k, v, nullptr, nullptr, out, B, S, T_len, H, K, q_block,
        causal, q_offset, s);
  return dispatch_flash_mode<false, float>(
      taylor, D, q, k, v, nullptr, nullptr, out, B, S, T_len, H, K, q_block,
      causal, q_offset, s);
}

// The dequantizing variant: q, out (B, S, H, D) float32 (q_bf16 = 0, the FMA
// body) or bfloat16 (1, the tensor-core body); kq, vq (B, T, K, D) int8; ks,
// vs (B, T) float32 per-row scales; all contiguous.  The other arguments and
// the return value are flash_attention_launch's.
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
    return dispatch_flash_mode<true, int8_t>(
        taylor, D, q, kq, vq, ksf, vsf, out, B, S, T_len, H, K, q_block,
        causal, q_offset, s);
  return dispatch_flash_mode<false, int8_t>(
      taylor, D, q, kq, vq, ksf, vsf, out, B, S, T_len, H, K, q_block, causal,
      q_offset, s);
}
