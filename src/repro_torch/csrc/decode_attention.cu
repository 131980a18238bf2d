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
// TPU's scalar-prefetch index_map becomes a plain load of the table by the
// lane that copies the row.  int8 (TKV = int8_t): k, v hold int8 rows and
// ks, vs one float32 scale per storage row, shared by the KV heads ((B, T)
// dense, (n_pages, page) paged: in both layouts the scale's index is the
// storage row's).
//
// What bounds it.  Bytes: every valid cache row of K and V is read once
// (2 * n * D elements per slot and KV head, plus one scale per row for int8)
// for 4 * G * D operations per row, far below the card's ratio of operations
// to bytes.  So the design is about keeping enough loads in flight: at 8
// slots and 8 KV heads one block per (slot, KV head) would fill half the
// SMs and walk up to 700 rows in a chain of load latencies.
//
// Design.  Split-KV over a thread-block cluster: the grid is (slot, KV head,
// chunk, split), one chunk unless G > 8 (below), and the `splits` blocks
// of one (slot, KV head, chunk) form one cluster
// (cudaLaunchKernelEx; at most the portable 8).  Split s owns the logical
// rows [s * per, s * per + per) of the slot, per = ceil(n / splits) rounded
// up to the 32-row tile, so the dense and paged bodies of one cache type run
// the same sums in the same order; a split past n has no rows and ends with
// m = -1e30, l = 0.  Inside a block the warps take the split's 32-row tiles
// in turn, each warp with its own online softmax state (m, l, acc for the
// block's heads):
//
//   loads   a warp copies a tile of K and of V with 16-byte cp.async copies
//           along D (at D = 64 bf16, 8 lanes a row and 4 rows a copy; int8,
//           4 lanes a row), each lane resolving the storage rows it copies
//           itself (the page-table load, paged) and, int8, the scales of the
//           tile's row it scores; the next tile is staged while the current
//           one is scored (two stages a warp).  Rows past the split are
//           zero-filled.  A staged row is padded by 16 bytes, so the lanes
//           that read 16 bytes of 8 different rows hit different banks;
//   scores  lane j scores row j against the G query rows (float32, broadcast
//           from shared memory), d in order; int8 multiplies the score by
//           the row's K scale;
//   softmax maximum and sum over the tile by xor shuffles;
//   PV      lane j owns D / 32 neighbouring output dims (D = 16: lanes
//           0-15 one each) and sums p * v over the tile's rows in order; p
//           comes from a per-warp shared buffer, int8 with the row's V scale
//           folded in.
//
// Groups.  A lane keeps the state of each of its block's query heads in
// registers (m, l and acc for each), at most kDecodeChunkG = 8 heads: a KV
// head of G <= 8 query heads (llama, qwen, the vlm, dbrx) is one block's,
// and the heads of a larger group (mistral-large's G 12) are dealt to
// ceil(G / 8) chunks of at most 8, as even as they come, one chunk per grid
// index; each chunk reads its KV head's rows.  A block holding 16 heads, so
// that G 12 reads its rows once, ran slower on an H100 than two chunks of
// 6: the decode is bound by the latency of its loads and shuffles, not by
// its bytes, so reading the rows twice costs less than a lane's doubled
// state and work.  The chunked instances (kChunked) serve G > 8 only: for
// G <= 8 the chunk arithmetic folds away at compile time and the code is
// the unchunked kernel's (with it at run time, zamba2's G 1 decode ran
// slower).
//
// The combine.  A block joins its warps' states in warp order by
// log-sum-exp, and writes its (m, l, acc) into rank 0's shared memory over
// distributed shared memory; after one cluster barrier rank 0 joins the
// splits in rank order the same way and writes the output.  No second
// launch and no global work space.
//
// No atomics and fixed orders throughout, so two runs give the same bits;
// the dense and paged bodies of one cache type run the same sums in the same
// order, so they agree bit for bit on the same rows.

#include <cooperative_groups.h>

#include <cmath>
#include <type_traits>

#include "approx_math.cuh"
#include "launch.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace fastcaps {

constexpr float kDecodeNegInf = -1e30f;
constexpr int kDecodeChunkG = 8;        // query heads a block holds
constexpr int kDecodeTile = 32;         // cache rows per warp tile
constexpr int kDecodeStages = 2;        // tiles staged per warp
constexpr int kDecodeRowPad = 16;       // bytes after each staged row
constexpr int kDecodeMaxSplits = 8;     // blocks of a cluster (portable)
constexpr int kDecodeMaxThreads = 512;
constexpr int kDecodeMaxSmem = 232448;  // bytes a block may ask for

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

// The chunks the G query heads of one KV head are dealt to.
__host__ __device__ inline int decode_group_chunks(int g) {
  return (g + kDecodeChunkG - 1) / kDecodeChunkG;
}

// Shared memory of one block, in bytes: the scaled queries; per warp
// kDecodeStages stages of a K tile, a V tile (rows padded by kDecodeRowPad)
// and the tile's K and V scales, then a p buffer; and the cluster's states,
// one per split, that rank 0 joins.  The warps' states reuse the tiles at
// the end.  decode_smem_bytes in kernels/attention/kernel.py plans block
// sizes by the same sum; a CPU test holds the two equal.
__host__ __device__ inline long long decode_stage_bytes(int d, int kv_bytes) {
  return 2LL * kDecodeTile * (d * kv_bytes + kDecodeRowPad) +
         2LL * kDecodeTile * 4;
}

__host__ __device__ inline long long decode_warp_bytes(int d, int kv_bytes) {
  return kDecodeStages * decode_stage_bytes(d, kv_bytes) +
         4LL * kDecodeChunkG * kDecodeTile;
}

__host__ __device__ inline long long decode_smem_bytes(int d, int kv_bytes,
                                                       int warps, int splits) {
  return 4LL * kDecodeChunkG * d + warps * decode_warp_bytes(d, kv_bytes) +
         4LL * splits * kDecodeChunkG * (d + 2);
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

// 16 staged bytes as float32 values.
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);          // bf16 is float's top half
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}

// N staged values of type T at p, as float32.
template <typename T, int N>
__device__ __forceinline__ void load_staged(const char* p, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = load_f32(reinterpret_cast<const T*>(p) + i);
}

template <typename TQ, typename TKV, int D, bool kChunked, bool kTaylor,
          bool kPaged>
__global__ void __launch_bounds__(kDecodeMaxThreads)
decode_attention_kernel(const DecodeArgs a) {
  constexpr int kG = kDecodeChunkG;
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kElem = (int)sizeof(TKV);
  constexpr int kPerChunk = 16 / kElem;               // values in 16 bytes
  constexpr int kChunks = D / kPerChunk;              // 16-byte copies a row
  constexpr int kRowsPerCopy = 32 / kChunks;          // rows a warp copies at once
  constexpr int kRowBytes = D * kElem + kDecodeRowPad;
  constexpr int kTileBytes = kDecodeTile * kRowBytes;
  constexpr int kStageBytes = 2 * kTileBytes + 2 * kDecodeTile * 4;
  constexpr int DPL = D >= 32 ? D / 32 : 1;           // output dims a lane owns
  static_assert(kChunks >= 1 && kChunks <= 32, "16-byte copies along D");

  cg::cluster_group cluster = cg::this_cluster();
  // every block must have started before another writes its shared memory
  cluster_arrive_relaxed();
  const int splits = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = a.K, G = a.G;
  // the block's query heads: its chunk's Gc heads from g0 on (kChunked),
  // else all G of its KV head
  const int n_chunks = kChunked ? decode_group_chunks(G) : 1;
  const int bhc = blockIdx.x / splits;
  const int bh = bhc / n_chunks;
  const int b = bh / K;
  const int h = bh % K;
  const int per_chunk = kChunked ? (G + n_chunks - 1) / n_chunks : G;
  const int g0 = (bhc % n_chunks) * per_chunk;
  const int Gc = kChunked ? min(per_chunk, G - g0) : G;
  const int H = K * G;
  const int n = max(0, min(a.valid[b], a.T_len));
  const int per = ((n + splits - 1) / splits + kDecodeTile - 1) /
                  kDecodeTile * kDecodeTile;
  const int r0 = min(n, split * per);
  const int r1 = min(n, r0 + per);
  const int n_tiles = (r1 - r0 + kDecodeTile - 1) / kDecodeTile;

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* Qs = reinterpret_cast<float*>(smem);
  char* warp_space = smem + 4 * kG * D;
  float* recv = reinterpret_cast<float*>(
      warp_space + warps * decode_warp_bytes(D, kElem));
  char* ws = warp_space + warp * decode_warp_bytes(D, kElem);
  float* P = reinterpret_cast<float*>(ws + kDecodeStages * kStageBytes);

  const TQ* q = static_cast<const TQ*>(a.q);
  for (int e = tid; e < Gc * D; e += blockDim.x)
    Qs[e] = load_f32(q + ((size_t)b * H + h * G + g0) * D + e) * a.scale;

  const long long row_stride = (long long)K * D;
  const TKV* kh = static_cast<const TKV*>(a.k) + (size_t)h * D;
  const TKV* vh = static_cast<const TKV*>(a.v) + (size_t)h * D;
  auto storage_row = [&](int t) -> long long {
    if (kPaged) {
      int pid = a.tables[(size_t)b * a.P + t / a.page];
      pid = min(max(pid, 0), a.n_pages - 1);
      return (long long)pid * a.page + t % a.page;
    }
    return (long long)b * a.T_len + t;
  };
  // stage a tile's K and V rows (and, int8, the scales of row `lane`)
  auto stage_tile = [&](int tile, int stage) {
    const int t0 = r0 + tile * kDecodeTile;
    const int rows = min(kDecodeTile, r1 - t0);
    const uint32_t kdst =
        (uint32_t)__cvta_generic_to_shared(ws + stage * kStageBytes);
    const int c = lane % kChunks;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int r = lane / kChunks + i * kRowsPerCopy;
      const bool ok = r < rows;
      const long long off = ok ? storage_row(t0 + r) * row_stride + c * kPerChunk
                               : 0;
      cp_async16(kdst + r * kRowBytes + c * 16, kh + off, ok);
      cp_async16(kdst + kTileBytes + r * kRowBytes + c * 16, vh + off, ok);
    }
    if (kInt8) {
      const bool ok = lane < rows;
      const long long sr = ok ? storage_row(t0 + lane) : 0;
      cp_async4(kdst + 2 * kTileBytes + lane * 4, a.ks + sr, ok);
      cp_async4(kdst + 2 * kTileBytes + (kDecodeTile + lane) * 4, a.vs + sr,
                ok);
    }
    cp_async_commit();
  };

  float m[kG], l[kG], acc[kG][DPL];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kDecodeNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[g][c] = 0.0f;
  }
  const int d0 = lane * DPL;                 // this lane's first output dim
  const bool owns = d0 < D;

  if (warp < n_tiles) stage_tile(warp, 0);
  __syncthreads();                            // Qs
  int stage = 0;
  for (int tile = warp; tile < n_tiles; tile += warps) {
    if (tile + warps < n_tiles) stage_tile(tile + warps, stage ^ 1);
    else cp_async_commit();                   // an empty group: wait_one holds
    cp_async_wait_one();
    __syncwarp();
    const int rows = min(kDecodeTile, r1 - (r0 + tile * kDecodeTile));
    const char* kt = ws + stage * kStageBytes;
    const char* vt = kt + kTileBytes;
    const float* sc = reinterpret_cast<const float*>(kt + 2 * kTileBytes);
    const bool ok = lane < rows;

    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.0f;
    const char* kr = kt + lane * kRowBytes;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float kf[kPerChunk];
      unpack16(*reinterpret_cast<const uint4*>(kr + c * 16), kf);
#pragma unroll
      for (int e = 0; e < kPerChunk; e += 4) {
        const int d = c * kPerChunk + e;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (g < Gc) {
            const float4 q4 = *reinterpret_cast<const float4*>(Qs + g * D + d);
            s[g] += q4.x * kf[e];
            s[g] += q4.y * kf[e + 1];
            s[g] += q4.z * kf[e + 2];
            s[g] += q4.w * kf[e + 3];
          }
        }
      }
    }

    const float k_scale = kInt8 ? sc[lane] : 1.0f;
    const float v_scale = kInt8 ? sc[kDecodeTile + lane] : 1.0f;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= Gc) break;
      const float sg = ok ? (kInt8 ? s[g] * k_scale : s[g]) : kDecodeNegInf;
      const float m_new = fmaxf(m[g], decode_warp_max(sg));
      const float alpha = softmax_exp<kTaylor>(m[g] - m_new);
      const float p = ok ? softmax_exp<kTaylor>(sg - m_new) : 0.0f;
      l[g] = l[g] * alpha + decode_warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[g][c] *= alpha;
      P[g * kDecodeTile + lane] = kInt8 ? p * v_scale : p;
    }
    __syncwarp();

    if (owns) {
      for (int j = 0; j < rows; ++j) {
        float vv[DPL];
        load_staged<TKV, DPL>(vt + j * kRowBytes + d0 * kElem, vv);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (g < Gc) acc[g][c] += P[g * kDecodeTile + j] * vv[c];
        }
      }
    }
    __syncwarp();
    stage ^= 1;
  }
  cp_async_wait_all();

  // join the warps' states in warp order (in the tiles' space), then send
  // the block's state to rank 0
  __syncthreads();
  float* Ms = reinterpret_cast<float*>(warp_space);   // warps x kG
  float* Ls = Ms + warps * kG;                        // warps x kG
  float* As = Ls + warps * kG;                        // warps x kG x D
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g >= Gc) break;
    if (lane == 0) {
      Ms[warp * kG + g] = m[g];
      Ls[warp * kG + g] = l[g];
    }
    if (owns) {
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        As[(warp * kG + g) * D + d0 + c] = acc[g][c];
    }
  }
  __syncthreads();
  constexpr int kState = kG * (D + 2);                // floats a split sends
  cluster_wait();
  float* dst = cluster.map_shared_rank(recv, 0) + split * kState;
  for (int e = tid; e < Gc * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mt = kDecodeNegInf;
    for (int w = 0; w < warps; ++w) mt = fmaxf(mt, Ms[w * kG + g]);
    float lt = 0.0f, at = 0.0f;
    for (int w = 0; w < warps; ++w) {
      const float f = softmax_exp<kTaylor>(Ms[w * kG + g] - mt);
      lt += Ls[w * kG + g] * f;
      at += As[(w * kG + g) * D + d] * f;
    }
    dst[2 * kG + g * D + d] = at;
    if (d == 0) {
      dst[g] = mt;
      dst[kG + g] = lt;
    }
  }
  cluster.sync();
  if (split != 0) return;

  // rank 0: join the splits in rank order and write the output
  TQ* out = static_cast<TQ*>(a.out);
  for (int e = tid; e < Gc * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mt = kDecodeNegInf;
    for (int r = 0; r < splits; ++r) mt = fmaxf(mt, recv[r * kState + g]);
    float lt = 0.0f, at = 0.0f;
    for (int r = 0; r < splits; ++r) {
      const float* st = recv + r * kState;
      const float f = softmax_exp<kTaylor>(st[g] - mt);
      lt += st[kG + g] * f;
      at += st[2 * kG + g * D + d] * f;
    }
    store_f32(out + ((size_t)b * H + h * G + g0) * D + e,
              at / fmaxf(lt, 1e-30f));
  }
}

template <typename TQ, typename TKV, int D, bool kChunked, bool kTaylor,
          bool kPaged>
int launch_decode(const DecodeArgs& a, int B, int threads, int splits,
                  int device, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TKV, D, kChunked, kTaylor, kPaged>;
  // the dynamic shared memory limit, set once per template instance and
  // device (a failure is returned on every launch)
  static cudaError_t err[kMaxDevices];
  static bool set[kMaxDevices];
  if (!set[device]) {
    err[device] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecodeMaxSmem);
    set[device] = true;
  }
  if (err[device] != cudaSuccess) return (int)err[device];
  const long long smem =
      decode_smem_bytes(D, (int)sizeof(TKV), threads / 32, splits);
  if (smem > kDecodeMaxSmem) return (int)cudaErrorInvalidValue;
  const int chunks = kChunked ? decode_group_chunks(a.G) : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.K * chunks * splits, 1, 1);
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
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();   // and clear it
  return (int)(launch != cudaSuccess ? launch : last);
}

// One call's operands, types and launch geometry, as the entry point takes
// them.
struct DecodeLaunch {
  DecodeArgs a;
  int B, D, q_bf16, kv_type, taylor, threads, splits, device;
  cudaStream_t stream;
};

template <bool kChunked, bool kPaged, typename TQ, typename TKV, bool kTaylor>
int decode_by_dim(const DecodeLaunch& l) {
  switch (l.D) {
    case 16: return launch_decode<TQ, TKV, 16, kChunked, kTaylor, kPaged>(l.a, l.B, l.threads, l.splits, l.device, l.stream);
    case 32: return launch_decode<TQ, TKV, 32, kChunked, kTaylor, kPaged>(l.a, l.B, l.threads, l.splits, l.device, l.stream);
    case 64: return launch_decode<TQ, TKV, 64, kChunked, kTaylor, kPaged>(l.a, l.B, l.threads, l.splits, l.device, l.stream);
    case 128: return launch_decode<TQ, TKV, 128, kChunked, kTaylor, kPaged>(l.a, l.B, l.threads, l.splits, l.device, l.stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kChunked, bool kPaged, bool kTaylor>
int decode_by_types(const DecodeLaunch& l) {
  if (l.q_bf16)
    return l.kv_type == 2
               ? decode_by_dim<kChunked, kPaged, __nv_bfloat16, int8_t, kTaylor>(l)
               : decode_by_dim<kChunked, kPaged, __nv_bfloat16, __nv_bfloat16, kTaylor>(l);
  if (l.kv_type == 2) return decode_by_dim<kChunked, kPaged, float, int8_t, kTaylor>(l);
  if (l.kv_type == 1)
    return decode_by_dim<kChunked, kPaged, float, __nv_bfloat16, kTaylor>(l);
  return decode_by_dim<kChunked, kPaged, float, float, kTaylor>(l);
}

// Parts.  The instances of one kind (chunked or not), cache layout and exp
// make a part: part p holds the chunked instances if p & 4, the paged
// layout if p & 2, the Eq. 2 exp if p & 1.  nvcc compiles this file once
// per part with FASTCAPS_DECODE_PART set (kernels/build.py SOURCE_PARTS),
// so the eight build in parallel.  Part 0 also holds the entry point.
int decode_part0(const DecodeLaunch& l);
int decode_part1(const DecodeLaunch& l);
int decode_part2(const DecodeLaunch& l);
int decode_part3(const DecodeLaunch& l);
int decode_part4(const DecodeLaunch& l);
int decode_part5(const DecodeLaunch& l);
int decode_part6(const DecodeLaunch& l);
int decode_part7(const DecodeLaunch& l);

#ifndef FASTCAPS_DECODE_PART
#define FASTCAPS_DECODE_PART 0
#endif
#if FASTCAPS_DECODE_PART < 0 || FASTCAPS_DECODE_PART > 7
#error "FASTCAPS_DECODE_PART is one of 0 to 7"
#endif
#define FASTCAPS_PART_FN_(n) decode_part##n
#define FASTCAPS_PART_FN(n) FASTCAPS_PART_FN_(n)
int FASTCAPS_PART_FN(FASTCAPS_DECODE_PART)(const DecodeLaunch& l) {
  constexpr int p = FASTCAPS_DECODE_PART;
  return decode_by_types<(p & 4) != 0, (p & 2) != 0, (p & 1) != 0>(l);
}

}  // namespace fastcaps

#if FASTCAPS_DECODE_PART == 0
// q, out (B, 1, H, D) with H = K * G, contiguous.  Dense cache (tables null):
// k, v (B, T, K, D).  Paged cache: k, v (n_pages, page, K, D) and tables
// (B, P) int32 with T = P * page.  kv_type 0 = float32, 1 = bfloat16,
// 2 = int8 with ks, vs float32 per-row scales ((B, T) dense, (n_pages, page)
// paged; null otherwise).  k and v 16-byte aligned.  valid (B,) int32.  q and
// out are float32 (q_bf16 = 0) or bfloat16 (1); bfloat16 q takes a bfloat16
// or int8 cache.  D in {16, 32, 64, 128}, any G = H / K, threads a
// multiple of 32 in [32, 512], splits in [1, kDecodeMaxSplits] (the blocks
// of a cluster), their shared memory within a block's.  Every pointer on
// CUDA device `device`; launches on `stream` (a stream of `device`, made
// current for the launch), does not synchronise, allocates nothing.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid,
    const void* tables, const void* ks, const void* vs, void* out, int B,
    int T_len, int H, int K, int D, int P, int page, int n_pages, int taylor,
    int q_bf16, int kv_type, int threads, int splits, int device,
    void* stream) {
  using namespace fastcaps;
  const bool paged = tables != nullptr;
  const bool int8 = kv_type == 2;
  if (B <= 0 || T_len <= 0 || K <= 0 || H < K || H % K != 0 ||
      threads < 32 || threads > kDecodeMaxThreads || threads % 32 != 0 ||
      splits < 1 || splits > kDecodeMaxSplits || kv_type < 0 ||
      kv_type > 2 || (q_bf16 && kv_type == 0) ||
      int8 != (ks != nullptr && vs != nullptr) ||
      (paged && (P <= 0 || page <= 0 || n_pages <= 0 || T_len != P * page)) ||
      device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  DecodeLaunch l;
  l.a.q = q;
  l.a.k = k;
  l.a.v = v;
  l.a.valid = static_cast<const int*>(valid);
  l.a.tables = static_cast<const int*>(tables);
  l.a.ks = static_cast<const float*>(ks);
  l.a.vs = static_cast<const float*>(vs);
  l.a.out = out;
  l.a.T_len = T_len;
  l.a.K = K;
  l.a.G = H / K;
  l.a.P = P;
  l.a.page = page;
  l.a.n_pages = n_pages;
  l.a.scale = (float)(1.0 / std::sqrt((double)D));
  l.B = B;
  l.D = D;
  l.q_bf16 = q_bf16;
  l.kv_type = kv_type;
  l.taylor = taylor;
  l.threads = threads;
  l.splits = splits;
  l.device = device;
  l.stream = static_cast<cudaStream_t>(stream);
  static int (*const parts[8])(const DecodeLaunch&) = {
      decode_part0, decode_part1, decode_part2, decode_part3,
      decode_part4, decode_part5, decode_part6, decode_part7};
  return parts[(l.a.G > kDecodeChunkG ? 4 : 0) + (paged ? 2 : 0) +
               (taylor ? 1 : 0)](l);
}
#endif
