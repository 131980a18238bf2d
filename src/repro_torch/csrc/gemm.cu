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
//   * one CTA tile (kGemmBM rows, BN columns, kGemmBK deep a stage) and one
//     instruction (wgmma m64n<BN>k16) for a weight at every M; BN comes from
//     N alone (gemm_block_n); output row r always lands
//     in CTA row r / kGemmBM, in consumer warpgroup (r % kGemmBM) / 64, at
//     row r % 64 of that warpgroup's 64-row instruction;
//   * each output tile's K loop runs whole inside its CTA, over K in
//     ascending kGemmBK stages (k16 steps inside): no split of K, no
//     stream-K;
//   * rows past M, columns past N and depth past K are read as zeros (the
//     tensor memory accelerator's out-of-bounds fill, which reads no
//     bytes) and not stored; a zero term adds nothing to a sum, so the
//     ragged edge changes no row's bits;
//   * a consumer warpgroup whose 64 rows all lie at or past M (the second
//     one at a decode tick's M) issues nothing: every stored row still gets
//     the same instructions in the same order.
//
// x (M, K) row-major; w either (K, N) row-major ("kn": a projection's
// weight as stored, N contiguous, an MN-major B) or (N, K) row-major ("nk":
// a tied embedding table read as its transpose, a K-major B), read as
// stored, with no copy.  bf16 operands, float32 accumulation in the tensor
// cores, one rounding to bf16 at the end, stored from registers.  A float32
// body (FMA, 64 x 64 tiles, K ascending one element at a time) serves
// float32 compute under the same rule.
//
// Bound: at prefill shapes by operations (2 M N K at the bf16 tensor-core
// peak), at decode shapes (M = a tick's slots) by the bytes of w.  The bf16
// body is warp-specialised: one producer thread (its warpgroup gives its
// registers to the consumers, setmaxnreg) issues the TMA copies of each
// stage's A tile (x, a 64-row box for each consumer warpgroup with a row
// below M) and B tile (w, BN columns x 64) into a ring of 128-byte-swizzled
// shared-memory stages, guarded by full and empty mbarriers; two consumer
// warpgroups each multiply 64 rows by wgmma with both operands in shared
// memory.  Tensor maps are encoded on the host
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, since
// the library is not linked against libcuda), cached by (pointer, shape,
// strides, box), and passed by value as __grid_constant__ parameters, so a
// captured CUDA graph keeps the maps of its static buffers.  A narrow
// product takes a narrower BN (gemm_block_n), so more CTAs stream w at a
// decode tick, where one warpgroup's chain of K / 16 dependent wgmma bounds
// a CTA; its times against cuBLAS are in PERF.md.

#include <cuda.h>   // CUtensorMap and the encoder's types; no libcuda call

#include <cstdint>
#include <mutex>

#include "launch.cuh"
#include "wgmma.cuh"

namespace fastcaps {

constexpr int kGemmBM = 128;            // output rows of a CTA
constexpr int kGemmBK = 64;             // depth of one stage: a 128-byte row
constexpr int kGemmConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kGemmThreads = 384;       // the consumers, then the producer's
constexpr int kGemmProducerRegs = 40;   // registers a producer thread keeps
constexpr int kGemmConsumerRegs = 232;  // ... and a consumer thread takes
constexpr int kGemmStagesN64 = 8;       // stages in the ring, by BN
constexpr int kGemmStagesN128 = 7;
constexpr int kGemmStagesN256 = 4;
constexpr int kGemmMaxSmem = 232448;    // bytes a block may ask for
constexpr int kGemmATileBytes = kGemmBM * kGemmBK * 2;
constexpr int kGemmABoxBytes = 64 * kGemmBK * 2;   // one warpgroup's rows
constexpr int kGemmPanelBytes = 64 * kGemmBK * 2;  // 64 columns of a kn B
static_assert(kGemmBK * 2 == 128, "a stage's rows are the swizzle's 128 bytes");
constexpr int kGemmMapSlots = 256;      // tensor maps kept on the host
constexpr int kGemmF32Tile = 64;        // the float32 body's tile
constexpr int kGemmF32K = 16;
static_assert(kGemmThreads == (kGemmConsumers + 1) * 128, "warpgroups");
static_assert(128 * kGemmProducerRegs +
                      kGemmConsumers * 128 * kGemmConsumerRegs <= 65536,
              "registers of one CTA");

template <int BN>
__host__ __device__ constexpr int gemm_stages() {
  return BN == 64 ? kGemmStagesN64 : BN == 128 ? kGemmStagesN128
                                                : kGemmStagesN256;
}
template <int BN>
__host__ __device__ constexpr int gemm_stage_bytes() {
  return kGemmATileBytes + BN * kGemmBK * 2;
}
// 1024 bytes to align the ring (the swizzle's period), each stage's A and B
// tiles and its two 8-byte mbarriers
template <int BN>
__host__ __device__ constexpr int gemm_smem() {
  return 1024 + gemm_stages<BN>() * (gemm_stage_bytes<BN>() + 16);
}
static_assert(gemm_smem<64>() <= kGemmMaxSmem, "gemm shared memory, BN 64");
static_assert(gemm_smem<128>() <= kGemmMaxSmem, "gemm shared memory, BN 128");
static_assert(gemm_smem<256>() <= kGemmMaxSmem, "gemm shared memory, BN 256");

// The CTA's columns (BN, the instruction's N) for a bf16 product: a
// function of N, never of M.  The widest of 256, 128 and
// 64 that still cuts N into at least 16 column tiles, else 64: a wide
// product takes the tile that runs a prefill fastest, a narrow one more
// CTAs to stream its w at a decode tick.  Each line is one rule; the first
// that holds decides (a CPU test reads these lines).
inline int gemm_block_n(int n) {
  if (n >= 16 * 256) return 256;
  if (n >= 16 * 128) return 128;
  return 64;
}

// ---------------------------------------------------------------------------
// Device building blocks: mbarriers, TMA, wgmma with both operands in
// shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// arrives once and expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// the box of `map` at element coordinates (c0 innermost, c1) into shared
// memory at dst, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (64 x N) += A (64 x 16) * B (16 x N), both from shared memory; A
// K-major, B K-major (kTransB 0) or MN-major (kTransB 1)
template <int kTransB>
__device__ __forceinline__ void gemm_wgmma_n64(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void gemm_wgmma_n128(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void gemm_wgmma_n256(float (&d)[128],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}

template <int BN, int kTransB>
__device__ __forceinline__ void gemm_wgmma(float (&d)[BN / 2], uint64_t desc_a,
                                           uint64_t desc_b) {
  if constexpr (BN == 64) gemm_wgmma_n64<kTransB>(d, desc_a, desc_b);
  else if constexpr (BN == 128) gemm_wgmma_n128<kTransB>(d, desc_a, desc_b);
  else gemm_wgmma_n256<kTransB>(d, desc_a, desc_b);
}

// ---------------------------------------------------------------------------
// The bf16 body
// ---------------------------------------------------------------------------

// Shared memory, from a 1024-byte boundary: the A tiles of the stages,
// then the B tiles, then full[s] and empty[s].  A stage's A tile is 128
// rows of 128 bytes (two warpgroups' 64 rows, 8 KB apart), its B tile BN
// rows of 128 bytes (nk) or BN / 64 panels of 64 rows (k) by 64 columns
// (kn).  Tiles are stored as TMA's
// 128-byte swizzle lays them out, which is the layout the wgmma
// descriptors name (layout type 1).
template <bool kNK, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    fixed_order_gemm_bf16(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          __nv_bfloat16* __restrict__ y, int M, int N,
                          int K) {
  constexpr int kStages = gemm_stages<BN>();
  constexpr int kBBytes = BN * kGemmBK * 2;             // one B tile
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = a_ring + kStages * kGemmATileBytes;
  const uint32_t full = b_ring + kStages * kBBytes;     // full[s]: + 8 s
  const uint32_t empty = full + 8 * kStages;            // empty[s]: + 8 s
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * kGemmBM;
  const int n0 = blockIdx.x * BN;
  const int kt_n = (K + kGemmBK - 1) / kGemmBK;
  // consumer warpgroups holding a row < M: only their rows of x are copied,
  // and each of their warps frees a stage once its wgmma have read it
  const int live = M - m0 > 64 ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kGemmConsumers) {
    // the producer: one thread keeps the ring full (k-tile kt in stage
    // kt % kStages)
    regs_dealloc<kGemmProducerRegs>();
    if (threadIdx.x == kGemmConsumers * 128) {
      tma_prefetch_map(&map_x);
      tma_prefetch_map(&map_w);
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) + 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, live * kGemmABoxBytes + kBBytes);
        const int k0 = kt * kGemmBK;
        const uint32_t at = a_ring + s * kGemmATileBytes;
        for (int g = 0; g < live; ++g)
          tma_load_2d(at + g * kGemmABoxBytes, &map_x, bar, k0, m0 + 64 * g);
        const uint32_t bt = b_ring + s * kBBytes;
        if constexpr (kNK) {
          tma_load_2d(bt, &map_w, bar, k0, n0);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_2d(bt + p * kGemmPanelBytes, &map_w, bar, n0 + 64 * p,
                        k0);
        }
      }
    }
  } else {
    regs_alloc<kGemmConsumerRegs>();
    if (wg < live) {
      const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % kStages;
        mbar_wait(full + 8 * s, (kt / kStages) & 1);
        const uint32_t at = a_ring + s * kGemmATileBytes + wg * kGemmABoxBytes;
        const uint32_t bt = b_ring + s * kBBytes;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kGemmBK / 16; ++ks) {
          // k16 step ks.  A: the step's 32 bytes of each 128-byte row, 8-row
          // atoms 1024 bytes apart; B likewise (nk), or (kn) rows 16 ks.. of
          // the panels, panels kGemmPanelBytes apart
          const uint64_t da = wgmma_desc(at + ks * 32, 16, 1024, 1);
          const uint64_t db =
              kNK ? wgmma_desc(bt + ks * 32, 16, 1024, 1)
                  : wgmma_desc(bt + ks * 16 * 128, kGemmPanelBytes, 1024, 1);
          gemm_wgmma<BN, kNK ? 0 : 1>(acc, da, db);
        }
        wgmma_commit();
        fence_operands(acc);
        // k-tile kt - 1's wgmma have ended: its stage is free
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_operands(acc);

      // acc[4 i + 2 h + e] is row warp * 16 + lane / 4 + 8 h, column
      // 8 i + 2 (lane % 4) + e of the warpgroup's 64 x BN block
      const int r_lo = m0 + wg * 64 + warp * 16 + (lane >> 2);
      const int cq = (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        if (r >= M) continue;
        __nv_bfloat16* row = y + (long long)r * N;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int c = n0 + 8 * i + cq;
          if (c < N)
            *reinterpret_cast<uint32_t*>(row + c) =
                pack_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      }
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


// ---------------------------------------------------------------------------
// Tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The CUDA driver's tensor-map encoder, looked up once (null if the
// installed CUDA driver has none).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// What a map encodes: a row-major bf16 matrix of `outer` rows of `inner`
// elements, `row_bytes` apart, copied in boxes of box_outer x box_inner.
struct MapKey {
  const void* ptr;
  uint64_t inner, outer, row_bytes;
  uint32_t box_inner, box_outer;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer &&
           row_bytes == o.row_bytes && box_inner == o.box_inner &&
           box_outer == o.box_outer;
  }
};
struct MapSlot {
  CUtensorMap map;
  MapKey key;
  bool used;
};

// The map of `key`, encoded once and kept in a direct-mapped table: a map
// is a function of its key alone (a weight's is found again at every
// call; a freed and reused address with the same shape gives the same
// map).  128-byte swizzle, out-of-bounds elements read as zeros.
inline int gemm_map(CUtensorMap* out, const MapKey& key) {
  static std::mutex mu;
  static MapSlot slots[kGemmMapSlots];
  uint64_t h = reinterpret_cast<uint64_t>(key.ptr) * 0x9E3779B97F4A7C15ull;
  h ^= (key.inner * 31 + key.outer) * 0xC2B2AE3D27D4EB4Full;
  h ^= key.box_outer * 131ull + key.box_inner;
  MapSlot& slot = slots[(h >> 32) % kGemmMapSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (slot.used && slot.key == key) {
    *out = slot.map;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {key.inner, key.outer};
  const cuuint64_t strides[1] = {key.row_bytes};
  const cuuint32_t box[2] = {key.box_inner, key.box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      &slot.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(key.ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) {
    slot.used = false;
    return (int)cudaErrorInvalidValue;
  }
  slot.key = key;
  slot.used = true;
  *out = slot.map;
  return 0;
}

template <bool kNK, int BN>
int launch_gemm_bf16(const void* x, const void* w, void* y, int m, int n,
                     int k, int device, cudaStream_t stream) {
  auto kernel = fixed_order_gemm_bf16<kNK, BN>;
  constexpr int smem = gemm_smem<BN>();
  // the dynamic shared memory limit, set once per instance and device
  static cudaError_t err[kMaxDevices];
  static bool set[kMaxDevices];
  if (!set[device]) {
    err[device] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    set[device] = true;
  }
  if (err[device] != cudaSuccess) return (int)err[device];
  CUtensorMap map_x, map_w;
  int code = gemm_map(&map_x, {x, (uint64_t)k, (uint64_t)m, 2ull * k,
                               (uint32_t)kGemmBK, 64u});
  if (code) return code;
  code = kNK ? gemm_map(&map_w, {w, (uint64_t)k, (uint64_t)n, 2ull * k,
                                 (uint32_t)kGemmBK, (uint32_t)BN})
             : gemm_map(&map_w, {w, (uint64_t)n, (uint64_t)k, 2ull * n, 64u,
                                 (uint32_t)kGemmBK});
  if (code) return code;
  const dim3 grid((n + BN - 1) / BN, (m + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kGemmThreads, smem, stream>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(y), m, n, k);
  return (int)cudaGetLastError();
}

template <bool kNK>
int launch_gemm_bf16_bn(const void* x, const void* w, void* y, int m, int n,
                        int k, int device, cudaStream_t stream) {
  switch (gemm_block_n(n)) {
    case 64:
      return launch_gemm_bf16<kNK, 64>(x, w, y, m, n, k, device, stream);
    case 128:
      return launch_gemm_bf16<kNK, 128>(x, w, y, m, n, k, device, stream);
    case 256:
      return launch_gemm_bf16<kNK, 256>(x, w, y, m, n, k, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// every operand 16-byte aligned, as the tensor maps need) or float32.
// y = x @ w with float32 accumulation, one K order for every m.  Launches
// on `stream`, does not synchronise, allocates nothing on the device;
// returns the CUDA error code of the launch.
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
  if (is_bf16)
    return w_nk ? launch_gemm_bf16_bn<true>(x, w, y, m, n, k, device, s)
                : launch_gemm_bf16_bn<false>(x, w, y, m, n, k, device, s);
  return w_nk ? launch_gemm_f32<true>(x, w, y, m, n, k, s)
              : launch_gemm_f32<false>(x, w, y, m, n, k, s);
}
