// The product C (M, N) = op(A) op(B) with bf16 operands on Hopper's
// wgmma, fed by TMA (sm_90a), f32 sums, in the layouts of tile_gemm.cuh:
//   kNN  A (M, K),  B (K, N):  x @ W            (kernel H's projections)
//   kNT  A (M, K),  B (N, K):  dp @ W^T         (kernel I's g1, dfeats)
//   kTN  A (K, M),  B (K, N):  x^T @ dp         (kernel I's dW1, dW2)
// with tile_gemm.cuh's epilogues: store f32, store bf16, or store f32
// gated by a bf16 (M, N) tensor, C = gate > 0 ? acc * scale : 0 (the
// relu + dropout gate of kernel I's g1). Used by graph_block.cu (kernel
// H) and graph_block_bwd.cu (kernel I).
//
// What bounds it on an H100: operations. At B=64 the block's largest
// product is 2304 x 2048 x 2052 (19.4 GFLOP, 0.020 ms at 989 TFLOP/s)
// against ~27 MB of operands and f32 output (0.008 ms at 3.35 TB/s).
//
// Design, from gru_wgrad.cu's (kernel E's dW/db): a block of one producer
// warpgroup (one thread issues the loads) and BM / 64 consumer
// warpgroups owns a BM x BN tile of C (64 rows a consumer, the wgmma's
// M; BN its N): 128 x 128, 128 x 256 or 192 x 192, picked per product by
// pick_tile. Small tiles read their operands from L2 at 64 flops a byte
// and run into its bandwidth; large ones leave SMs idle in the last round
// of tiles (proj1 at B=64: 144 tiles of 128 x 256 take two rounds on 132
// SMs, 132 tiles of 192 x 192 one). A ring of 64-deep K steps in shared
// memory (up to 192 KB) is filled by TMA (64 x 64 boxes, 128-byte
// swizzle) and drained by the consumers, one stage's wgmma group in
// flight while they wait for the next; full/empty mbarriers hand the
// stages over. Each operand lies in shared memory as it lies in device
// memory:
// - K-major (A of kNN / kNT, B of kNT: a row is K): a box is 64 rows of
//   M (N) by 64 of K, the boxes of a tile stacked along M (N); a k16
//   step is 32 bytes further along the swizzled 128-byte rows, and the
//   instruction's transpose bit is clear.
// - MN-major (A of kTN, B of kNN / kTN: a row is M or N): a box is 64 of
//   M (N) by 64 rows of K, the boxes of a tile side by side; a k16 step
//   is 16 rows further on, and the transpose bit is set.
// The blocks run a persistent tile loop: at most one block per SM, each
// walking the tiles with a stride of the grid, the tiles split evenly, so
// the producer fills the next tile's stages while a tile's epilogue runs.
// The epilogue works straight from the accumulator fragments: a thread
// owns two adjacent columns of two rows per 8 columns, and reads the gate
// at the same (row, column) as the value it scales.
//
// The K tail and the M and N edges need no code: TMA fills what lies
// outside A and B with zeros, so the feature width 2052 (the K of proj1,
// the M of dW1, the N of dfeats) and B*K rows that are not a multiple of
// 64 (the K of dW1 and dW2) are read through (rows, 2052) views whose
// row strides are multiples of 8 elements (TMA's 16-byte stride rule),
// and the epilogue stores only the rows and columns inside C. Each
// element of C is summed over the K steps in one order, with no split
// over K and no atomics, so C repeats bit for bit.

#pragma once

#include "wgmma.cuh"

namespace wgmma_gemm {

enum Layout : int { kNN = 0, kNT = 1, kTN = 2 };
enum Mode : int { kStoreF32 = 0, kStoreBf16 = 1, kGateF32 = 2 };

struct Epilogue {
  int mode;                     // Mode
  void* c;                      // (M, N), row stride ldc: float or bf16
  int ldc;
  const __nv_bfloat16* gate;    // kGateF32: (M, N), row stride ldc
  float scale;                  // kGateF32: the factor on kept elements
};

constexpr int kBK = 64;                // K depth of a ring stage
constexpr int kBox = 64 * 64 * 2;      // bytes of one 64 x 64 bf16 box

// A BM x BN tile: BM / 64 consumer warpgroups (64 rows each, the wgmma's
// M), one producer warpgroup, BN columns (the wgmma's N)
template <int BM, int BN>
struct Tile {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kStageBytes = (kConsumers + BN / 64) * kBox;
  static constexpr int kStages = (192 * 1024) / kStageBytes;
  static constexpr int kRing = kStages * kStageBytes;
  // ring, full and empty barriers, and slack to align the ring to 1024
  static constexpr int kSmem = kRing + 2 * kStages * 8 + 1024;
  static_assert(BM % 64 == 0 && BN % 64 == 0 && kStages >= 2, "tile");
  static_assert(kSmem <= 227 * 1024, "shared memory per block");
};

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&acc)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 128)
    wgmma::mma_m64n128k16<TA, TB>(acc, da, db);
  else if constexpr (BN == 192)
    wgmma::mma_m64n192k16<TA, TB>(acc, da, db);
  else
    wgmma::mma_m64n256k16<TA, TB>(acc, da, db);
}

// Only NT products (kernel I's g1 and dfeats) take the gate and bf16
// epilogues; NN and TN products store f32 and compile no other: with the
// three modes' branches in its epilogue, kernel H's proj2 on 128 x 256
// tiles ran slower inside H (PERF.md).
template <int L>
constexpr bool kAnyEpilogue = L == kNT;

// columns col, col + 1 of C's row `row` (col < N); vec2: both lie inside
// and every pair access is aligned
template <bool kAny>
__device__ __forceinline__ void store_pair(const Epilogue& ep, int row,
                                           int col, int N, float v0,
                                           float v1, int vec2) {
  const size_t at = static_cast<size_t>(row) * ep.ldc + col;
  const bool two = col + 1 < N;
  if (kAny && ep.mode == kGateF32) {
    float g0, g1 = 0.f;
    if (vec2) {
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ep.gate + at));
      g0 = g.x;
      g1 = g.y;
    } else {
      g0 = __bfloat162float(ep.gate[at]);
      if (two) g1 = __bfloat162float(ep.gate[at + 1]);
    }
    v0 = g0 > 0.f ? v0 * ep.scale : 0.f;
    v1 = g1 > 0.f ? v1 * ep.scale : 0.f;
  }
  if (kAny && ep.mode == kStoreBf16) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(ep.c) + at;
    if (vec2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
      p[0] = __float2bfloat16_rn(v0);
      if (two) p[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* p = static_cast<float*>(ep.c) + at;
    if (vec2) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (two) p[1] = v1;
    }
  }
}

// kAT: A is stored (K, M), MN-major (kTN); kBT: B is stored (N, K),
// K-major (kNT)
template <int BM, int BN, bool kAT, bool kBT>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, Epilogue ep, int M,
            int N, int K, int vec2) {
  using T = Tile<BM, BN>;
  constexpr int kConsumers = T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled boxes need 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kRing);
  uint64_t* empty = full + T::kStages;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_m * ((N + BN - 1) / BN);
  const int nk = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], kConsumers * 4);  // one per consumer warp
    }
    wgmma::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: one thread issues every load
    if (tid % 128 == 0) {
      int it = 0;  // K steps issued, over all tiles: the ring position
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile % tiles_m * BM, n0 = tile / tiles_m * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % T::kStages, round = it / T::kStages;
          if (round > 0) wgmma::mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* st = smem + s * T::kStageBytes;
          wgmma::mbar_arrive_expect_tx(&full[s], T::kStageBytes);
          // a map's coordinates are (inner, outer)
          for (int q = 0; q < kConsumers; ++q) {
            const int m = m0 + 64 * q, k = kt * kBK;
            wgmma::tma_load_2d(st + q * kBox, &map_a, &full[s],
                               kAT ? m : k, kAT ? k : m);
          }
          for (int q = 0; q < BN / 64; ++q) {
            const int n = n0 + 64 * q, k = kt * kBK;
            wgmma::tma_load_2d(st + (kConsumers + q) * kBox, &map_b,
                               &full[s], kBT ? k : n, kBT ? n : k);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63 of each tile
  const int wr = ((tid % 128) / 32) * 16 + lane / 4, wc = (lane % 4) * 2;
  int it = 0;  // K steps consumed, over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile % tiles_m * BM, n0 = tile / tiles_m * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % T::kStages;
      wgmma::mbar_wait(&full[s], (it / T::kStages) & 1);
      const uint32_t a =
          wgmma::smem_u32(smem + s * T::kStageBytes + wg * kBox);
      const uint32_t b =
          wgmma::smem_u32(smem + s * T::kStageBytes + kConsumers * kBox);
      wgmma::fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        // K-major: 32 bytes along the rows; MN-major: 16 rows on, the
        // boxes of the tile kBox apart
        const uint64_t da = kAT ? wgmma::desc_sw128(a + k * 2048, kBox, 1024)
                                : wgmma::desc_sw128(a + k * 32, 16, 1024);
        const uint64_t db = kBT ? wgmma::desc_sw128(b + k * 32, 16, 1024)
                                : wgmma::desc_sw128(b + k * 2048, kBox, 1024);
        mma<BN, kAT ? 1 : 0, kBT ? 0 : 1>(acc, da, db);
      }
      wgmma::commit();
      // keep this stage's products in flight; the previous stage's are
      // done, so its buffers go back to the producer
      wgmma::wait<1>();
      __syncwarp();
      if (kt > 0 && lane == 0)
        wgmma::mbar_arrive(&empty[(it - 1) % T::kStages]);
    }
    wgmma::wait<0>();
    __syncwarp();
    if (nk > 0 && lane == 0)
      wgmma::mbar_arrive(&empty[(it - 1) % T::kStages]);

    // epilogue: fragment rows r and r + 8, columns 8 i + wc, + 1; the
    // producer is already filling the ring for the next tile
    const int r = m0 + 64 * wg + wr;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + wc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        if (row < M && col < N)
          store_pair<!kAT && kBT>(ep, row, col, N, acc[4 * i + 2 * h],
                                  acc[4 * i + 2 * h + 1], vec2);
      }
    }
  }
}

// Number of SMs of the current device, read once per process.
inline cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                 device);
    if (e != cudaSuccess) return e;
  }
  *sms = cached;
  return cudaSuccess;
}

// The tiles a product can take, as (BM, BN), and the rule that picks one:
// the fewest rounds of tiles over the SMs times the tile's area, 128 x 128
// tiles counted 1 / 0.7 as dear (their operand stream from L2, 64 flops a
// byte, holds them at ~70% of the larger tiles' rate on the H100;
// PERF.md). Ties go to the earlier entry.
constexpr int kTiles[3][2] = {{128, 256}, {192, 192}, {128, 128}};

inline int pick_tile(int M, int N, int sms) {
  int best = 0;
  double best_cost = 0.0;
  for (int t = 0; t < 3; ++t) {
    const int bm = kTiles[t][0], bn = kTiles[t][1];
    const long long tiles =
        static_cast<long long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
    const double cost = static_cast<double>((tiles + sms - 1) / sms) * bm *
                        bn / (bm * bn == 128 * 128 ? 0.7 : 1.0);
    if (t == 0 || cost < best_cost) {
      best = t;
      best_cost = cost;
    }
  }
  return best;
}

// Whether the product takes A (row stride lda) and B (row stride ldb):
// TMA reads rows at strides that are multiples of 16 bytes from 16-byte
// aligned starts. The rule kernels H and I use to pick this product or
// tile_gemm.cuh's for bf16 operands.
inline bool fits(const void* A, int lda, const void* B, int ldb) {
  return lda % 8 == 0 && ldb % 8 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(B) % 16 == 0;
}

// static: each library that includes this header (graph_block.cu,
// graph_block_bwd.cu) sets the shared-memory attribute of its own copy of
// the kernel. A static local of an inline function would be one object
// across every library of the process, and the second library's kernel
// would launch unconfigured.
template <int BM, int BN, bool kAT, bool kBT>
static cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                          const Epilogue& ep, int M, int N, int K, int vec2,
                          int sms, cudaStream_t s) {
  using T = Tile<BM, BN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<BM, BN, kAT, kBT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // as few blocks as keep the busiest one to the same number of tiles
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  const int waves = (tiles + sms - 1) / sms;
  const int blocks = (tiles + waves - 1) / waves;
  gemm_kernel<BM, BN, kAT, kBT><<<blocks, T::kThreads, T::kSmem, s>>>(
      ma, mb, ep, M, N, K, vec2);
  return cudaGetLastError();
}

// C (M, N) = op(A) op(B) in layout L (A row stride lda, B row stride
// ldb, both bf16), through the epilogue ep (C's row stride ep.ldc; NN
// and TN store f32 only, kAnyEpilogue). lda
// and ldb must be multiples of 8 and A and B 16-byte aligned (fits). The
// tile (bm x bn) is one of kTiles, or 0 x 0 for pick_tile's choice. One
// launch.
template <int L>
cudaError_t gemm(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                 int ldb, const Epilogue& ep, int M, int N, int K, int bm,
                 int bn, cudaStream_t s) {
  static_assert(L == kNN || L == kNT || L == kTN, "layout");
  constexpr bool kAT = L == kTN, kBT = L == kNT;
  if (M <= 0 || N <= 0 || K <= 0 || !fits(A, lda, B, ldb) ||
      lda < (kAT ? M : K) || ldb < (kBT ? K : N) || ep.ldc < N || !ep.c ||
      ep.mode < kStoreF32 || ep.mode > kGateF32 ||
      (ep.mode != kStoreF32 && !kAnyEpilogue<L>) ||
      (ep.mode == kGateF32 && !ep.gate))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  if (bm == 0 && bn == 0) {
    const int t = pick_tile(M, N, sms);
    bm = kTiles[t][0];
    bn = kTiles[t][1];
  }
  // maps of (outer, inner) = (rows, row width) as the operands lie
  CUtensorMap ma, mb;
  e = wgmma::make_map_bf16(&ma, A, kAT ? M : K, kAT ? K : M,
                           static_cast<uint64_t>(lda) * 2, 64, 64);
  if (e != cudaSuccess) return e;
  e = wgmma::make_map_bf16(&mb, B, kBT ? K : N, kBT ? N : K,
                           static_cast<uint64_t>(ldb) * 2, 64, 64);
  if (e != cudaSuccess) return e;
  const int pair = ep.mode == kStoreBf16 ? 4 : 8;  // bytes of a C pair
  const int vec2 =
      N % 2 == 0 && ep.ldc % 2 == 0 &&
      reinterpret_cast<uintptr_t>(ep.c) % pair == 0 &&
      (ep.mode != kGateF32 || reinterpret_cast<uintptr_t>(ep.gate) % 4 == 0);
  if (bm == 128 && bn == 128)
    return launch<128, 128, kAT, kBT>(ma, mb, ep, M, N, K, vec2, sms, s);
  if (bm == 128 && bn == 256)
    return launch<128, 256, kAT, kBT>(ma, mb, ep, M, N, K, vec2, sms, s);
  if (bm == 192 && bn == 192)
    return launch<192, 192, kAT, kBT>(ma, mb, ep, M, N, K, vec2, sms, s);
  return cudaErrorInvalidValue;
}

}  // namespace wgmma_gemm
