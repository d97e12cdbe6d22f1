// The held experts' products of a mixture-of-experts layer as one launch
// each, grouped by offsets that live in device memory: the rows of every
// (token, slot) pair routed to a held expert lie sorted by expert, group
// e at rows off[e] .. off[e + 1] - 1, and no count reaches the host, so
// the launches replay inside a CUDA graph whatever the routing.
//
//   kNT  C[off_e:off_e1] (rows, N) = A[off_e:off_e1] (rows, K) B[e]^T,
//        B (G, N, K): the forward products x W_up^T and a W_down^T
//   kNN  C[off_e:off_e1] (rows, N) = A[off_e:off_e1] (rows, K) B[e],
//        B (G, K, N): the input gradients dh W_up and dy W_down
//   kTN  C[e] (M, N) = A[off_e:off_e1]^T (rows, M) B[off_e:off_e1]
//        (rows, N): the weight gradients dh^T x and dy^T a
//
// bf16 operands, f32 sums, three epilogues: store f32; kRelu2, the
// expert's activation, C = bf16(relu(acc)^2) and AUX = bf16(relu(acc));
// kDact, its derivative, C = bf16(acc * 2 * GATE) with GATE (rows, N)
// bf16 the forward's AUX (relu(acc) >= 0, so 2 relu(h) is d relu(h)^2).
//
// Built on wgmma_gemm.cuh: its tile (Tile<128, BN>: two consumer
// warpgroups of 64 rows and one producer warpgroup whose one thread
// issues the TMA loads), its ring of 64-deep K stages with full/empty
// mbarriers, its operand layouts in shared memory and its wgmma calls.
// What is new is the walk over tiles: each persistent block reads the
// offsets into shared memory and
// - kNT / kNN: counts each group's row tiles (its rows over 128, so a
//   group of 0 rows has none) and walks the tiles of all groups, row
//   tiles fastest, with the grid's stride; B's tile is group e's slice.
//   The tiles of a group read rows up to the next multiple of 128 past
//   its start and store only its own rows.
// - kTN: walks the static G x (M / 128) x (N / BN) output tiles, and
//   sums the K steps of its group's rows only; a group of 0 rows stores
//   zeros. Rows are summed in whole 64-row K steps, so each group's
//   count must be padded to a multiple of 64 with zero rows (the
//   dispatch pads to 128, so that no row tile straddles two groups).
// Each element of C is summed over its K steps in one order, with no
// split over K and no atomics, so C repeats bit for bit.
//
// What bounds it on an H100: at Nemotron-3-Nano's widths (2688 -> 1856
// -> 2688) a held expert's ~180-360 rows make each product ~2-4 GFLOP
// against ~10 MB of the expert's weights: operations for the row
// products above ~300 rows, bytes below (portbench/counts/nemotron_h.py
// counts both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace {

using wgmma_gemm::kBK;
using wgmma_gemm::kBox;
using wgmma_gemm::kNN;
using wgmma_gemm::kNT;
using wgmma_gemm::kTN;
using wgmma_gemm::Tile;

enum Epi : int { kF32 = 0, kRelu2 = 1, kDact = 2 };

constexpr int kBM = 128;          // rows of a tile: two consumer warpgroups
constexpr int kMaxGroups = 256;   // experts one launch may hold

struct Out {
  void* c;                        // f32 (kF32) or bf16
  __nv_bfloat16* aux;             // kRelu2: relu(acc)
  const __nv_bfloat16* gate;      // kDact: the forward's relu(acc)
  int ldc;
};

template <int EPI>
__device__ __forceinline__ void put(const Out& o, size_t at, bool two,
                                    float v0, float v1, int vec2) {
  if constexpr (EPI == kF32) {
    float* p = static_cast<float*>(o.c) + at;
    if (vec2) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (two) p[1] = v1;
    }
  } else {
    float w0, w1;
    if constexpr (EPI == kRelu2) {
      const float r0 = fmaxf(v0, 0.f), r1 = fmaxf(v1, 0.f);
      w0 = r0 * r0;
      w1 = r1 * r1;
      if (vec2) {
        *reinterpret_cast<__nv_bfloat162*>(o.aux + at) =
            __floats2bfloat162_rn(r0, r1);
      } else {
        o.aux[at] = __float2bfloat16_rn(r0);
        if (two) o.aux[at + 1] = __float2bfloat16_rn(r1);
      }
    } else {
      float g0, g1 = 0.f;
      if (vec2) {
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o.gate + at));
        g0 = g.x;
        g1 = g.y;
      } else {
        g0 = __bfloat162float(o.gate[at]);
        if (two) g1 = __bfloat162float(o.gate[at + 1]);
      }
      w0 = v0 * 2.f * g0;
      w1 = v1 * 2.f * g1;
    }
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(o.c) + at;
    if (vec2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(w0, w1);
    } else {
      p[0] = __float2bfloat16_rn(w0);
      if (two) p[1] = __float2bfloat16_rn(w1);
    }
  }
}

// One output tile: group e, rows [m0, m_end) of C (kNT / kNN: rows of the
// sorted buffer; kTN: rows of C[e]), columns n0.., and K steps from row
// k0 of the operands' K axis, nk of them.
struct Job {
  int e, m0, m_end, n0, k0, nk;
};

// The walk over tiles, the same for the producer and the consumers.
template <int L, int BN>
struct Walk {
  const int* off;    // shared: the G + 1 offsets
  const int* first;  // shared (kNT / kNN): each group's first tile
  int G, M, N, K;
  int e = 0;         // kNT / kNN: the group of the last tile, monotone

  __device__ int tiles() const {
    const int tn = (N + BN - 1) / BN;
    if constexpr (L == kTN) return G * ((M + kBM - 1) / kBM) * tn;
    return first[G];
  }

  __device__ Job job(int t) {
    const int tn = (N + BN - 1) / BN;
    Job j;
    if constexpr (L == kTN) {
      const int tm = (M + kBM - 1) / kBM;
      j.e = t / (tm * tn);
      const int r = t % (tm * tn);
      j.m0 = r % tm * kBM;
      j.m_end = M;
      j.n0 = r / tm * BN;
      j.k0 = off[j.e];
      j.nk = (off[j.e + 1] - off[j.e] + kBK - 1) / kBK;
    } else {
      while (t >= first[e + 1]) ++e;
      const int r = t - first[e];
      const int tm = (off[e + 1] - off[e] + kBM - 1) / kBM;
      j.e = e;
      j.m0 = off[e] + r % tm * kBM;
      j.m_end = off[e + 1];
      j.n0 = r / tm * BN;
      j.k0 = 0;
      j.nk = (K + kBK - 1) / kBK;
    }
    return j;
  }
};

template <int BN, int L, int EPI>
__global__ void __launch_bounds__(Tile<kBM, BN>::kThreads, 1)
grouped_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, Out out,
               const int* __restrict__ offsets, int G, int M, int N, int K,
               int vec2) {
  using T = Tile<kBM, BN>;
  constexpr int kConsumers = T::kConsumers;
  constexpr bool kAT = L == kTN, kBT = L == kNT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_off[kMaxGroups + 1];
  __shared__ int s_first[kMaxGroups + 1];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kRing);
  uint64_t* empty = full + T::kStages;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  for (int i = tid; i <= G; i += blockDim.x) s_off[i] = offsets[i];
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], kConsumers * 4);  // one per consumer warp
    }
    wgmma::mbar_init_fence();
  }
  __syncthreads();
  if (L != kTN && tid == 0) {
    int acc = 0;
    for (int e = 0; e < G; ++e) {
      s_first[e] = acc;
      acc += (s_off[e + 1] - s_off[e] + kBM - 1) / kBM *
             ((N + BN - 1) / BN);
    }
    s_first[G] = acc;
  }
  __syncthreads();
  Walk<L, BN> walk{s_off, s_first, G, M, N, K};
  const int tiles = walk.tiles();

  if (wg == kConsumers) {  // the producer: one thread issues every load
    if (tid % 128 == 0) {
      int it = 0;  // K steps issued, over all tiles: the ring position
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Job j = walk.job(tile);
        for (int kt = 0; kt < j.nk; ++kt, ++it) {
          const int s = it % T::kStages, round = it / T::kStages;
          if (round > 0) wgmma::mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* st = smem + s * T::kStageBytes;
          wgmma::mbar_arrive_expect_tx(&full[s], T::kStageBytes);
          const int k = j.k0 + kt * kBK;
          // a map's coordinates are (inner, outer)
          for (int q = 0; q < kConsumers; ++q) {
            const int m = j.m0 + 64 * q;
            wgmma::tma_load_2d(st + q * kBox, &map_a, &full[s],
                               kAT ? m : kt * kBK, kAT ? k : m);
          }
          for (int q = 0; q < BN / 64; ++q) {
            const int n = j.n0 + 64 * q;
            if (L == kNT)       // B (G N, K): group e's rows e N ..
              wgmma::tma_load_2d(st + (kConsumers + q) * kBox, &map_b,
                                 &full[s], kt * kBK, j.e * N + n);
            else if (L == kNN)  // B (G K, N): group e's rows e K ..
              wgmma::tma_load_2d(st + (kConsumers + q) * kBox, &map_b,
                                 &full[s], n, j.e * K + kt * kBK);
            else                // B (rows, N): the group's rows
              wgmma::tma_load_2d(st + (kConsumers + q) * kBox, &map_b,
                                 &full[s], n, k);
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
    const Job j = walk.job(tile);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < j.nk; ++kt, ++it) {
      const int s = it % T::kStages;
      wgmma::mbar_wait(&full[s], (it / T::kStages) & 1);
      const uint32_t a =
          wgmma::smem_u32(smem + s * T::kStageBytes + wg * kBox);
      const uint32_t b =
          wgmma::smem_u32(smem + s * T::kStageBytes + kConsumers * kBox);
      wgmma::fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        const uint64_t da = kAT ? wgmma::desc_sw128(a + k * 2048, kBox, 1024)
                                : wgmma::desc_sw128(a + k * 32, 16, 1024);
        const uint64_t db = kBT ? wgmma::desc_sw128(b + k * 32, 16, 1024)
                                : wgmma::desc_sw128(b + k * 2048, kBox, 1024);
        wgmma_gemm::mma<BN, kAT ? 1 : 0, kBT ? 0 : 1>(acc, da, db);
      }
      wgmma::commit();
      wgmma::wait<1>();
      __syncwarp();
      if (kt > 0 && lane == 0)
        wgmma::mbar_arrive(&empty[(it - 1) % T::kStages]);
    }
    wgmma::wait<0>();
    __syncwarp();
    if (j.nk > 0 && lane == 0)
      wgmma::mbar_arrive(&empty[(it - 1) % T::kStages]);

    // kTN stores C[e]; the others the group's rows of the sorted buffer
    const size_t base = L == kTN ? static_cast<size_t>(j.e) * M * out.ldc : 0;
    const int r = j.m0 + 64 * wg + wr;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = j.n0 + 8 * i + wc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        if (row < j.m_end && col < N)
          put<EPI>(out, base + static_cast<size_t>(row) * out.ldc + col,
                   col + 1 < N, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1],
                   vec2);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

template <int BN, int L, int EPI>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                   const Out& o, const int* offsets, int G, int M, int N,
                   int K, int vec2, int blocks, cudaStream_t s) {
  using T = Tile<kBM, BN>;
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    e = cudaFuncSetAttribute(grouped_kernel<BN, L, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
    if (e != cudaSuccess) return e;
    configured[device] = true;
  }
  grouped_kernel<BN, L, EPI><<<blocks, T::kThreads, T::kSmem, s>>>(
      ma, mb, o, offsets, G, M, N, K, vec2);
  return cudaGetLastError();
}

template <int BN, int L>
cudaError_t launch_epi(int epi, const CUtensorMap& ma, const CUtensorMap& mb,
                       const Out& o, const int* offsets, int G, int M, int N,
                       int K, int vec2, int blocks, cudaStream_t s) {
  if (epi == kF32)
    return launch<BN, L, kF32>(ma, mb, o, offsets, G, M, N, K, vec2, blocks,
                               s);
  if constexpr (L == kNT) {
    if (epi == kRelu2)
      return launch<BN, L, kRelu2>(ma, mb, o, offsets, G, M, N, K, vec2,
                                   blocks, s);
  }
  if constexpr (L == kNN) {
    if (epi == kDact)
      return launch<BN, L, kDact>(ma, mb, o, offsets, G, M, N, K, vec2,
                                  blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The grouped product (see the top of this file). A (rows, K) for kNT /
// kNN, (rows, M) for kTN; B (G, N, K) kNT, (G, K, N) kNN, (rows, N) kTN;
// C (rows, N) for kNT / kNN, (G, M, N) for kTN, row stride N; offsets
// (G + 1) int32 on the card, non-decreasing, offsets[G] <= rows, each a
// multiple of 64 for kTN. kRelu2 takes kNT and writes aux (rows, N) bf16,
// kDact takes kNN and reads gate (rows, N) bf16; every other product
// stores f32. bn is 128 or 256. Every row stride a multiple of 8
// elements and every operand 16-byte aligned. One launch.
extern "C" int moe_grouped_gemm(const void* A, const void* B, void* C,
                                void* aux, const void* gate,
                                const void* offsets, int G, int rows, int M,
                                int N, int K, int layout, int epilogue, int bn,
                                void* stream) {
  if (G <= 0 || G > kMaxGroups || rows < 0 || N <= 0 || N % 8 ||
      (layout == kTN ? (M <= 0 || M % 8) : (K <= 0 || K % 8)) ||
      reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(B) % 16 || !C || !offsets ||
      (epilogue == kRelu2 && (layout != kNT || !aux)) ||
      (epilogue == kDact && (layout != kNN || !gate)) ||
      (bn != 128 && bn != 256))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = wgmma_gemm::sm_count(&sms);
  if (e != cudaSuccess) return e;
  CUtensorMap ma, mb;
  const int r = rows > 0 ? rows : 1;  // a map of no rows is refused
  if (layout == kTN) {
    e = wgmma::make_map_bf16(&ma, A, M, r, static_cast<uint64_t>(M) * 2, 64,
                             64);
    if (e == cudaSuccess)
      e = wgmma::make_map_bf16(&mb, B, N, r, static_cast<uint64_t>(N) * 2,
                               64, 64);
  } else {
    e = wgmma::make_map_bf16(&ma, A, K, r, static_cast<uint64_t>(K) * 2, 64,
                             64);
    if (e == cudaSuccess && layout == kNT)
      e = wgmma::make_map_bf16(&mb, B, K, static_cast<uint64_t>(G) * N,
                               static_cast<uint64_t>(K) * 2, 64, 64);
    else if (e == cudaSuccess)
      e = wgmma::make_map_bf16(&mb, B, N, static_cast<uint64_t>(G) * K,
                               static_cast<uint64_t>(N) * 2, 64, 64);
  }
  if (e != cudaSuccess) return e;
  const Out o{C, static_cast<__nv_bfloat16*>(aux),
              static_cast<const __nv_bfloat16*>(gate), N};
  const int pair = epilogue == kF32 ? 8 : 4;
  const int vec2 = reinterpret_cast<uintptr_t>(C) % pair == 0 &&
                   (!aux || reinterpret_cast<uintptr_t>(aux) % 4 == 0) &&
                   (!gate || reinterpret_cast<uintptr_t>(gate) % 4 == 0);
  // kNT / kNN: the tiles are counted on the card, so every SM gets a
  // block; kTN: as few blocks as keep the busiest to the same tiles
  int blocks = sms;
  if (layout == kTN) {
    const long long tiles = static_cast<long long>(G) * ((M + kBM - 1) / kBM) *
                            ((N + bn - 1) / bn);
    const long long waves = (tiles + sms - 1) / sms;
    blocks = static_cast<int>((tiles + waves - 1) / waves);
  }
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kNT)
    return bn == 128
               ? launch_epi<128, kNT>(epilogue, ma, mb, o, off, G, M, N, K,
                                      vec2, blocks, s)
               : launch_epi<256, kNT>(epilogue, ma, mb, o, off, G, M, N, K,
                                      vec2, blocks, s);
  if (layout == kNN)
    return bn == 128
               ? launch_epi<128, kNN>(epilogue, ma, mb, o, off, G, M, N, K,
                                      vec2, blocks, s)
               : launch_epi<256, kNN>(epilogue, ma, mb, o, off, G, M, N, K,
                                      vec2, blocks, s);
  if (layout == kTN)
    return bn == 128
               ? launch_epi<128, kTN>(epilogue, ma, mb, o, off, G, M, N, K,
                                      vec2, blocks, s)
               : launch_epi<256, kTN>(epilogue, ma, mb, o, off, G, M, N, K,
                                      vec2, blocks, s);
  return cudaErrorInvalidValue;
}
