// Tiled matrix products written by hand for Hopper (sm_90a): the
// products of the merged graph block (kernel H, graph_block.cu, and its
// backward, kernel I, graph_block_bwd.cu, which replaces
// vqa_project_tpu/ops/pallas/graph_block.py::_block_bwd_kernel) with f32
// operands and at bf16 widths that wgmma_gemm.cuh does not take, and the
// bare product graph_block.cu exports as tile_gemm_run. H's and I's bf16
// products whose operands fit TMA run on wgmma_gemm.cuh.
//
// C (M, N) = op(A) op(B), all operands row-major, in three layouts:
//   kNN  A (M, K),  B (K, N):  x @ W
//   kNT  A (M, K),  B (N, K):  dp @ W^T
//   kTN  A (K, M),  B (K, N):  x^T @ dp, the reduction over A's rows
//        (the B*K node rows for a weight gradient; no atomics, no split)
// with an epilogue that stores f32, stores the operand type, or stores
// f32 gated by a second (M, N) tensor: C = gate > 0 ? acc * scale : 0.
//
// bf16 operands run on the tensor cores through nvcuda::wmma (16x16x16
// bf16 fragments, f32 accumulators): a 128 x 128 block tile, 8 warps of
// 64 x 32, a 32-deep K step, the next K step's tiles loaded from global
// memory into registers while the tensor cores work on the current one
// (two shared-memory stages, one barrier per step). Loads are 16-byte
// vectors where the row stride and base allow it and the vector lies in
// bounds, else element by element with zero fill, so any M, N, K and any
// stride work (the feature width 2052 is not a multiple of 8).
//
// f32 operands run as exact f32 FMAs on the SIMT cores (no TF32): a
// 64 x 64 block tile, a 4 x 4 tile per thread, a 16-deep K step. This is
// the f32 parity path; the model's bf16 path takes the tensor cores.
//
// What bounds these products on an H100: at the graph block's shapes
// (M = B*K = 2304 at B=64, N and K up to 2052) operations, ~2 x 10^10
// flops against a few tens of MB. wmma with register-staged loads does
// not reach the tensor cores' rate (PERF.md has its times beside
// torch.mm and wgmma_gemm.cuh's), which is why the bf16 products that fit
// TMA no longer come here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace tile_gemm {

enum Layout : int { kNN = 0, kNT = 1, kTN = 2 };
enum Mode : int { kStoreF32 = 0, kStoreT = 1, kGateF32 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
struct Epilogue {
  int mode;        // Mode
  void* c;         // (M, N), row stride ldc: float, or T for kStoreT
  int ldc;
  const T* gate;   // kGateF32: (M, N), row stride ldc
  float scale;     // kGateF32: the factor on kept elements
};

template <typename T>
__device__ __forceinline__ void epilogue_at(const Epilogue<T>& ep, int r,
                                            int c, float v) {
  const size_t at = static_cast<size_t>(r) * ep.ldc + c;
  if (ep.mode == kStoreT) {
    store(static_cast<T*>(ep.c) + at, v);
  } else if (ep.mode == kGateF32) {
    static_cast<float*>(ep.c)[at] = to_f32(ep.gate[at]) > 0.f ? v * ep.scale
                                                              : 0.f;
  } else {
    static_cast<float*>(ep.c)[at] = v;
  }
}

// ---------------- bf16: tensor cores (wmma) ----------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256, kPad = 8;
// shared elements of one operand tile, the larger of its two layouts
constexpr int kTileElems = kBM * (kBK + kPad);
static_assert(kTileElems >= kBK * (kBM + kPad), "tile storage");

// An R x W tile (W contiguous in global memory) held in registers as
// 16-byte vectors of eight 16-bit values, two per thread.
template <int R, int W>
struct TileRegs {
  static constexpr int kVecsPerRow = W / 8;
  static constexpr int kPer = R * W / 8 / kThreads;
  static_assert(kPer * kThreads * 8 == R * W, "tile split");
  uint4 v[kPer];

  __device__ __forceinline__ void load(const unsigned short* g, int ld,
                                       int r0, int c0, int rmax, int cmax,
                                       bool vec_ok) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = r0 + idx / kVecsPerRow;
      const int c = c0 + (idx % kVecsPerRow) * 8;
      const unsigned short* p = g + static_cast<size_t>(r) * ld + c;
      if (vec_ok && r < rmax && c + 8 <= cmax) {
        v[i] = *reinterpret_cast<const uint4*>(p);
      } else {
        unsigned short e[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = (r < rmax && c + q < cmax) ? p[q] : 0;
        v[i] = make_uint4(e[0] | (static_cast<unsigned>(e[1]) << 16),
                          e[2] | (static_cast<unsigned>(e[3]) << 16),
                          e[4] | (static_cast<unsigned>(e[5]) << 16),
                          e[6] | (static_cast<unsigned>(e[7]) << 16));
      }
    }
  }

  __device__ __forceinline__ void stash(__nv_bfloat16* s, int lds) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kVecsPerRow, c = (idx % kVecsPerRow) * 8;
      *reinterpret_cast<uint4*>(s + r * lds + c) = v[i];
    }
  }
};

template <int L>
__global__ void __launch_bounds__(kThreads)
wmma_gemm_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, int M, int N, int K,
                 int lda, int ldb, int a_vec, int b_vec,
                 Epilogue<__nv_bfloat16> ep) {
  using namespace nvcuda;
  constexpr bool kAT = L == kTN;            // A stored (K, M)
  constexpr bool kBT = L == kNT;            // B stored (N, K)
  constexpr int kLdA = kAT ? kBM + kPad : kBK + kPad;
  constexpr int kLdB = kBT ? kBK + kPad : kBN + kPad;
  using ALayout = typename std::conditional<kAT, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<kBT, wmma::col_major,
                                            wmma::row_major>::type;
  // A tile: (kBM rows of m, kBK of k), or (kBK rows of k, kBM of m)
  using ARegs = TileRegs<kAT ? kBK : kBM, kAT ? kBM : kBK>;
  using BRegs = TileRegs<kBT ? kBN : kBK, kBT ? kBK : kBN>;

  __shared__ __align__(128) __nv_bfloat16 smem[2][2 * kTileElems];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const unsigned short* a16 = reinterpret_cast<const unsigned short*>(A);
  const unsigned short* b16 = reinterpret_cast<const unsigned short*>(B);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  ARegs ar;
  BRegs br;
  auto fetch = [&](int k0) {
    if (kAT)
      ar.load(a16, lda, k0, m0, K, M, a_vec);
    else
      ar.load(a16, lda, m0, k0, M, K, a_vec);
    if (kBT)
      br.load(b16, ldb, n0, k0, N, K, b_vec);
    else
      br.load(b16, ldb, k0, n0, K, N, b_vec);
  };

  const int steps = (K + kBK - 1) / kBK;
  fetch(0);
  for (int s = 0; s < steps; ++s) {
    __nv_bfloat16* as = smem[s & 1];
    __nv_bfloat16* bs = as + kTileElems;
    ar.stash(as, kLdA);
    br.stash(bs, kLdB);
    __syncthreads();
    if (s + 1 < steps) fetch((s + 1) * kBK);   // in flight during the mma
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16;
        wmma::load_matrix_sync(fa[i], kAT ? as + kk * kLdA + r
                                          : as + r * kLdA + kk, kLdA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn + j * 16;
        wmma::load_matrix_sync(fb[j], kBT ? bs + c * kLdB + kk
                                          : bs + kk * kLdB + c, kLdB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();   // every warp is done with the operand tiles

  // epilogue: each warp stages one 16 x 16 fragment at a time in its own
  // 1 KB of the (now free) operand storage, then applies the epilogue
  float* stage = reinterpret_cast<float*>(&smem[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t;
        const int r = m0 + wm + i * 16 + e / 16;
        const int c = n0 + wn + j * 16 + e % 16;
        if (r < M && c < N) epilogue_at(ep, r, c, stage[e]);
      }
      __syncwarp();
    }
}

// ---------------- f32: exact SIMT FMAs ----------------

constexpr int kFM = 64, kFN = 64, kFK = 16;

template <int L>
__global__ void __launch_bounds__(kThreads)
f32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                int M, int N, int K, int lda, int ldb, Epilogue<float> ep) {
  constexpr bool kAT = L == kTN;
  constexpr bool kBT = L == kNT;
  __shared__ __align__(16) float as[kFK][kFM];
  __shared__ __align__(16) float bs[kFK][kFN];
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
    // neighbouring threads on neighbouring global addresses
#pragma unroll
    for (int q = 0; q < kFM * kFK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      int m, k;
      if (kAT) {
        k = e / kFM;
        m = e % kFM;
      } else {
        m = e / kFK;
        k = e % kFK;
      }
      const int gm = m0 + m, gk = k0 + k;
      float v = 0.f;
      if (gm < M && gk < K)
        v = kAT ? A[static_cast<size_t>(gk) * lda + gm]
                : A[static_cast<size_t>(gm) * lda + gk];
      as[k][m] = v;
    }
#pragma unroll
    for (int q = 0; q < kFN * kFK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      int n, k;
      if (kBT) {
        n = e / kFK;
        k = e % kFK;
      } else {
        k = e / kFN;
        n = e % kFN;
      }
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.f;
      if (gn < N && gk < K)
        v = kBT ? B[static_cast<size_t>(gn) * ldb + gk]
                : B[static_cast<size_t>(gk) * ldb + gn];
      bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < M && c < N) epilogue_at(ep, r, c, acc[i][j]);
    }
}

// ---------------- launch ----------------

inline bool vec16(const void* p, int ld) {
  return ld % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int L>
cudaError_t launch_layout(const __nv_bfloat16* A, const __nv_bfloat16* B,
                          int M, int N, int K, int lda, int ldb,
                          Epilogue<__nv_bfloat16> ep, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  wmma_gemm_kernel<L><<<grid, kThreads, 0, s>>>(
      A, B, M, N, K, lda, ldb, vec16(A, lda), vec16(B, ldb), ep);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_layout(const float* A, const float* B, int M, int N,
                          int K, int lda, int ldb, Epilogue<float> ep,
                          cudaStream_t s) {
  const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  f32_gemm_kernel<L><<<grid, kThreads, 0, s>>>(A, B, M, N, K, lda, ldb, ep);
  return cudaGetLastError();
}

// C = op(A) op(B) with the given layout and epilogue; the element type T
// (float or __nv_bfloat16) picks the SIMT or the tensor-core kernel.
// One launch. Returns cudaError_t.
template <typename T>
cudaError_t gemm(int layout, const T* A, const T* B, int M, int N, int K,
                 int lda, int ldb, Epilogue<T> ep, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || !ep.c ||
      (ep.mode == kGateF32 && !ep.gate) ||
      (M + kFM - 1) / kFM > 65535)
    return cudaErrorInvalidValue;
  switch (layout) {
    case kNN:
      return launch_layout<kNN>(A, B, M, N, K, lda, ldb, ep, s);
    case kNT:
      return launch_layout<kNT>(A, B, M, N, K, lda, ldb, ep, s);
    case kTN:
      return launch_layout<kTN>(A, B, M, N, K, lda, ldb, ep, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tile_gemm
