// The merged graph block's forward (kernel H), for Hopper (sm_90a):
//
//   out = relu(conv2(mask, dropout(relu(conv1(alpha, feats @ W1))) @ W2))
//
// Replaces the TPU kernel vqa_project_tpu/ops/pallas/graph_block.py
// ::_block_fwd_kernel (entry fused_graph_block). With n Gaussian kernels,
// W1cat (F1, n*d1) and W2cat (n*d1, n*d2) hold the per-kernel projections
// side by side (column block n*d:(n+1)*d is kernel n), and per image:
//
//   proj1 = feats @ W1cat                   f32 sums
//   mask  = the m largest entries of each adjacency row, ties to the
//           lowest index (a pairwise rank, as _select_both); alpha = the
//           softmax of the adjacency over them
//   h1    = relu(sum_j alpha * ghat1_n (i, j) proj1_n[j]), then inverted
//           dropout, stored in the compute dtype
//   proj2 = h1 @ W2cat                      f32 sums
//   out   = relu(sum_j mask * ghat2_n (i, j) proj2_n[j])
//
// ghat_n are the normalized Gaussian weights of edge_gauss.cuh (the 1e-20
// denominator clamp included). The dropout bits are kernel C's, bit for
// bit: word 0 of Philox4x32-10 keyed by the image's int32 seed and counted
// by the element's row-major index in the image's (K, n*d1) h1, kept when
// >= rate * 2^32 and then scaled by 1/(1-rate).
//
// proj1 and proj2 stay f32 between the projection and the aggregation,
// as the TPU kernel's f32 scratch keeps them (the unmerged path rounds
// proj to the compute dtype first). The wrapper keeps both for the
// backward (graph_block_bwd.cu), which then recomputes neither.
//
// What bounds it on an H100: operations. At B=64 (B*K = 2304 rows, F1 =
// 2052, n*d1 = 2048, n*d2 = 1024) the two projections are ~29 GFLOP
// (0.030 ms at the bf16 tensor-core peak) against ~44 MB of inputs and
// outputs (0.013 ms at 3.35 TB/s); the aggregations add ~0.5 GFLOP.
//
// Design, five launches:
// (1) the edge pass, once per image: edge_gauss.cuh's body evaluates
//     each edge's n Gaussians once for both convolutions (exact
//     arithmetic in f32, one expf each in bf16) and stores ghat1, den1,
//     ghat2, den2;
// (2) in the same launch, the selection, a warp per adjacency row: the
//     pairwise rank gives the mask, and its softmax alpha;
// (3) proj1: with bf16 operands that meet TMA's rules (row strides that
//     are multiples of 8 elements, rows on 16 bytes; wgmma_gemm::fits) the
//     wgmma + TMA product of wgmma_gemm.cuh, feats read by its row stride
//     ldf (the model hands over a 2052-wide view of rows padded to 2056);
//     f32 operands take tile_gemm.cuh's exact SIMT product, the parity
//     path, and bf16 operands that do not fit its wmma product;
// (4) conv1: one block per (Gaussian kernel, image) forms the K x K
//     weights sel * ghat_n once from the stored planes and walks its d1
//     columns in chunks of 64, staging proj1 as f32 by cp.async one chunk
//     ahead; each thread sums a ceil(K/16) x 4 register tile over j in
//     order with f32 FMAs (kernel C's SIMT order, in both dtypes), reading
//     4 j of weights at once, with the relu + dropout epilogue;
// (5) proj2 from h1 as (3); (6) conv2 as (4) with the 0/1 mask.
// The rank, the softmax and each edge's n Gaussians are computed once
// per image, not again in each of the image's n product blocks. The f32
// scratch costs 4 * B*K * n*(d1 + d2) bytes written and read once more
// (~57 MB of traffic at B=64); fusing the aggregation into the product's
// epilogue is later work. The aggregation blocks are bound by issue: at
// B=64 conv1's 4.7 M Philox words (28 multiplies each) and the two
// convolutions' 0.26 G FMAs with their shared-memory reads.
//
// The bare product of tile_gemm.cuh is exported as tile_gemm_run, and
// wgmma_gemm.cuh's as wgmma_gemm_run, for timing and tests.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_gauss.cuh"
#include "mma_sync.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using edge_gauss::philox_bits;
using tile_gemm::store;

constexpr int kMaxK = 64;        // nodes per image
constexpr int kEdgeThreads = edge_gauss::kThreads;
constexpr int kConvThreads = 256;
constexpr int kCT = 64;                       // output columns a block
constexpr int kCG = kCT / 4;                  // column groups of 4
constexpr int kRG = kConvThreads / kCG;       // row groups

// (2) the selection of adjacency row i of image b, by one warp, each lane
// two entries j: the rank of (i, j) = the entries of row i above it and
// the equal ones at a lower index (the row's entries passed round the
// warp by shuffles); the m of rank < m are selected. alpha = exp(adj -
// rowmax) * mask / sum over the row's selected entries.
__device__ __forceinline__ void select_row(const float* __restrict__ adj,
                                           float* __restrict__ alpha,
                                           float* __restrict__ mask, int b,
                                           int i, int K, int m) {
  constexpr int kPer = kMaxK / 32;  // entries a lane
  const int lane = threadIdx.x % 32;
  const size_t at = (static_cast<size_t>(b) * K + i) * K;
  float v[kPer];
  int rank[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int j = lane + 32 * t;
    v[t] = j < K ? adj[at + j] : 0.f;
    rank[t] = 0;
  }
  for (int q = 0; q < K; ++q) {
    const float u = __shfl_sync(0xffffffffu, q < 32 ? v[0] : v[1], q % 32);
#pragma unroll
    for (int t = 0; t < kPer; ++t)
      rank[t] += (u > v[t]) || (u == v[t] && q < lane + 32 * t);
  }
  bool sel[kPer];
  float mx = -1e30f;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    sel[t] = lane + 32 * t < K && rank[t] < m;
    if (sel[t]) mx = fmaxf(mx, v[t]);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float ex[kPer];
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    ex[t] = sel[t] ? expf(v[t] - mx) : 0.f;
    sum += ex[t];
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int j = lane + 32 * t;
    if (j < K) {
      mask[at + j] = sel[t] ? 1.f : 0.f;
      alpha[at + j] = ex[t] / sum;
    }
  }
}

// (1) and (2) in one launch: in gridDim.z 0, a warp per adjacency row
// selects the neighbourhood (rows 8 x .. 8 x + 7 of image y); in z = 1
// and 2 edge_gauss.cuh's body evaluates the Gaussians of conv1's and
// conv2's parameters. The selection's blocks are dispatched first and
// run beside the Gaussians'.
template <bool kExact>
__global__ void __launch_bounds__(kEdgeThreads)
block_edge_kernel(edge_gauss::Args ga, const float* __restrict__ adj,
                  float* __restrict__ alpha, float* __restrict__ mask, int K,
                  int m) {
  __shared__ __align__(16) float gp_s[4 * edge_gauss::kMaxKernels];
  __shared__ float w_s[edge_gauss::kMaxKernels][kEdgeThreads];
  if (blockIdx.z == 0) {
    const int i = blockIdx.x * (kEdgeThreads / 32) + threadIdx.x / 32;
    if (i < K) select_row(adj, alpha, mask, blockIdx.y, i, K, m);
  } else {
    edge_gauss::edge_gauss_block<kExact>(ga, blockIdx.z - 1, gp_s, w_s);
  }
}

struct ConvArgs {
  const float* sel;    // (B, K, K): alpha (conv1) or the 0/1 mask (conv2)
  const float* ghat;   // (B, n, K, K)
  const float* proj;   // (B*K, n*d) f32
  const int* seeds;    // conv1 with dropout, else null
  void* out;           // (B*K, n*d) in the compute dtype
  int K, n_kernels, d;
  uint32_t threshold;  // keep when bits >= threshold
  float inv_keep;      // 1 / (1 - rate)
};

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                      const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// (4) and (6): one block per (Gaussian kernel, image) walks its d
// columns in chunks of kCT, the next chunk's cp.async in flight while it
// computes this one; the weights are built once. RT = ceil(K / kRG) rows
// a thread, 4 columns. The weights' rows lie kw = ceil(K / 4) * 4 floats
// apart, so that a thread reads 4 of its row's j at once: per 4 j a warp
// reads 4 proj rows and RT weight vectors.
template <typename T, int RT>
__global__ void __launch_bounds__(kConvThreads)
block_conv_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int K = a.K, kk = K * K, kw = (K + 3) / 4 * 4, d = a.d;
  const int nd = a.n_kernels * d;
  float* w_s = smem;                   // (K, kw) sel * ghat_n
  float* p_s = smem + K * kw;          // 2 x (K, kCT) proj chunks, f32
  const int kern = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const bool vec = nd % 4 == 0 && d % 4 == 0;
  const float* proj_b = a.proj + static_cast<size_t>(b) * K * nd + kern * d;
  const int chunks = (d + kCT - 1) / kCT;

  // chunk c into buffer c % 2: by cp.async (columns past d zero-filled)
  // where the rows allow 16-byte pieces, else by plain loads
  const auto stage = [&](int c) {
    float* dst = p_s + (c % 2) * K * kCT;
    const int c0 = c * kCT;
    if (vec) {
      for (int idx = tid; idx < K * kCG; idx += kConvThreads) {
        const int j = idx / kCG, q = idx % kCG * 4, col = c0 + q;
        const bool valid = col < d;
        mma_sync::cp_async_16(
            dst + j * kCT + q,
            valid ? proj_b + static_cast<size_t>(j) * nd + col : proj_b,
            valid);
      }
      mma_sync::cp_async_commit();
    } else {
      for (int idx = tid; idx < K * kCT; idx += kConvThreads) {
        const int j = idx / kCT, col = c0 + idx % kCT;
        dst[idx] = col < d ? proj_b[static_cast<size_t>(j) * nd + col] : 0.f;
      }
    }
  };
  stage(0);
  const float* sel_b = a.sel + static_cast<size_t>(b) * kk;
  const float* gh_b =
      a.ghat + (static_cast<size_t>(b) * a.n_kernels + kern) * kk;
  for (int e = tid; e < kk; e += kConvThreads)
    w_s[e / K * kw + e % K] = sel_b[e] * gh_b[e];

  const int cg = tid % kCG, rg = tid / kCG;
  const float* wr[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) wr[r] = w_s + min(rg + kRG * r, K - 1) * kw;
  const uint32_t seed = a.seeds ? static_cast<uint32_t>(a.seeds[b]) : 0u;
  T* out_b = static_cast<T*>(a.out) + static_cast<size_t>(b) * K * nd +
             kern * d;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      // buffer (c + 1) % 2 was last read in step c - 1, before the barrier
      // that ended it
      stage(c + 1);
      if (vec) mma_sync::cp_async_wait<1>();
    } else if (vec) {
      mma_sync::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and, at c = 0, the weights) in place

    // out[i][col] = sum over j = 0, 1, .. K-1 of w[i][j] * p[j][col], one
    // f32 FMA chain per output from 0 (kernel C's SIMT order)
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    const float* pc = p_s + (c % 2) * K * kCT + 4 * cg;
    int j = 0;
    for (; j + 4 <= K; j += 4) {
      float4 p[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        p[t] = *reinterpret_cast<const float4*>(pc + (j + t) * kCT);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 w4 = *reinterpret_cast<const float4*>(wr[r] + j);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[r][0] = fmaf(w[t], p[t].x, acc[r][0]);
          acc[r][1] = fmaf(w[t], p[t].y, acc[r][1]);
          acc[r][2] = fmaf(w[t], p[t].z, acc[r][2]);
          acc[r][3] = fmaf(w[t], p[t].w, acc[r][3]);
        }
      }
    }
    for (; j < K; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pc + j * kCT);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float w = wr[r][j];
        acc[r][0] = fmaf(w, p.x, acc[r][0]);
        acc[r][1] = fmaf(w, p.y, acc[r][1]);
        acc[r][2] = fmaf(w, p.z, acc[r][2]);
        acc[r][3] = fmaf(w, p.w, acc[r][3]);
      }
    }
    __syncthreads();  // every read of buffer c % 2 is done

    const int col0 = c * kCT + 4 * cg;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int i = rg + kRG * r;
      if (i >= K || col0 >= d) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float x = acc[r][q];
        if (x < 0.f) x = 0.f;  // relu; keeps NaN, as torch.relu does
        if (a.seeds) {
          const uint32_t e =
              static_cast<uint32_t>(i * nd + kern * d + col0 + q);
          x = philox_bits(seed, e) >= a.threshold ? x * a.inv_keep : 0.f;
        }
        v[q] = x;
      }
      T* p = out_b + static_cast<size_t>(i) * nd + col0;
      if (vec) {  // col0 < d and d % 4 == 0: all four columns lie inside
        store4(p, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col0 + q < d) store(p + q, v[q]);
      }
    }
  }
}

template <typename T, int RT>
cudaError_t launch_conv_rt(const ConvArgs& a, int B, cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(2 * a.K * kCT + a.K * ((a.K + 3) / 4 * 4)) *
      sizeof(float);
  const dim3 grid(a.n_kernels, B);
  block_conv_kernel<T, RT><<<grid, kConvThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv(const ConvArgs& a, int B, cudaStream_t s) {
  switch ((a.K + kRG - 1) / kRG) {
    case 1:
      return launch_conv_rt<T, 1>(a, B, s);
    case 2:
      return launch_conv_rt<T, 2>(a, B, s);
    case 3:
      return launch_conv_rt<T, 3>(a, B, s);
    default:
      return launch_conv_rt<T, 4>(a, B, s);
  }
}

// C (M, N) f32 = A (M, K), row stride lda, @ B (K, N), row stride N: on
// wgmma where the operands are bf16 and fit it (wgmma_gemm::fits), else
// tile_gemm's product
template <typename T>
cudaError_t project(const T* A, int lda, const T* B, float* C, int M, int N,
                    int K, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (wgmma_gemm::fits(A, lda, B, N))
      return wgmma_gemm::gemm<wgmma_gemm::kNN>(
          A, lda, B, N,
          wgmma_gemm::Epilogue{wgmma_gemm::kStoreF32, C, N, nullptr, 1.f}, M,
          N, K, 0, 0, s);
  return tile_gemm::gemm<T>(
      tile_gemm::kNN, A, B, M, N, K, lda, N,
      tile_gemm::Epilogue<T>{tile_gemm::kStoreF32, C, N, nullptr, 1.f}, s);
}

template <typename T>
cudaError_t run(const void* adj, const void* pseudo, const void* feats,
                const void* w1cat, const void* w2cat, const void* gp1,
                const void* gp2, const void* seeds, void* proj1, void* proj2,
                void* h1, void* out, void* alpha, void* mask, void* ghat1,
                void* ghat2, void* den1, void* den2, int B, int K, int F1,
                int ldf, int n, int d1, int d2, int m, uint32_t threshold,
                float inv_keep, cudaStream_t s) {
  const int rows = B * K, nd1 = n * d1, nd2 = n * d2;
  const edge_gauss::Args ga{
      static_cast<const float*>(pseudo),
      {{static_cast<const float*>(gp1), static_cast<float*>(ghat1),
        static_cast<float*>(den1)},
       {static_cast<const float*>(gp2), static_cast<float*>(ghat2),
        static_cast<float*>(den2)}},
      K * K, n};
  // f32: the exact arithmetic, so that conv1 equals kernel C's SIMT
  // output bit for bit; bf16: the one-expf form of C's mma body
  const int rows_x = (K + kEdgeThreads / 32 - 1) / (kEdgeThreads / 32);
  const int edges_x = (K * K + kEdgeThreads - 1) / kEdgeThreads;
  const dim3 grid(rows_x > edges_x ? rows_x : edges_x, B, 3);
  const auto* a_in = static_cast<const float*>(adj);
  auto* al = static_cast<float*>(alpha);
  auto* mk = static_cast<float*>(mask);
  if (std::is_same<T, float>::value)
    block_edge_kernel<true><<<grid, kEdgeThreads, 0, s>>>(ga, a_in, al, mk, K,
                                                          m);
  else
    block_edge_kernel<false><<<grid, kEdgeThreads, 0, s>>>(ga, a_in, al, mk,
                                                           K, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = project<T>(static_cast<const T*>(feats), ldf,
                 static_cast<const T*>(w1cat), static_cast<float*>(proj1),
                 rows, nd1, F1, s);
  if (e != cudaSuccess) return e;
  e = launch_conv<T>(
      ConvArgs{static_cast<const float*>(alpha),
               static_cast<const float*>(ghat1),
               static_cast<const float*>(proj1),
               static_cast<const int*>(seeds), h1, K, n, d1, threshold,
               inv_keep},
      B, s);
  if (e != cudaSuccess) return e;
  e = project<T>(static_cast<const T*>(h1), nd1,
                 static_cast<const T*>(w2cat), static_cast<float*>(proj2),
                 rows, nd2, nd1, s);
  if (e != cudaSuccess) return e;
  return launch_conv<T>(
      ConvArgs{static_cast<const float*>(mask),
               static_cast<const float*>(ghat2),
               static_cast<const float*>(proj2), nullptr, out, K, n, d2, 0u,
               1.f},
      B, s);
}

}  // namespace

// Kernel H. dtype 0 = float32, 1 = bfloat16 for feats (B*K rows of F1,
// row stride ldf), w1cat (F1, n*d1), w2cat (n*d1, n*d2), h1 (B, K, n*d1)
// and out (B, K, n*d2); everything else float32: adj, alpha, mask, den1,
// den2 (B, K, K); pseudo (B, K, K, 2); gp1, gp2 (4, n); ghat1, ghat2 (B,
// n, K, K); the projections proj1 (B*K, n*d1) and proj2 (B*K, n*d2),
// which the backward reads. seeds (B,) int32 or null (no dropout). Each
// projection runs on wgmma where its operands fit (bf16,
// wgmma_gemm::fits), else on tile_gemm.cuh. Needs K <= 64, n <= 32, d2
// <= d1. Five launches.
// Returns cudaError_t.
extern "C" int graph_block_fwd(const void* adj, const void* pseudo,
                               const void* feats, const void* w1cat,
                               const void* w2cat, const void* gp1,
                               const void* gp2, const void* seeds,
                               void* proj1, void* proj2, void* h1, void* out,
                               void* alpha, void* mask, void* ghat1,
                               void* ghat2, void* den1, void* den2, int B,
                               int K, int F1, int ldf, int n, int d1, int d2,
                               int m, unsigned int threshold, float inv_keep,
                               int dtype, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxK || F1 <= 0 || ldf < F1 || n <= 0 ||
      n > edge_gauss::kMaxKernels || d1 <= 0 || d2 <= 0 || d2 > d1 ||
      m <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = run<float>(adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds, proj1,
                   proj2, h1, out, alpha, mask, ghat1, ghat2, den1, den2, B,
                   K, F1, ldf, n, d1, d2, m, threshold, inv_keep, s);
  else if (dtype == 1)
    e = run<__nv_bfloat16>(adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds,
                           proj1, proj2, h1, out, alpha, mask, ghat1, ghat2,
                           den1, den2, B, K, F1, ldf, n, d1, d2, m, threshold,
                           inv_keep, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The bare wgmma product of wgmma_gemm.cuh: C (M, N), row stride ldc, =
// op(A) op(B), bf16, row strides lda and ldb (multiples of 8); layout 0 =
// NN, 1 = NT, 2 = TN and epilogue 0 = store f32, 1 = store bf16, 2 = f32
// gated by `gate` (bf16, row stride ldc) as tile_gemm_run's; the tile bm
// x bn one of 128 x 128, 128 x 256, 192 x 192, or 0 x 0 for the rule
// kernels H and I use. One launch. Returns cudaError_t.
extern "C" int wgmma_gemm_run(const void* A, const void* B, void* C,
                              const void* gate, int M, int N, int K, int lda,
                              int ldb, int ldc, int layout, int epilogue,
                              float scale, int bm, int bn, void* stream) {
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* b = static_cast<const __nv_bfloat16*>(B);
  const wgmma_gemm::Epilogue ep{epilogue, C, ldc,
                                static_cast<const __nv_bfloat16*>(gate),
                                scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (layout == wgmma_gemm::kNN)
    e = wgmma_gemm::gemm<wgmma_gemm::kNN>(a, lda, b, ldb, ep, M, N, K, bm,
                                          bn, s);
  else if (layout == wgmma_gemm::kNT)
    e = wgmma_gemm::gemm<wgmma_gemm::kNT>(a, lda, b, ldb, ep, M, N, K, bm,
                                          bn, s);
  else if (layout == wgmma_gemm::kTN)
    e = wgmma_gemm::gemm<wgmma_gemm::kTN>(a, lda, b, ldb, ep, M, N, K, bm,
                                          bn, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The bare product C = op(A) op(B) of tile_gemm.cuh: layout 0 = NN, 1 =
// NT, 2 = TN; dtype 0 = float32 (SIMT), 1 = bfloat16 (tensor cores) for
// A and B; epilogue 0 = store f32, 1 = store A's dtype, 2 = f32 gated by
// `gate` (A's dtype, row stride ldc): gate > 0 ? acc * scale : 0. One
// launch. Returns cudaError_t.
extern "C" int tile_gemm_run(const void* A, const void* B, void* C,
                             const void* gate, int M, int N, int K, int lda,
                             int ldb, int ldc, int layout, int dtype,
                             int epilogue, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue < 0 || epilogue > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0)
    e = tile_gemm::gemm<float>(
        layout, static_cast<const float*>(A), static_cast<const float*>(B), M,
        N, K, lda, ldb,
        tile_gemm::Epilogue<float>{epilogue, C, ldc,
                                   static_cast<const float*>(gate), scale},
        s);
  else if (dtype == 1)
    e = tile_gemm::gemm<__nv_bfloat16>(
        layout, static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), M, N, K, lda, ldb,
        tile_gemm::Epilogue<__nv_bfloat16>{
            epilogue, C, ldc, static_cast<const __nv_bfloat16*>(gate), scale},
        s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
