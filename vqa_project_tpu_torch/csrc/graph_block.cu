// The merged graph block's forward (kernel H), for Hopper (sm_90a):
//
//   out = relu(conv2(mask, dropout(relu(conv1(alpha, feats @ W1))) @ W2))
//
// Replaces the TPU kernel vqa_project_tpu/ops/pallas/graph_block.py
// ::_block_fwd_kernel (entry fused_graph_block). With n Gaussian kernels,
// W1cat (F1, n*d1) and W2cat (n*d1, n*d2) hold the per-kernel projections
// side by side (column block n*d:(n+1)*d is kernel n), and per image:
//
//   proj1 = feats @ W1cat                   f32, bf16 operands on the
//                                           tensor cores (tile_gemm.cuh)
//   mask  = the m largest entries of each adjacency row, ties to the
//           lowest index (a pairwise rank, as _select_both); alpha = the
//           softmax of the adjacency over them
//   h1    = relu(sum_j alpha * ghat1_n (i, j) proj1_n[j]), then inverted
//           dropout, stored in the compute dtype
//   proj2 = h1 @ W2cat                      f32
//   out   = relu(sum_j mask * ghat2_n (i, j) proj2_n[j])
//
// ghat_n are the normalized Gaussian weights of edge_aggregate.cu (the
// 1e-20 denominator clamp included). The dropout bits are kernel C's,
// bit for bit: word 0 of Philox4x32-10 keyed by the image's int32 seed
// and counted by the element's row-major index in the image's (K, n*d1)
// h1, kept when >= rate * 2^32 and then scaled by 1/(1-rate).
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
// Design, four launches: (1) the NN product proj1; (2) conv1, a grid of
// (n, B) blocks: each block ranks its image's K x K adjacency (K^3
// comparisons, cheap beside the products), builds kernel n's edge weights
// alpha * ghat1_n in shared memory, then walks its d1 columns in 64-wide
// chunks of proj1 staged as f32, with the relu + dropout epilogue; the
// kernel-0 block stores alpha, mask and den1, each block its ghat1 plane;
// (3) the NN product proj2 from h1; (4) conv2 the same way with the 0/1
// mask. The f32 scratch costs 4 * B*K * n*(d1 + d2) bytes written and
// read once more (~57 MB of traffic at B=64). Fusing the aggregation into
// the product's epilogue (a block owning an image's K rows x one kernel's
// d columns) is the later redesign.
//
// The bare product is exported as tile_gemm for timing and tests.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace {

using tile_gemm::store;

constexpr int kThreads = 256;
constexpr int kChunk = 64;       // output columns per pass
constexpr int kMaxKernels = 32;  // Gaussian kernels (n) a launch accepts
constexpr int kMaxK = 64;        // nodes per image

// Word 0 of Philox4x32-10 with key (seed, 0) and counter (e, 0, 0, 0).
__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t e) {
  uint32_t c0 = e, c1 = 0u, c2 = 0u, c3 = 0u, k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

struct AggArgs {
  const float* sel_in;   // conv1: the adjacency; conv2: the 0/1 mask
  const float* pseudo;   // (B, K, K, 2)
  const float* proj;     // (B*K, n*d) f32
  const float* gparams;  // (4, n)
  const int* seeds;      // conv1 with dropout, else null
  void* out;             // (B*K, n*d) in the compute dtype
  float* alpha;          // conv1: (B, K, K) out
  float* mask;           // conv1: (B, K, K) out
  float* ghat;           // (B, n, K, K) out
  float* denom;          // (B, K, K) out
  int K, n_kernels, d, m;
  uint32_t threshold;    // keep when bits >= threshold
  float inv_keep;        // 1 / (1 - rate)
};

size_t agg_smem_bytes(int K, bool conv1) {
  return static_cast<size_t>((conv1 ? 3 : 1) * K * K + K * kChunk) *
         sizeof(float);
}

// One block per (Gaussian kernel, image): the edge weights of kernel n,
// then its d output columns. conv1 selects the neighbourhood itself.
template <typename T, bool kConv1>
__global__ void __launch_bounds__(kThreads) block_agg_kernel(AggArgs a) {
  extern __shared__ float smem[];
  const int K = a.K, kk = K * K, nk = a.n_kernels, d = a.d, nd = nk * d;
  float* w_s = smem;                                // (K, K) sel * ghat_n
  float* p_s = smem + (kConv1 ? 3 : 1) * kk;        // (K, kChunk) proj
  float* adj_s = smem + kk;                         // conv1: adj, then alpha
  float* msk_s = smem + 2 * kk;                     // conv1: 0/1 mask
  __shared__ float gp_s[4 * kMaxKernels];

  const int kern = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t img = static_cast<size_t>(b) * kk;
  for (int i = tid; i < 4 * nk; i += kThreads) gp_s[i] = a.gparams[i];

  if (kConv1) {
    for (int e = tid; e < kk; e += kThreads) adj_s[e] = a.sel_in[img + e];
    __syncthreads();
    // rank of (i, j) in row i: the entries above it, and the equal ones
    // at a lower index; the m of rank < m are selected
    for (int e = tid; e < kk; e += kThreads) {
      const int i = e / K, j = e % K;
      const float v = adj_s[e];
      const float* row = adj_s + i * K;
      int rank = 0;
      for (int q = 0; q < K; ++q) {
        const float u = row[q];
        rank += (u > v) || (u == v && q < j);
      }
      msk_s[e] = rank < a.m ? 1.f : 0.f;
    }
    __syncthreads();
    // alpha: softmax of the adjacency over the selected entries, as
    // exp(where(mask, adj, -1e30) - rowmax) * mask / sum
    for (int i = tid; i < K; i += kThreads) {
      float* row = adj_s + i * K;
      const float* mrow = msk_s + i * K;
      float mx = -1e30f;
      for (int j = 0; j < K; ++j)
        if (mrow[j] > 0.f) mx = fmaxf(mx, row[j]);
      float sum = 0.f;
      for (int j = 0; j < K; ++j) {
        const float ex = mrow[j] > 0.f ? expf(row[j] - mx) : 0.f;
        row[j] = ex;
        sum += ex;
      }
      for (int j = 0; j < K; ++j) row[j] /= sum;
    }
  }
  __syncthreads();

  const float* ps_b = a.pseudo + img * 2;
  const float two_pi = 6.283185307179586f;
  for (int e = tid; e < kk; e += kThreads) {
    const float rho = ps_b[2 * e], theta = ps_b[2 * e + 1];
    float denom = 0.f, mine = 0.f;
    for (int q = 0; q < nk; ++q) {
      const float mu_r = gp_s[q], mu_t = gp_s[nk + q];
      const float pr = gp_s[2 * nk + q], pt = gp_s[3 * nk + q];
      const float xr = rho - mu_r;
      const float w_r = expf(-0.5f * (xr * xr) / (1e-14f + pr * pr));
      const float first = fabsf(theta - mu_t);
      const float second = fabsf(two_pi - first);
      const float dt = first < second ? first : second;
      const float w_t = expf(-0.5f * (dt * dt) / (1e-14f + pt * pt));
      float w = w_r * w_t;
      if (isnan(w)) w = 0.f;
      denom += w;
      if (q == kern) mine = w;
    }
    denom = fmaxf(denom, 1e-20f);
    const float ghat = mine / denom;
    const float s = kConv1 ? adj_s[e] : a.sel_in[img + e];
    w_s[e] = s * ghat;
    a.ghat[(static_cast<size_t>(b) * nk + kern) * kk + e] = ghat;
    if (kern == 0) {
      a.denom[img + e] = denom;
      if (kConv1) {
        a.alpha[img + e] = s;
        a.mask[img + e] = msk_s[e];
      }
    }
  }

  const uint32_t seed =
      (kConv1 && a.seeds) ? static_cast<uint32_t>(a.seeds[b]) : 0u;
  const float* proj_b = a.proj + static_cast<size_t>(b) * K * nd + kern * d;
  T* out_b = static_cast<T*>(a.out) + static_cast<size_t>(b) * K * nd +
             kern * d;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    __syncthreads();  // w_s is built; the previous chunk's readers are done
    for (int idx = tid; idx < K * kChunk; idx += kThreads) {
      const int j = idx / kChunk, col = c0 + idx % kChunk;
      p_s[idx] = col < d ? proj_b[static_cast<size_t>(j) * nd + col] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < K * kChunk; idx += kThreads) {
      const int i = idx / kChunk, c = idx % kChunk, col = c0 + c;
      if (col >= d) continue;
      const float* w_row = w_s + i * K;
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc = fmaf(w_row[j], p_s[j * kChunk + c], acc);
      if (acc < 0.f) acc = 0.f;  // relu; keeps NaN, as torch.relu does
      if (kConv1 && a.seeds) {
        const uint32_t e = static_cast<uint32_t>(i * nd + kern * d + col);
        acc = philox_bits(seed, e) >= a.threshold ? acc * a.inv_keep : 0.f;
      }
      store(out_b + static_cast<size_t>(i) * nd + col, acc);
    }
  }
}

template <typename T, bool kConv1>
cudaError_t launch_agg(const AggArgs& a, int B, cudaStream_t s) {
  const size_t smem = agg_smem_bytes(a.K, kConv1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_agg_kernel<T, kConv1>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  block_agg_kernel<T, kConv1><<<dim3(a.n_kernels, B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* adj, const void* pseudo, const void* feats,
                const void* w1cat, const void* w2cat, const void* gp1,
                const void* gp2, const void* seeds, void* proj1, void* proj2,
                void* h1, void* out, void* alpha, void* mask, void* ghat1,
                void* ghat2, void* den1, void* den2, int B, int K, int F1,
                int n, int d1, int d2, int m, uint32_t threshold,
                float inv_keep, cudaStream_t s) {
  using tile_gemm::Epilogue;
  const int rows = B * K, nd1 = n * d1, nd2 = n * d2;
  cudaError_t e = tile_gemm::gemm<T>(
      tile_gemm::kNN, static_cast<const T*>(feats),
      static_cast<const T*>(w1cat), rows, nd1, F1, F1, nd1,
      Epilogue<T>{tile_gemm::kStoreF32, proj1, nd1, nullptr, 1.f}, s);
  if (e != cudaSuccess) return e;
  AggArgs a{static_cast<const float*>(adj), static_cast<const float*>(pseudo),
            static_cast<const float*>(proj1), static_cast<const float*>(gp1),
            static_cast<const int*>(seeds), h1, static_cast<float*>(alpha),
            static_cast<float*>(mask), static_cast<float*>(ghat1),
            static_cast<float*>(den1), K, n, d1, m, threshold, inv_keep};
  e = launch_agg<T, true>(a, B, s);
  if (e != cudaSuccess) return e;
  e = tile_gemm::gemm<T>(
      tile_gemm::kNN, static_cast<const T*>(h1), static_cast<const T*>(w2cat),
      rows, nd2, nd1, nd1, nd2,
      Epilogue<T>{tile_gemm::kStoreF32, proj2, nd2, nullptr, 1.f}, s);
  if (e != cudaSuccess) return e;
  AggArgs c{static_cast<const float*>(mask), static_cast<const float*>(pseudo),
            static_cast<const float*>(proj2), static_cast<const float*>(gp2),
            nullptr, out, nullptr, nullptr, static_cast<float*>(ghat2),
            static_cast<float*>(den2), K, n, d2, m, 0u, 1.f};
  return launch_agg<T, false>(c, B, s);
}

}  // namespace

// Kernel H. dtype 0 = float32, 1 = bfloat16 for feats, w1cat (F1, n*d1),
// w2cat (n*d1, n*d2), h1 (B, K, n*d1) and out (B, K, n*d2); everything
// else float32: adj, alpha, mask, den1, den2 (B, K, K); pseudo (B, K, K,
// 2); gp1, gp2 (4, n); ghat1, ghat2 (B, n, K, K); the projections proj1
// (B*K, n*d1) and proj2 (B*K, n*d2), which the backward reads. seeds
// (B,) int32 or null (no dropout). Needs K <= 64, n <= 32, d2 <= d1.
// Four launches. Returns cudaError_t.
extern "C" int graph_block_fwd(const void* adj, const void* pseudo,
                               const void* feats, const void* w1cat,
                               const void* w2cat, const void* gp1,
                               const void* gp2, const void* seeds,
                               void* proj1, void* proj2, void* h1, void* out,
                               void* alpha, void* mask, void* ghat1,
                               void* ghat2, void* den1, void* den2, int B,
                               int K, int F1, int n, int d1, int d2, int m,
                               unsigned int threshold, float inv_keep,
                               int dtype, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxK || F1 <= 0 || n <= 0 ||
      n > kMaxKernels || d1 <= 0 || d2 <= 0 || d2 > d1 || m <= 0 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = run<float>(adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds, proj1,
                   proj2, h1, out, alpha, mask, ghat1, ghat2, den1, den2, B,
                   K, F1, n, d1, d2, m, threshold, inv_keep, s);
  else if (dtype == 1)
    e = run<__nv_bfloat16>(adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds,
                           proj1, proj2, h1, out, alpha, mask, ghat1, ghat2,
                           den1, den2, B, K, F1, n, d1, d2, m, threshold,
                           inv_keep, s);
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
