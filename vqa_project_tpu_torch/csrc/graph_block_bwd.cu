// The merged graph block's backward (kernel I), for Hopper (sm_90a).
//
// Replaces the TPU kernel vqa_project_tpu/ops/pallas/graph_block.py
// ::_block_bwd_kernel (the VJP of fused_graph_block): the per-image
// aggregation backward (_agg_bwd_one, the terms of edge_aggregate_bwd.cu)
// twice, joined by the projections' products. With the cotangent g of out
// (f32) and kernel H's residuals (graph_block.cu), in order:
//
//   g2          = g * (out > 0)                          conv2's relu
//   dp2, G2_n   = (mask * ghat2_n)^T g2_n,  g2_n proj2_n^T   per image
//   dpseudo, dgp2 from G2 (conv2's 0/1 mask takes no gradient)
//   dW2cat      = h1^T dp2                  (n*d1, n*d2), over B*K rows
//   g1          = (dp2 W2cat^T) * (h1 > 0) / (1 - rate)   conv1's relu
//                 and dropout: h1 > 0 iff the unit was kept and positive
//   dp1, G1_n   = (alpha * ghat1_n)^T g1_n,  g1_n proj1_n^T
//   dadj        = alpha * (dsel - sum_j dsel * alpha),  dsel = sum_n G1_n
//                 * ghat1_n (the softmax's VJP; the rank selection is
//                 piecewise constant)
//   dpseudo    += conv1's terms, dgp1 from G1
//   dW1cat      = feats^T dp1               (F1, n*d1)
//   dfeats      = dp1 W1cat^T               only when asked for
//
// In bf16, dp1 and dp2 are rounded to bf16 once and every product takes
// bf16 operands on the tensor cores with f32 sums (the port's matmul
// contract, ops/matmul.py); in f32 every product is exact f32. proj1 and
// proj2 are kernel H's f32 scratch, kept by the wrapper: nothing is
// recomputed (the TPU kernel recomputes both, ~29 GFLOP at B=64, to save
// device memory; here they cost 28 MB held across the step at B=64).
//
// What bounds it on an H100: operations. At B=64 the four products dW2,
// dh1, dW1 and dfeats are ~58 GFLOP (0.059 ms at the bf16 peak; without
// dfeats, which the model never asks for, ~39 GFLOP, 0.039 ms) against
// ~80 MB of inputs and outputs.
//
// Design, up to eight launches: per conv, (1) a grid of (n, B) blocks,
// each owning one image's kernel n (kernel D's products: its d columns in
// 64-wide chunks staged in shared memory as f32, dp_n written per chunk,
// G_n's K^2 sums in registers, stored to a (B, n, K, K) scratch), then
// (2) one block per image for the per-edge chain over all n kernels
// (dsel, dadj with the row sums of the softmax VJP, dpseudo, and the
// image's dgp partials reduced in a fixed order); the products of
// tile_gemm.cuh between them (TN for the weight gradients, NT with the
// relu/dropout gate as its epilogue for g1). The (B, 4, n) partials are
// summed by the caller, so a run is repeatable: no atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_gemm.cuh"

namespace {

using tile_gemm::store;
using tile_gemm::to_f32;

constexpr int kThreads = 256;
constexpr int kChunk = 64;            // columns of g / proj per pass
constexpr int kLd = kChunk + 1;       // padded shared-memory row
constexpr int kMaxG = 16;             // K^2 <= kMaxG * kThreads: K <= 64
constexpr int kMaxKernels = 32;
constexpr int kWarps = kThreads / 32;

// jnp.sign: 0 at 0 (copysignf would give +-1)
__device__ __forceinline__ float sign0(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

size_t dot_smem_bytes(int K) {
  return static_cast<size_t>(K * K + 2 * K * kLd) * sizeof(float);
}

size_t edge_smem_bytes(int K) {
  return static_cast<size_t>(4 * K * K) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_bwd_dot_kernel(const float* __restrict__ g,      // (B*K, nd) f32
                     const T* __restrict__ gate,       // (B*K, nd) or null
                     const float* __restrict__ sel,    // (B, K, K)
                     const float* __restrict__ ghat,   // (B, n, K, K)
                     const float* __restrict__ proj,   // (B*K, nd) f32
                     float* __restrict__ ge,           // (B, n, K, K)
                     T* __restrict__ dproj,            // (B*K, nd)
                     int K, int n_kernels, int d) {
  extern __shared__ float smem[];
  float* w_s = smem;                 // (K, K) sel * ghat_n
  float* g_s = smem + K * K;         // (K, kLd) cotangent chunk
  float* p_s = g_s + K * kLd;        // (K, kLd) proj chunk

  const int kern = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nd = n_kernels * d, kk = K * K;
  const size_t plane = (static_cast<size_t>(b) * n_kernels + kern) * kk;
  const size_t slab = static_cast<size_t>(b) * K * nd + kern * d;

  for (int e = tid; e < kk; e += kThreads)
    w_s[e] = sel[static_cast<size_t>(b) * kk + e] * ghat[plane + e];

  float acc[kMaxG];
#pragma unroll
  for (int q = 0; q < kMaxG; ++q) acc[q] = 0.f;

  for (int c0 = 0; c0 < d; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done (and w_s set)
    for (int idx = tid; idx < K * kChunk; idx += kThreads) {
      const int i = idx / kChunk, c = idx % kChunk, col = c0 + c;
      float gv = 0.f, pv = 0.f;
      if (col < d) {
        const size_t at = slab + static_cast<size_t>(i) * nd + col;
        gv = g[at];
        if (gate) gv = to_f32(gate[at]) > 0.f ? gv : 0.f;
        pv = proj[at];
      }
      g_s[i * kLd + c] = gv;
      p_s[i * kLd + c] = pv;
    }
    __syncthreads();

    // this thread's entries of G_n: e = tid + q * kThreads
#pragma unroll
    for (int q = 0; q < kMaxG; ++q) {
      const int e = tid + q * kThreads;
      if (e < kk) {
        const float* gr = g_s + (e / K) * kLd;
        const float* pr = p_s + (e % K) * kLd;
        float s = 0.f;
        for (int c = 0; c < kChunk; ++c) s = fmaf(gr[c], pr[c], s);
        acc[q] += s;
      }
    }

    // dp_n[j, c] = sum_i w[i, j] g[i, c], rounded once to T
    for (int idx = tid; idx < K * kChunk; idx += kThreads) {
      const int j = idx / kChunk, c = idx % kChunk, col = c0 + c;
      if (col >= d) continue;
      float s = 0.f;
      for (int i = 0; i < K; ++i) s = fmaf(w_s[i * K + j], g_s[i * kLd + c], s);
      store(dproj + slab + static_cast<size_t>(j) * nd + col, s);
    }
  }

#pragma unroll
  for (int q = 0; q < kMaxG; ++q) {
    const int e = tid + q * kThreads;
    if (e < kk) ge[plane + e] = acc[q];
  }
}

// One block per image: the per-edge chain across all n kernels. With
// kAlpha (conv1), also dadj through the softmax; `accumulate` adds the
// pseudo gradient to what conv2's pass stored.
template <bool kAlpha>
__global__ void __launch_bounds__(kThreads)
block_bwd_edge_kernel(const float* __restrict__ ge,      // (B, n, K, K)
                      const float* __restrict__ sel,     // (B, K, K)
                      const float* __restrict__ ghat,    // (B, n, K, K)
                      const float* __restrict__ denom,   // (B, K, K)
                      const float* __restrict__ pseudo,  // (B, K, K, 2)
                      const float* __restrict__ gparams, // (4, n)
                      float* __restrict__ dadj,          // (B, K, K)
                      float* __restrict__ dpseudo,       // (B, K, K, 2)
                      float* __restrict__ dgp_part,      // (B, 4, n)
                      int K, int n_kernels, int accumulate) {
  extern __shared__ float smem[];
  const int kk = K * K;
  float* scross_s = smem;          // sum_m G_m * sel * ghat_m
  float* dsel_s = smem + kk;       // sum_m G_m * ghat_m
  float* drho_s = smem + 2 * kk;
  float* dth_s = smem + 3 * kk;
  __shared__ float gp_s[4 * kMaxKernels];
  __shared__ float red_s[kWarps][4];
  __shared__ float row_s[64];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, nk = n_kernels;
  const size_t img = static_cast<size_t>(b) * kk;
  const size_t planes = static_cast<size_t>(b) * nk * kk;
  const float two_pi = 6.283185307179586f;

  for (int i = tid; i < 4 * nk; i += kThreads) gp_s[i] = gparams[i];
  for (int e = tid; e < kk; e += kThreads) {
    const float s = sel[img + e];
    float ds = 0.f, sc = 0.f;
    for (int q = 0; q < nk; ++q) {
      const float gm = ge[planes + static_cast<size_t>(q) * kk + e];
      const float hm = ghat[planes + static_cast<size_t>(q) * kk + e];
      ds += gm * hm;
      // rounded as the plain version rounds them (no fused multiply-add),
      // so that gm * sel - scross is exactly 0 where ghat is 1 (n = 1):
      // their true difference, which inv_r would otherwise amplify
      sc = __fadd_rn(sc, __fmul_rn(__fmul_rn(gm, s), hm));
    }
    dsel_s[e] = ds;
    scross_s[e] = sc;
    drho_s[e] = 0.f;
    dth_s[e] = 0.f;
  }
  __syncthreads();

  float* part = dgp_part + static_cast<size_t>(b) * 4 * nk;
  for (int q = 0; q < nk; ++q) {
    const float mu_r = gp_s[q], mu_t = gp_s[nk + q];
    const float pr = gp_s[2 * nk + q], pt = gp_s[3 * nk + q];
    const float inv_r = 1.f / (1e-14f + pr * pr);
    const float inv_t = 1.f / (1e-14f + pt * pt);
    float t[4] = {0.f, 0.f, 0.f, 0.f};  // dmu_r, dmu_t, dprec_r, dprec_t
    for (int e = tid; e < kk; e += kThreads) {
      const size_t at = img + e;
      const float gm = ge[planes + static_cast<size_t>(q) * kk + e];
      const float hm = ghat[planes + static_cast<size_t>(q) * kk + e];
      const float den = denom[at];
      const float ind = den > 1e-20f ? 1.f : 0.f;
      const float dw =
          __fsub_rn(__fmul_rn(gm, sel[at]), __fmul_rn(ind, scross_s[e])) /
          den;
      const float dwn_wn = dw * (hm * den);
      const float rho = pseudo[2 * at], theta = pseudo[2 * at + 1];

      const float x_r = rho - mu_r;
      drho_s[e] += dwn_wn * (-x_r * inv_r);
      t[0] += dwn_wn * x_r * inv_r;
      t[2] += dwn_wn * (x_r * x_r) * pr * inv_r * inv_r;

      const float first = fabsf(theta - mu_t);
      const float second = fabsf(two_pi - first);
      const float dist = first <= second ? first : second;
      const float dd = first <= second ? 1.f : -sign0(two_pi - first);
      const float common = dwn_wn * (-dist * inv_t) * dd * sign0(theta - mu_t);
      dth_s[e] += common;
      t[1] -= common;
      t[3] += dwn_wn * (dist * dist) * pt * inv_t * inv_t;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t[r] += __shfl_down_sync(0xffffffffu, t[r], off);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) red_s[warp][r] = t[r];
    __syncthreads();
    if (tid < 4) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red_s[w][tid];
      part[tid * nk + q] = s;
    }
    __syncthreads();
  }

  if (kAlpha) {
    for (int i = tid; i < K; i += kThreads) {
      float s = 0.f;
      for (int j = 0; j < K; ++j) s += dsel_s[i * K + j] * sel[img + i * K + j];
      row_s[i] = s;
    }
    __syncthreads();
  }
  for (int e = tid; e < kk; e += kThreads) {
    const size_t at = img + e;
    if (kAlpha) dadj[at] = sel[at] * (dsel_s[e] - row_s[e / K]);
    const float pr_ = accumulate ? dpseudo[2 * at] : 0.f;
    const float pt_ = accumulate ? dpseudo[2 * at + 1] : 0.f;
    dpseudo[2 * at] = pr_ + drho_s[e];
    dpseudo[2 * at + 1] = pt_ + dth_s[e];
  }
}

template <typename T>
cudaError_t conv_bwd(const float* g, const T* gate, const float* sel,
                     const float* ghat, const float* denom,
                     const float* pseudo, const float* gparams,
                     const float* proj, float* ge, T* dproj, float* dadj,
                     float* dpseudo, float* dgp_part, int B, int K, int n,
                     int d, bool alpha, cudaStream_t s) {
  const size_t smem = dot_smem_bytes(K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_bwd_dot_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  block_bwd_dot_kernel<T><<<dim3(n, B), kThreads, smem, s>>>(
      g, gate, sel, ghat, proj, ge, dproj, K, n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t esmem = edge_smem_bytes(K);
  if (alpha) {
    if (esmem > 48 * 1024) {
      e = cudaFuncSetAttribute(block_bwd_edge_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(esmem));
      if (e != cudaSuccess) return e;
    }
    block_bwd_edge_kernel<true><<<B, kThreads, esmem, s>>>(
        ge, sel, ghat, denom, pseudo, gparams, dadj, dpseudo, dgp_part, K, n,
        1);
  } else {
    if (esmem > 48 * 1024) {
      e = cudaFuncSetAttribute(block_bwd_edge_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(esmem));
      if (e != cudaSuccess) return e;
    }
    block_bwd_edge_kernel<false><<<B, kThreads, esmem, s>>>(
        ge, sel, ghat, denom, pseudo, gparams, nullptr, dpseudo, dgp_part, K,
        n, 0);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const float* g, const T* out, const T* h1, const T* feats,
                const T* w1cat, const T* w2cat, const float* proj1,
                const float* proj2, const float* alpha, const float* mask,
                const float* ghat1, const float* ghat2, const float* den1,
                const float* den2, const float* pseudo, const float* gp1,
                const float* gp2, float* ge, T* dp2, float* g1, T* dp1,
                float* dadj, float* dpseudo, T* dfeats, float* dw1cat,
                float* dw2cat, float* dgp1_part, float* dgp2_part, int B,
                int K, int F1, int ldf, int n, int d1, int d2,
                float inv_keep, cudaStream_t s) {
  using tile_gemm::Epilogue;
  const int rows = B * K, nd1 = n * d1, nd2 = n * d2;
  cudaError_t e = conv_bwd<T>(g, out, mask, ghat2, den2, pseudo, gp2, proj2,
                              ge, dp2, nullptr, dpseudo, dgp2_part, B, K, n,
                              d2, false, s);
  if (e != cudaSuccess) return e;
  e = tile_gemm::gemm<T>(
      tile_gemm::kTN, h1, dp2, nd1, nd2, rows, nd1, nd2,
      Epilogue<T>{tile_gemm::kStoreF32, dw2cat, nd2, nullptr, 1.f}, s);
  if (e != cudaSuccess) return e;
  e = tile_gemm::gemm<T>(
      tile_gemm::kNT, dp2, w2cat, rows, nd1, nd2, nd2, nd2,
      Epilogue<T>{tile_gemm::kGateF32, g1, nd1, h1, inv_keep}, s);
  if (e != cudaSuccess) return e;
  e = conv_bwd<T>(g1, nullptr, alpha, ghat1, den1, pseudo, gp1, proj1, ge,
                  dp1, dadj, dpseudo, dgp1_part, B, K, n, d1, true, s);
  if (e != cudaSuccess) return e;
  e = tile_gemm::gemm<T>(
      tile_gemm::kTN, feats, dp1, F1, nd1, rows, ldf, nd1,
      Epilogue<T>{tile_gemm::kStoreF32, dw1cat, nd1, nullptr, 1.f}, s);
  if (e != cudaSuccess || !dfeats) return e;
  return tile_gemm::gemm<T>(
      tile_gemm::kNT, dp1, w1cat, rows, F1, nd1, nd1, nd1,
      Epilogue<T>{tile_gemm::kStoreT, dfeats, F1, nullptr, 1.f}, s);
}

}  // namespace

// Kernel I. dtype 0 = float32, 1 = bfloat16 for out (B, K, n*d2), h1
// (B, K, n*d1), feats (B*K rows of F1, row stride ldf, as kernel H reads
// it), w1cat (F1, n*d1), w2cat (n*d1, n*d2),
// the scratch dp2 (B*K, n*d2) and dp1 (B*K, n*d1), and dfeats (B, K, F1;
// null skips it); float32: g (B, K, n*d2), kernel H's proj1, proj2,
// alpha, mask, ghat1, ghat2, den1, den2, pseudo and dpseudo (B, K, K, 2),
// gp1, gp2 (4, n), the scratch ge (B, n, K, K) and g1 (B*K, n*d1), dadj
// (B, K, K), dw1cat (F1, n*d1), dw2cat (n*d1, n*d2), and the partials
// dgp1_part, dgp2_part (B, 4, n). Needs K <= 64, n <= 32. Up to eight
// launches. Returns cudaError_t.
extern "C" int graph_block_bwd(
    const void* g, const void* out, const void* h1, const void* feats,
    const void* w1cat, const void* w2cat, const void* proj1,
    const void* proj2, const void* alpha, const void* mask,
    const void* ghat1, const void* ghat2, const void* den1, const void* den2,
    const void* pseudo, const void* gp1, const void* gp2, void* ge, void* dp2,
    void* g1, void* dp1, void* dadj, void* dpseudo, void* dfeats,
    void* dw1cat, void* dw2cat, void* dgp1_part, void* dgp2_part, int B,
    int K, int F1, int ldf, int n, int d1, int d2, float inv_keep, int dtype,
    void* stream) {
  if (B <= 0 || K <= 0 || K * K > kMaxG * kThreads || F1 <= 0 || ldf < F1 ||
      n <= 0 ||
      n > kMaxKernels || d1 <= 0 || d2 <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  cudaError_t e;
  if (dtype == 0) {
    using T = float;
    e = run<T>(f(g), f(out), f(h1), f(feats), f(w1cat), f(w2cat), f(proj1),
               f(proj2), f(alpha), f(mask), f(ghat1), f(ghat2), f(den1),
               f(den2), f(pseudo), f(gp1), f(gp2), w(ge), w(dp2), w(g1),
               w(dp1), w(dadj), w(dpseudo), w(dfeats), w(dw1cat), w(dw2cat),
               w(dgp1_part), w(dgp2_part), B, K, F1, ldf, n, d1, d2, inv_keep,
               s);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    const auto c = [](const void* p) { return static_cast<const T*>(p); };
    const auto m = [](void* p) { return static_cast<T*>(p); };
    e = run<T>(f(g), c(out), c(h1), c(feats), c(w1cat), c(w2cat), f(proj1),
               f(proj2), f(alpha), f(mask), f(ghat1), f(ghat2), f(den1),
               f(den2), f(pseudo), f(gp1), f(gp2), w(ge), m(dp2), w(g1),
               m(dp1), w(dadj), w(dpseudo), m(dfeats), w(dw1cat), w(dw2cat),
               w(dgp1_part), w(dgp2_part), B, K, F1, ldf, n, d1, d2, inv_keep,
               s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
