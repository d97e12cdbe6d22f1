// Pieces shared by the Gaussian-kernel aggregations of kernels A and C
// (edge_aggregate.cu) and kernel H (graph_block.cu): the Philox bits of
// the fused dropout, and the pass that evaluates every edge's n Gaussians
// once per image.
//
// For an image's edge (i, j) with pseudo-coordinates (rho, theta) and
// Gaussian kernel m with parameters (mu_r, mu_t, pr, pt):
//
//   g_m    = exp(-0.5 (rho-mu_r)^2 / (1e-14 + pr^2))
//          * exp(-0.5 dtheta^2 / (1e-14 + pt^2)),  NaN -> 0,
//   dtheta = min(|theta - mu_t|, |2 pi - |theta - mu_t||)
//   denom  = max(sum_m g_m, 1e-20),  ghat_m = g_m / denom
//
// edge_gauss_kernel stores ghat (B, n, K, K) and denom (B, K, K). It takes
// one or two parameter sets in one launch (gridDim.z; kernel H's two
// convolutions share pseudo), one thread per (image, edge); kernel H runs
// its body (edge_gauss_block) inside a launch that also selects the
// neighbourhood. Two arithmetics:
// - kExact = false (the bf16 mma bodies of A and C, kernel H in bf16):
//   each g_m is one expf of exponent scales computed once a block (-0.5 /
//   (1e-14 + prec^2)), so ghat differs from the exact form at f32
//   rounding;
// - kExact = true (kernel H in f32): the two expf and the divides as
//   written above, the arithmetic of edge_aggregate.cu's SIMT body, so
//   that H's f32 conv1 equals kernel C's f32 output bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace edge_gauss {

constexpr int kThreads = 256;
constexpr int kMaxKernels = 32;  // Gaussian kernels (n) a launch accepts

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

// One parameter set: gparams (4, n) in, ghat (B, n, K, K) and denom (B,
// K, K) out (denom may be null)
struct Planes {
  const float* gparams;
  float* ghat;
  float* denom;
};

struct Args {
  const float* pseudo;  // (B, K, K, 2)
  Planes set[2];        // set[blockIdx.z]
  int kk, n_kernels;
};

// The pass of one block (blockIdx.x: edges kThreads * x ..; y: image)
// for parameter set `set` with its shared memory: gp_s (4 kMaxKernels
// floats, 16-byte aligned) and w_s (kMaxKernels x kThreads floats, each
// thread's g_m)
template <bool kExact>
__device__ __forceinline__ void edge_gauss_block(const Args& a, int set,
                                                 float* gp_s,
                                                 float (*w_s)[kThreads]) {
  const Planes p = set == 0 ? a.set[0] : a.set[1];
  const int tid = threadIdx.x, b = blockIdx.y, kk = a.kk, nk = a.n_kernels;
  const int e = blockIdx.x * kThreads + tid;
  float2 ps = make_float2(0.f, 0.f);
  if (e < kk)  // issued before the barrier below
    ps = reinterpret_cast<const float2*>(a.pseudo)[static_cast<size_t>(b) *
                                                       kk + e];
  for (int m = tid; m < nk; m += kThreads) {
    const float pr = p.gparams[2 * nk + m];
    const float pt = p.gparams[3 * nk + m];
    gp_s[4 * m] = p.gparams[m];
    gp_s[4 * m + 1] = p.gparams[nk + m];
    gp_s[4 * m + 2] = kExact ? pr : -0.5f / (1e-14f + pr * pr);
    gp_s[4 * m + 3] = kExact ? pt : -0.5f / (1e-14f + pt * pt);
  }
  __syncthreads();
  if (e >= kk) return;
  const float two_pi = 6.283185307179586f;
  float denom = 0.f;
  for (int m = 0; m < nk; ++m) {
    const float4 gp = reinterpret_cast<const float4*>(gp_s)[m];
    const float xr = ps.x - gp.x;
    const float first = fabsf(ps.y - gp.y);
    const float second = fabsf(two_pi - first);
    const float dt = first < second ? first : second;
    float w;
    if (kExact) {
      const float pr = gp.z, pt = gp.w;
      const float w_r = expf(-0.5f * (xr * xr) / (1e-14f + pr * pr));
      const float w_t = expf(-0.5f * (dt * dt) / (1e-14f + pt * pt));
      w = w_r * w_t;
    } else {
      // exp(a) exp(b) as exp(a + b): the same 0 where either underflows
      // and the same NaN (then 0) where either is NaN
      w = expf(xr * xr * gp.z + dt * dt * gp.w);
    }
    if (isnan(w)) w = 0.f;
    denom += w;
    w_s[m][tid] = w;
  }
  denom = fmaxf(denom, 1e-20f);
  for (int m = 0; m < nk; ++m)
    p.ghat[(static_cast<size_t>(b) * nk + m) * kk + e] = w_s[m][tid] / denom;
  if (p.denom) p.denom[static_cast<size_t>(b) * kk + e] = denom;
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads) edge_gauss_kernel(Args a) {
  __shared__ __align__(16) float gp_s[4 * kMaxKernels];
  __shared__ float w_s[kMaxKernels][kThreads];
  edge_gauss_block<kExact>(a, blockIdx.z, gp_s, w_s);
}

// `sets` (1 or 2) parameter sets over B images of kk edges each
template <bool kExact>
cudaError_t launch(const Args& a, int B, int sets, cudaStream_t s) {
  edge_gauss_kernel<kExact>
      <<<dim3((a.kk + kThreads - 1) / kThreads, B, sets), kThreads, 0, s>>>(
          a);
  return cudaGetLastError();
}

}  // namespace edge_gauss
