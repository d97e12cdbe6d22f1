// Backward of the fused Gaussian-weight aggregation (kernel D), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel vqa_project_tpu/ops/pallas/edge_aggregate.py
// ::_kernel_bwd (entry fused_sel_aggregate_act's VJP), the hand-derived
// VJP of kernel C (csrc/edge_aggregate.cu) from its saved residuals, with
// no forward recompute. With the cotangent g of out, per image and
// Gaussian kernel n (sums over the d columns of kernel n, all in f32):
//
//   g       <- g * (out > 0) / (1 - rate)   when an epilogue ran: out > 0
//              iff the unit was both positive and kept
//   dproj_n = (sel * ghat_n)^T g_n          stored in proj's dtype
//   G_n     = g_n p_n^T                     (K x K)
//   dsel    = sum_n G_n * ghat_n
//   dgw_n   = G_n * sel
//   dw_n    = (dgw_n - ind * sum_m dgw_m * ghat_m) / denom,
//             ind = denom > 1e-20 (quotient rule of the normalization)
//   w_n     = ghat_n * denom                (the unnormalized Gaussian)
//   drho   += dw_n w_n * (-(rho - mu_r) / (1e-14 + pr^2))
//   dtheta += dw_n w_n * (-D / (1e-14 + pt^2)) * dD/dfirst * sign(theta-mu_t)
//   with D = min(first, second), first = |theta - mu_t|,
//   second = |2 pi - first|, dD/dfirst = 1 when first <= second (ties go
//   to the first operand, as jnp.minimum routes them) else
//   -sign(2 pi - first), and sign(0) = 0;
//   dmu_r, dmu_t, dprec_r, dprec_t: per-kernel sums of the same terms.
//
// What bounds it on an H100: bytes. Per image it reads g, proj (and out
// with an epilogue) as (K, n*d) slabs, the (n+1) K^2 residuals, and
// writes dproj; the two K x K x d products per kernel are ~2 K flops per
// slab element (~72 at K=36), well under the card's ridge.
//
// Design: two kernels. (1) A grid of (n, B) blocks: each block owns one
// image's kernel n, walks its d columns in 64-wide chunks staged in
// shared memory as f32 (rows padded to 65 floats so that neither
// product's reads collide on a bank), writes dproj_n for each chunk and
// keeps its share of G_n's K^2 sums in registers, which it then stores to
// a (B, n, K, K) f32 scratch. (2) A grid of (ceil(K^2 / 256), B) blocks,
// one thread per edge: the elementwise chain above across all n kernels
// (dsel, dpseudo), and per-block partial sums of the four gparams
// gradients, reduced in a fixed order (warp shuffles, then the 8 warps in
// turn). The (blocks, 4, n) partials are summed by the caller, so a run
// is repeatable: no atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;            // columns of g / proj per pass
constexpr int kLd = kChunk + 1;       // padded shared-memory row
constexpr int kMaxG = 16;             // K^2 <= kMaxG * kThreads: K <= 64
constexpr int kMaxKernels = 32;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// jnp.sign: 0 at 0 (copysignf would give +-1)
__device__ __forceinline__ float sign0(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

size_t dot_smem_bytes(int K) {
  return static_cast<size_t>(K * K + 2 * K * kLd) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_aggregate_bwd_dot_kernel(const T* __restrict__ g,        // (B, K, nd)
                              const float* __restrict__ sel,  // (B, K, K)
                              const float* __restrict__ ghat, // (B, n, K, K)
                              const T* __restrict__ proj,     // (B, K, nd)
                              const T* __restrict__ out,      // or null
                              float* __restrict__ ge,         // (B, n, K, K)
                              T* __restrict__ dproj,          // (B, K, nd)
                              int K, int n_kernels, int d, float inv_keep) {
  extern __shared__ float smem[];
  float* w_s = smem;                 // (K, K) sel * ghat_n
  float* g_s = smem + K * K;         // (K, kLd) cotangent chunk, f32
  float* p_s = g_s + K * kLd;        // (K, kLd) proj chunk, f32

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
        gv = to_f32(g[at]);
        if (out) gv = to_f32(out[at]) > 0.f ? gv * inv_keep : 0.f;
        pv = to_f32(proj[at]);
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

    // dproj_n[j, c] = sum_i w[i, j] g[i, c], neighbouring threads on
    // neighbouring columns
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

__global__ void __launch_bounds__(kThreads)
edge_aggregate_bwd_edge_kernel(const float* __restrict__ ge,     // (B,n,K,K)
                               const float* __restrict__ sel,    // (B, K, K)
                               const float* __restrict__ ghat,   // (B,n,K,K)
                               const float* __restrict__ denom,  // (B, K, K)
                               const float* __restrict__ pseudo, // (B,K,K,2)
                               const float* __restrict__ gparams,// (4, n)
                               float* __restrict__ dsel,         // (B, K, K)
                               float* __restrict__ dpseudo,      // (B,K,K,2)
                               float* __restrict__ dgp_part,     // (B*T,4,n)
                               int K, int n_kernels) {
  __shared__ float gp_s[4 * kMaxKernels];
  __shared__ float red_s[kWarps][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, kk = K * K;
  const int e = blockIdx.x * kThreads + tid;
  const bool valid = e < kk;
  const size_t at = static_cast<size_t>(b) * kk + e;
  const size_t planes = static_cast<size_t>(b) * n_kernels * kk + e;
  const float two_pi = 6.283185307179586f;

  for (int i = tid; i < 4 * n_kernels; i += kThreads) gp_s[i] = gparams[i];
  __syncthreads();

  float s_sel = 0.f, den = 1.f, rho = 0.f, theta = 0.f, ind = 0.f;
  float s_cross = 0.f;
  if (valid) {
    s_sel = sel[at];
    den = denom[at];
    ind = den > 1e-20f ? 1.f : 0.f;
    rho = pseudo[2 * at];
    theta = pseudo[2 * at + 1];
    float ds = 0.f;
    for (int m = 0; m < n_kernels; ++m) {
      const float gm = ge[planes + static_cast<size_t>(m) * kk];
      const float hm = ghat[planes + static_cast<size_t>(m) * kk];
      ds += gm * hm;
      s_cross += gm * s_sel * hm;
    }
    dsel[at] = ds;
  }

  float drho = 0.f, dth = 0.f;
  float* part = dgp_part + static_cast<size_t>(b * gridDim.x + blockIdx.x) *
                               4 * n_kernels;
  for (int m = 0; m < n_kernels; ++m) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};  // dmu_r, dmu_t, dprec_r, dprec_t
    if (valid) {
      const float gm = ge[planes + static_cast<size_t>(m) * kk];
      const float hm = ghat[planes + static_cast<size_t>(m) * kk];
      const float mu_r = gp_s[m], mu_t = gp_s[n_kernels + m];
      const float pr = gp_s[2 * n_kernels + m], pt = gp_s[3 * n_kernels + m];
      const float inv_r = 1.f / (1e-14f + pr * pr);
      const float inv_t = 1.f / (1e-14f + pt * pt);
      const float dw = (gm * s_sel - ind * s_cross) / den;
      const float dwn_wn = dw * (hm * den);

      const float x_r = rho - mu_r;
      drho += dwn_wn * (-x_r * inv_r);
      t[0] = dwn_wn * x_r * inv_r;
      t[2] = dwn_wn * (x_r * x_r) * pr * inv_r * inv_r;

      const float first = fabsf(theta - mu_t);
      const float second = fabsf(two_pi - first);
      const float dist = first <= second ? first : second;
      const float dd = first <= second ? 1.f : -sign0(two_pi - first);
      const float common = dwn_wn * (-dist * inv_t) * dd * sign0(theta - mu_t);
      dth += common;
      t[1] = -common;
      t[3] = dwn_wn * (dist * dist) * pt * inv_t * inv_t;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t[q] += __shfl_down_sync(0xffffffffu, t[q], off);
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q) red_s[warp][q] = t[q];
    __syncthreads();
    if (tid < 4) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red_s[w][tid];
      part[tid * n_kernels + m] = s;
    }
    __syncthreads();
  }
  if (valid) {
    dpseudo[2 * at] = drho;
    dpseudo[2 * at + 1] = dth;
  }
}

template <typename T>
cudaError_t run(const void* g, const void* sel, const void* ghat,
                const void* denom, const void* pseudo, const void* proj,
                const void* gparams, const void* out, void* ge, void* dsel,
                void* dpseudo, void* dproj, void* dgp_part, int B, int K,
                int n_kernels, int d, float inv_keep, cudaStream_t stream) {
  const size_t smem = dot_smem_bytes(K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edge_aggregate_bwd_dot_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  edge_aggregate_bwd_dot_kernel<T><<<dim3(n_kernels, B), kThreads, smem,
                                     stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(sel),
      static_cast<const float*>(ghat), static_cast<const T*>(proj),
      static_cast<const T*>(out), static_cast<float*>(ge),
      static_cast<T*>(dproj), K, n_kernels, d, inv_keep);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int tiles = (K * K + kThreads - 1) / kThreads;
  edge_aggregate_bwd_edge_kernel<<<dim3(tiles, B), kThreads, 0, stream>>>(
      static_cast<const float*>(ge), static_cast<const float*>(sel),
      static_cast<const float*>(ghat), static_cast<const float*>(denom),
      static_cast<const float*>(pseudo), static_cast<const float*>(gparams),
      static_cast<float*>(dsel), static_cast<float*>(dpseudo),
      static_cast<float*>(dgp_part), K, n_kernels);
  return cudaGetLastError();
}

}  // namespace

// Rows of per-block gparams partials each image contributes.
extern "C" int edge_aggregate_bwd_tiles(int K) {
  return (K * K + kThreads - 1) / kThreads;
}

// g, proj, out (null without an epilogue) and dproj in proj's dtype
// (0 = float32, 1 = bfloat16), everything else float32: sel, denom
// (B, K, K); ghat and the scratch ge (B, n, K, K); pseudo and dpseudo
// (B, K, K, 2); gparams (4, n); dgp_part (B * edge_aggregate_bwd_tiles(K),
// 4, n). Needs K <= 64 and n <= 32. Two launches. Returns cudaError_t.
extern "C" int edge_aggregate_bwd(const void* g, const void* sel,
                                  const void* ghat, const void* denom,
                                  const void* pseudo, const void* proj,
                                  const void* gparams, const void* out,
                                  void* ge, void* dsel, void* dpseudo,
                                  void* dproj, void* dgp_part, int B, int K,
                                  int n_kernels, int d, float inv_keep,
                                  int dtype, void* stream) {
  if (B <= 0 || K <= 0 || d <= 0 || n_kernels <= 0 || B > 65535 ||
      K * K > kMaxG * kThreads || n_kernels > kMaxKernels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = run<float>(g, sel, ghat, denom, pseudo, proj, gparams, out, ge, dsel,
                   dpseudo, dproj, dgp_part, B, K, n_kernels, d, inv_keep, s);
  else if (dtype == 1)
    e = run<__nv_bfloat16>(g, sel, ghat, denom, pseudo, proj, gparams, out,
                           ge, dsel, dpseudo, dproj, dgp_part, B, K,
                           n_kernels, d, inv_keep, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
