// Fused Gaussian-weight neighbourhood aggregation with its activation
// epilogue, for Hopper (sm_90a): the inference forward (kernel A) and the
// training forward that also saves residuals (kernel C).
//
// Replaces the TPU kernels vqa_project_tpu/ops/pallas/edge_aggregate.py
// ::_kernel (A) and ::_kernel_res (C), entry fused_sel_aggregate_act. For
// every image b, Gaussian kernel n and node i:
//
//   w_n(i,j)  = sel(i,j) * ghat_n(i,j),  ghat_n = g_n / denom,
//   denom     = max(sum_m g_m(i,j), 1e-20)
//   g_m(i,j)  = exp(-0.5 (rho-mu_r)^2 / (1e-14 + pr^2))
//             * exp(-0.5 dtheta^2 / (1e-14 + pt^2)),  NaN -> 0,
//     dtheta  = min(|theta - mu_t|, |2 pi - |theta - mu_t||)
//   out[b, i, n*d + c] = act( sum_j w_n(i,j) * proj[b, j, n*d + c] )
//
// act is relu and, in training, inverted dropout after it (C only): an
// element is kept when 32 random bits are >= rate * 2^32, and then scaled
// by 1/(1-rate). The bits are word 0 of Philox4x32-10 keyed by the
// image's int32 seed and counted by the element's row-major index within
// the image's (K, n*d) output, so a mask depends on the image and the
// position only, never on how the batch is cut into blocks or launches.
// (The TPU kernel draws from the TPU's own PRNG, which no other device
// reproduces; ops/dropout.py::philox_keep computes these same bits in
// torch.) C also stores ghat (B, n, K, K) and denom (B, K, K) for the
// backward (csrc/edge_aggregate_bwd.cu, kernel D).
//
// What bounds it on an H100: bytes. Per image it reads a (K, n*d) proj
// slab and writes one of the same size; the K x K x n Gaussian weights
// and the K x K x d product are a few hundred flops per byte moved at
// most, far below the card's ~300 flop/byte ridge. C's residuals add
// (n+1) K^2 floats per image (47 KB at the VQA widths, beside 295 KB of
// bf16 proj and out for conv1), and its 10 Philox rounds are ~40 integer
// operations per output element.
//
// Design: a grid of (ceil(d / kTile), n, B) blocks. Each block builds
// kernel n's K x K weights in shared memory (all n Gaussians per edge,
// since the normalization runs across kernels), stages a K x kTile
// column tile of proj as f32 in shared memory, and accumulates each
// output in f32 in a register. Nothing but the output (and C's
// residuals) leaves the chip, so the (B, K, K, n) edge-weight tensor
// never exists in device memory; proj is read once and out written once,
// both with neighbouring threads on neighbouring columns. In C only the
// blocks with blockIdx.x == 0 store their ghat plane, and of those only
// kernel 0's stores denom, so each residual is written once. K=36 needs
// 5 KB of weights and K=51 10 KB. wgmma/TMA versions are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // output columns per block
constexpr int kMaxKernels = 32;  // Gaussian kernels (n) a launch accepts

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

// Training-only arguments of kernel C (unused by A).
struct TrainArgs {
  float* ghat;          // (B, n, K, K) out
  float* denom;         // (B, K, K) out
  const int* seeds;     // (B,) per-image dropout seeds, or null
  uint32_t threshold;   // keep when bits >= threshold
  float inv_keep;       // 1 / (1 - rate)
};

template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads)
edge_aggregate_fwd_kernel(const float* __restrict__ sel,     // (B, K, K)
                          const float* __restrict__ pseudo,  // (B, K, K, 2)
                          const T* __restrict__ proj,        // (B, K, n*d)
                          const float* __restrict__ gparams, // (4, n)
                          T* __restrict__ out,               // (B, K, n*d)
                          int K, int n_kernels, int d, int relu,
                          TrainArgs train) {
  extern __shared__ float smem[];
  float* w_s = smem;           // (K, K) weights of this block's kernel
  float* p_s = smem + K * K;   // (K, kTile) proj column tile, f32
  __shared__ float gp_s[4 * kMaxKernels];

  const int c0 = blockIdx.x * kTile;
  const int kern = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nd = n_kernels * d;
  const size_t kk = static_cast<size_t>(K) * K;

  for (int i = tid; i < 4 * n_kernels; i += kThreads) gp_s[i] = gparams[i];

  // stage the proj tile while the weights are being built
  const T* proj_b = proj + static_cast<size_t>(b) * K * nd + kern * d;
  for (int idx = tid; idx < K * kTile; idx += kThreads) {
    const int j = idx / kTile, col = c0 + idx % kTile;
    p_s[idx] = col < d ? to_f32(proj_b[static_cast<size_t>(j) * nd + col])
                       : 0.f;
  }
  __syncthreads();

  const float* sel_b = sel + b * kk;
  const float* ps_b = pseudo + b * kk * 2;
  const float two_pi = 6.283185307179586f;
  for (int e = tid; e < K * K; e += kThreads) {
    const float rho = ps_b[2 * e], theta = ps_b[2 * e + 1];
    float denom = 0.f, mine = 0.f;
    for (int m = 0; m < n_kernels; ++m) {
      const float mu_r = gp_s[m], mu_t = gp_s[n_kernels + m];
      const float pr = gp_s[2 * n_kernels + m], pt = gp_s[3 * n_kernels + m];
      const float xr = rho - mu_r;
      const float w_r = expf(-0.5f * (xr * xr) / (1e-14f + pr * pr));
      const float first = fabsf(theta - mu_t);
      const float second = fabsf(two_pi - first);
      const float dt = first < second ? first : second;
      const float w_t = expf(-0.5f * (dt * dt) / (1e-14f + pt * pt));
      float w = w_r * w_t;
      if (isnan(w)) w = 0.f;
      denom += w;
      if (m == kern) mine = w;
    }
    const float ghat = mine / fmaxf(denom, 1e-20f);
    w_s[e] = sel_b[e] * ghat;
    if (kTrain && blockIdx.x == 0) {
      train.ghat[(static_cast<size_t>(b) * n_kernels + kern) * kk + e] = ghat;
      if (kern == 0) train.denom[b * kk + e] = fmaxf(denom, 1e-20f);
    }
  }
  __syncthreads();

  const uint32_t seed =
      (kTrain && train.seeds) ? static_cast<uint32_t>(train.seeds[b]) : 0u;
  T* out_b = out + static_cast<size_t>(b) * K * nd + kern * d;
  for (int idx = tid; idx < K * kTile; idx += kThreads) {
    const int i = idx / kTile, c = idx % kTile, col = c0 + c;
    if (col >= d) continue;
    const float* w_row = w_s + i * K;  // one row per warp: a broadcast
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = fmaf(w_row[j], p_s[j * kTile + c], acc);
    if (relu && acc < 0.f) acc = 0.f;  // keeps NaN, as torch.relu does
    if (kTrain && train.seeds) {
      const uint32_t e = static_cast<uint32_t>(i * nd + kern * d + col);
      acc = philox_bits(seed, e) >= train.threshold ? acc * train.inv_keep
                                                     : 0.f;
    }
    store(out_b + static_cast<size_t>(i) * nd + col, acc);
  }
}

template <typename T, bool kTrain>
cudaError_t launch(const void* sel, const void* pseudo, const void* proj,
                   const void* gparams, void* out, int B, int K,
                   int n_kernels, int d, int relu, TrainArgs train,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K * K + K * kTile) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        edge_aggregate_fwd_kernel<T, kTrain>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((d + kTile - 1) / kTile, n_kernels, B);
  edge_aggregate_fwd_kernel<T, kTrain><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(sel), static_cast<const float*>(pseudo),
      static_cast<const T*>(proj), static_cast<const float*>(gparams),
      static_cast<T*>(out), K, n_kernels, d, relu, train);
  return cudaGetLastError();
}

template <bool kTrain>
int dispatch(const void* sel, const void* pseudo, const void* proj,
             const void* gparams, void* out, int B, int K, int n_kernels,
             int d, int relu, int dtype, TrainArgs train, void* stream) {
  if (B <= 0 || K <= 0 || d <= 0 || n_kernels <= 0 ||
      n_kernels > kMaxKernels || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float, kTrain>(sel, pseudo, proj, gparams, out, B, K,
                              n_kernels, d, relu, train, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, kTrain>(sel, pseudo, proj, gparams, out, B, K,
                                      n_kernels, d, relu, train, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

// Kernel A. dtype: 0 = float32 proj/out, 1 = bfloat16 proj/out.
// Returns cudaError_t.
extern "C" int edge_aggregate_fwd(const void* sel, const void* pseudo,
                                  const void* proj, const void* gparams,
                                  void* out, int B, int K, int n_kernels,
                                  int d, int relu, int dtype, void* stream) {
  return dispatch<false>(sel, pseudo, proj, gparams, out, B, K, n_kernels, d,
                         relu, dtype, TrainArgs{}, stream);
}

// Kernel C: kernel A plus the residuals ghat (B, n, K, K) f32 and denom
// (B, K, K) f32, and with seeds non-null the dropout epilogue (relu is
// then implied): keep when bits >= threshold, scale kept by inv_keep.
// Returns cudaError_t.
extern "C" int edge_aggregate_fwd_res(const void* sel, const void* pseudo,
                                      const void* proj, const void* gparams,
                                      const void* seeds, void* out,
                                      void* ghat, void* denom, int B, int K,
                                      int n_kernels, int d, int relu,
                                      unsigned int threshold, float inv_keep,
                                      int dtype, void* stream) {
  TrainArgs train{static_cast<float*>(ghat), static_cast<float*>(denom),
                  static_cast<const int*>(seeds), threshold, inv_keep};
  if (!ghat || !denom) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(sel, pseudo, proj, gparams, out, B, K, n_kernels, d,
                        relu || seeds != nullptr, dtype, train, stream);
}
