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
// bf16 proj and out for conv1), and one Philox word per output element
// costs 28 32-bit multiplies as compiled, which at Hopper's 64 a clock
// per SM take ~3/4 of the bytes' time.
//
// Two bodies, picked by the wrapper (ops/edge_aggregate.py::
// aggregate_kernel):
//
// - mma (bf16, K <= 64, d a multiple of 8), two launches. First one
//   thread per (image, edge) evaluates the edge's n Gaussians once (one
//   expf each; edge_gauss.cuh, shared with kernel H) and stores ghat,
//   C's residual or A's scratch. Then one
//   block per (column tile, Gaussian kernel, image), the tile all of d up
//   to 256 columns: its ghat plane, sel and proj slab arrive by cp.async
//   as f32 and bf16, K padded with zeros to a multiple of 16, and the
//   product runs on mma.sync.m16n8k16 with f32 sums; w = sel * ghat is
//   split into hi = bf16(w) and lo = bf16(w - hi), out = hi P + lo P,
//   which keeps w to ~2^-16 of its f32 value (one pass would round it to
//   bf16, 2^-8). relu and dropout act on the accumulators, which are
//   stored as bf16 pairs. (The Gaussians are evaluated once per image
//   and edge, not inside each of an image's n product blocks, which
//   would evaluate them n times.)
// - simt (everything else, f32 above all: exact f32 sums): a grid of
//   (ceil(d / kTile), n, B) blocks. Each block builds kernel n's K x K
//   weights in shared memory (all n Gaussians per edge, since the
//   normalization runs across kernels), stages a K x kTile column tile of
//   proj as f32 in shared memory, and accumulates each output in f32 in
//   a register.
//
// In both, proj is read once and out written once, and the (B, K, K, n)
// edge-weight tensor sel * ghat never exists in device memory. In the
// SIMT body of C only the blocks of the first column tile store their
// ghat plane, and of those only kernel 0's stores denom, so each
// residual is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_gauss.cuh"
#include "mma_sync.cuh"

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

using edge_gauss::philox_bits;

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

// ---- the bf16 tensor-core body (kernels A and C) ----

constexpr int kMmaThreads = 256;     // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxColTile = 256;     // columns of d a block owns at most

// Shared memory of the mma body: ghat-weight planes hi and lo, each
// (KP, KP + 8) bf16, the proj slab (KP, ctp + 8) bf16, where ctp is the
// column tile rounded up to 16 (the 8 extra bf16 a row put every ldmatrix
// row of 16 bytes on its own banks), and the image's pseudo (K, K, 2)
// and sel (K, K) f32.
size_t mma_smem_bytes(int kp, int ct, int K) {
  const int ctp = (ct + 15) / 16 * 16;
  return static_cast<size_t>(2 * kp * (kp + 8) + kp * (ctp + 8)) *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * K * K) * sizeof(float);
}

// 4 bytes global -> shared (cp.async.ca: that size goes through L1)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(mma_sync::smem_u32(dst)), "l"(src)
               : "memory");
}

// The mma body's first launch is edge_gauss.cuh's edge_gauss_kernel
// (kExact = false): each edge's n Gaussians once, as ghat (and denom).

// The mma body's second launch: one block per (column tile, Gaussian
// kernel, image); KP = 16 * MT rows and the same inner depth (K padded
// with zeros). The block's ghat plane and sel arrive by cp.async, then
// its proj slab; w = sel * ghat is split into hi = bf16(w) and lo =
// bf16(w - hi) (so that hi + lo carries w to ~2^-16) while the slab
// lands, and then each warp takes 16 x 16 output tiles: out = hi P + lo P
// on mma.sync.m16n8k16 with f32 sums, relu and dropout on the
// accumulators, bf16 pairs stored.
template <int MT, bool kTrain>
__global__ void __launch_bounds__(kMmaThreads, 4)
edge_aggregate_fwd_mma_kernel(const float* __restrict__ sel,
                              const float* __restrict__ ghat,
                              const __nv_bfloat16* __restrict__ proj,
                              __nv_bfloat16* __restrict__ out, int K,
                              int n_kernels, int d, int ct, int relu,
                              TrainArgs train) {
  using namespace mma_sync;
  constexpr int KP = 16 * MT;
  constexpr int kWLd = KP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w_lo = w_hi + KP * kWLd;
  __nv_bfloat16* p_s = w_lo + KP * kWLd;

  const int ctp = (ct + 15) / 16 * 16, p_ld = ctp + 8;
  const int c0 = blockIdx.x * ct, kern = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nd = n_kernels * d, kk = K * K;
  float* gh_s = reinterpret_cast<float*>(p_s + KP * p_ld);  // (K, K)
  float* sel_s = gh_s + kk;                                   // (K, K)

  // every load is issued before any is waited for: the ghat plane and
  // sel first (one group; 16-byte pieces where K^2 is a multiple of 4,
  // so that every plane starts on 16 bytes), then the proj slab (a
  // second group)
  const float* gh_b = ghat + (static_cast<size_t>(b) * n_kernels + kern) * kk;
  const float* sel_b = sel + static_cast<size_t>(b) * kk;
  if (kk % 4 == 0) {
    for (int e = 4 * tid; e < kk; e += 4 * kMmaThreads) {
      cp_async_16(gh_s + e, gh_b + e, true);
      cp_async_16(sel_s + e, sel_b + e, true);
    }
  } else {
    for (int e = tid; e < kk; e += kMmaThreads) {
      cp_async_4(gh_s + e, gh_b + e);
      cp_async_4(sel_s + e, sel_b + e);
    }
  }
  cp_async_commit();

  // the slab: rows past K and columns past the tile or d are zero-filled
  // (stale shared memory may hold NaN, and 0 * NaN is NaN)
  const __nv_bfloat16* proj_b =
      proj + static_cast<size_t>(b) * K * nd + kern * d;
  const int pieces = ctp / 8;
  for (int idx = tid; idx < KP * pieces; idx += kMmaThreads) {
    const int j = idx / pieces, c = (idx % pieces) * 8, col = c0 + c;
    const bool valid = j < K && c < ct && col < d;
    cp_async_16(p_s + j * p_ld + c,
                valid ? proj_b + static_cast<size_t>(j) * nd + col : proj_b,
                valid);
  }
  cp_async_commit();
  const uint32_t seed =
      (kTrain && train.seeds) ? static_cast<uint32_t>(train.seeds[b]) : 0u;

  cp_async_wait<1>();  // ghat and sel have landed; proj may not have
  __syncthreads();
  for (int e = tid; e < KP * KP; e += kMmaThreads) {
    const int i = e / KP, j = e % KP;
    const float w = i < K && j < K ? sel_s[i * K + j] * gh_s[i * K + j] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(w);
    w_hi[i * kWLd + j] = hi;
    w_lo[i * kWLd + j] = __float2bfloat16_rn(w - __bfloat162float(hi));
  }
  cp_async_wait<0>();
  __syncthreads();

  __nv_bfloat16* out_b = out + static_cast<size_t>(b) * K * nd + kern * d;
  // each warp takes (16-row tile, 16-column group) units in turn: few
  // accumulators a thread, so that more blocks share an SM
  for (int u = warp; u < MT * (ctp / 16); u += kMmaWarps) {
    const int mt = u % MT, grp = u / MT;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kt = 0; kt < MT; ++kt) {
      uint32_t bf[4], af[4];
      ldsm_x4_trans(bf, p_s + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  p_ld + grp * 16 + (lane >> 4) * 8);
      const int a_at = (mt * 16 + (lane & 15)) * kWLd + kt * 16 +
                       (lane >> 4) * 8;
      ldsm_x4(af, w_hi + a_at);
      mma_bf16(acc[0], af, bf[0], bf[1]);
      mma_bf16(acc[1], af, bf[2], bf[3]);
      ldsm_x4(af, w_lo + a_at);
      mma_bf16(acc[0], af, bf[0], bf[1]);
      mma_bf16(acc[1], af, bf[2], bf[3]);
    }
    // accumulator h: rows mt*16 + lane/4 (+8 for q = 2, 3), columns
    // grp*16 + h*8 + 2*(lane%4) (+1 for odd q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = mt * 16 + (lane >> 2) + r * 8;
        const int c = grp * 16 + h * 8 + (lane & 3) * 2, col = c0 + c;
        if (i >= K || c >= ct || col >= d) continue;
        float v[2] = {acc[h][2 * r], acc[h][2 * r + 1]};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (relu && v[q] < 0.f) v[q] = 0.f;  // keeps NaN, as torch.relu
          if (kTrain && train.seeds) {
            const uint32_t e =
                static_cast<uint32_t>(i * nd + kern * d + col + q);
            v[q] = philox_bits(seed, e) >= train.threshold
                       ? v[q] * train.inv_keep
                       : 0.f;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out_b + static_cast<size_t>(i) * nd + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
  }
}

template <int MT, bool kTrain>
cudaError_t launch_mma(const void* sel, const float* ghat, const void* proj,
                       void* out, int B, int K, int n_kernels, int d,
                       int relu, int ct, TrainArgs train,
                       cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(16 * MT, ct, K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edge_aggregate_fwd_mma_kernel<MT, kTrain>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((d + ct - 1) / ct, n_kernels, B);
  edge_aggregate_fwd_mma_kernel<MT, kTrain>
      <<<grid, kMmaThreads, smem, stream>>>(
          static_cast<const float*>(sel), ghat,
          static_cast<const __nv_bfloat16*>(proj),
          static_cast<__nv_bfloat16*>(out), K, n_kernels, d, ct, relu, train);
  return cudaGetLastError();
}

// The Gaussians into ghat (and denom, where non-null), then the product.
// The column tile: all of d up to 256 columns.
template <bool kTrain>
cudaError_t dispatch_mma(const void* sel, const void* pseudo,
                         const void* proj, const void* gparams, void* out,
                         float* ghat, float* denom, int B, int K,
                         int n_kernels, int d, int relu, TrainArgs train,
                         cudaStream_t s) {
  const edge_gauss::Args ga{
      static_cast<const float*>(pseudo),
      {{static_cast<const float*>(gparams), ghat, denom}, {}}, K * K,
      n_kernels};
  const cudaError_t e = edge_gauss::launch<false>(ga, B, 1, s);
  if (e != cudaSuccess) return e;
  const int ct = d < kMaxColTile ? d : kMaxColTile;
  switch ((K + 15) / 16) {
    case 1:
      return launch_mma<1, kTrain>(sel, ghat, proj, out, B, K, n_kernels, d,
                                   relu, ct, train, s);
    case 2:
      return launch_mma<2, kTrain>(sel, ghat, proj, out, B, K, n_kernels, d,
                                   relu, ct, train, s);
    case 3:
      return launch_mma<3, kTrain>(sel, ghat, proj, out, B, K, n_kernels, d,
                                   relu, ct, train, s);
    default:
      return launch_mma<4, kTrain>(sel, ghat, proj, out, B, K, n_kernels, d,
                                   relu, ct, train, s);
  }
}

// body: 0 = the SIMT body (any dtype and shape), 1 = the bf16 mma body
// (bfloat16, K <= 64, d a multiple of 8; proj, sel and ghat 16-byte and
// pseudo 8-byte aligned), whose Gaussians go to ghat (kernel C's residual, or kernel
// A's scratch).
template <bool kTrain>
int dispatch(const void* sel, const void* pseudo, const void* proj,
             const void* gparams, void* out, float* ghat, int B, int K,
             int n_kernels, int d, int relu, int dtype, int body,
             TrainArgs train, void* stream) {
  if (B <= 0 || K <= 0 || d <= 0 || n_kernels <= 0 ||
      n_kernels > kMaxKernels || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (body == 1) {
    if (dtype != 1 || K > 64 || d % 8 || !ghat ||
        reinterpret_cast<uintptr_t>(proj) % 16 ||
        reinterpret_cast<uintptr_t>(ghat) % 16 ||
        reinterpret_cast<uintptr_t>(sel) % 16 ||
        reinterpret_cast<uintptr_t>(pseudo) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    e = dispatch_mma<kTrain>(sel, pseudo, proj, gparams, out, ghat,
                             kTrain ? train.denom : nullptr, B, K, n_kernels,
                             d, relu, train, s);
  } else if (body != 0) {
    e = cudaErrorInvalidValue;
  } else if (dtype == 0) {
    e = launch<float, kTrain>(sel, pseudo, proj, gparams, out, B, K,
                              n_kernels, d, relu, train, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16, kTrain>(sel, pseudo, proj, gparams, out, B, K,
                                      n_kernels, d, relu, train, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace

// Kernel A. dtype: 0 = float32 proj/out, 1 = bfloat16 proj/out; body: 0 =
// SIMT, 1 = bf16 mma, which needs ghat, a (B, n, K, K) f32 scratch (null
// for SIMT). Returns cudaError_t.
extern "C" int edge_aggregate_fwd(const void* sel, const void* pseudo,
                                  const void* proj, const void* gparams,
                                  void* out, void* ghat, int B, int K,
                                  int n_kernels, int d, int relu, int dtype,
                                  int body, void* stream) {
  return dispatch<false>(sel, pseudo, proj, gparams, out,
                         static_cast<float*>(ghat), B, K, n_kernels, d, relu,
                         dtype, body, TrainArgs{}, stream);
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
                                      int dtype, int body, void* stream) {
  TrainArgs train{static_cast<float*>(ghat), static_cast<float*>(denom),
                  static_cast<const int*>(seeds), threshold, inv_keep};
  if (!ghat || !denom) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(sel, pseudo, proj, gparams, out, train.ghat, B, K,
                        n_kernels, d, relu || seeds != nullptr, dtype, body,
                        train, stream);
}
