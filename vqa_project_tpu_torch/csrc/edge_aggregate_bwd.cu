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
// Design: two launches. (1) The dot part, a grid of (n, B) blocks: each
// block owns one image's kernel n and walks its d columns in chunks,
// writing dproj_n for each chunk and summing G_n, which it stores to a
// (B, n, K, K) f32 scratch. Two bodies, picked by the wrapper
// (ops/edge_aggregate.py::aggregate_kernel): for bf16 (K <= 64, d a
// multiple of 8) both products run on mma.sync.m16n8k16 from
// double-buffered cp.async chunks of 64 columns, g masked in bf16 and
// 1/(1-rate) applied to the f32 sums, W = sel * ghat_n split into bf16
// hi and lo as in the forward; for the rest (f32 above all) each thread
// computes its entries of G_n and dproj as f32 dot products from chunks
// staged as f32 (rows padded to 65 floats so that neither product's
// reads collide on a bank). (2) The edge part, a grid of
// (ceil(K^2 / 256), B) blocks, one thread per edge: the elementwise
// chain above across all n kernels (dsel, dpseudo), and per-block
// partial sums of the four gparams gradients, reduced in a fixed order
// (warp shuffles per kernel into each warp's own slots, then after one
// barrier the 8 warps in turn). The (blocks, 4, n) partials are summed by
// the caller, so a run is repeatable: no atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

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
  __shared__ float red_s[kWarps][4 * kMaxKernels];  // [warp][q * n + m]
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
      // rounded as the plain version rounds them (no fused multiply-add),
      // so that dgw_n - s_cross is exactly 0 where ghat_n is 1 (n = 1):
      // their true difference, which inv_r would otherwise amplify
      s_cross = __fadd_rn(s_cross, __fmul_rn(__fmul_rn(gm, s_sel), hm));
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
      const float dw =
          __fsub_rn(__fmul_rn(gm, s_sel), __fmul_rn(ind, s_cross)) / den;
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
    if (lane == 0)  // each warp its own slots: no barrier per kernel
#pragma unroll
      for (int q = 0; q < 4; ++q) red_s[warp][q * n_kernels + m] = t[q];
  }
  if (valid) {
    dpseudo[2 * at] = drho;
    dpseudo[2 * at + 1] = dth;
  }
  __syncthreads();
  for (int i = tid; i < 4 * n_kernels; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red_s[w][i];
    part[i] = s;
  }
}

// ---- the bf16 tensor-core dot part ----

constexpr int kMmaWarps = kThreads / 32;
constexpr int kCw = 64;            // columns of d a chunk carries
constexpr int kCLd = kCw + 8;      // its padded row: ldmatrix off banks
constexpr int kStages = 2;         // chunks in the ring (each more
                                   // takes shared memory from the
                                   // blocks an SM holds)

size_t dot_mma_smem_bytes(int kp, bool with_out) {
  const int slabs = with_out ? 3 : 2;  // g, proj (, out)
  return static_cast<size_t>(2 * kp * (kp + 8) +
                             kStages * slabs * kp * kCLd) *
         sizeof(__nv_bfloat16);
}

// One block per (Gaussian kernel, image), KP = 16 * MT (K padded with
// zeros). W_n = sel * ghat_n is stored transposed and split into hi =
// bf16(W) and lo = bf16(W - hi); g, proj (and out) come in 64-column
// chunks by cp.async through a ring of kStages. Each thread masks the
// pieces it copied, g <- out > 0 ? g : 0 bit for bit in bf16 (a NaN out
// fails the test, as in torch.where); inv_keep multiplies the f32 sums
// instead, so
// every operand stays an exact bf16 value. Per chunk on
// mma.sync.m16n8k16: G_n += g_n p_n^T, each warp keeping up to two
// 16 x 16 tiles of it in registers for the whole sweep, and dproj_n =
// (hi + lo)^T g_n for the chunk's columns, stored as bf16 pairs.
template <int MT>
__global__ void __launch_bounds__(kThreads)
edge_aggregate_bwd_dot_mma_kernel(const __nv_bfloat16* __restrict__ g,
                                  const float* __restrict__ sel,
                                  const float* __restrict__ ghat,
                                  const __nv_bfloat16* __restrict__ proj,
                                  const __nv_bfloat16* __restrict__ out,
                                  float* __restrict__ ge,
                                  __nv_bfloat16* __restrict__ dproj, int K,
                                  int n_kernels, int d, float inv_keep) {
  using namespace mma_sync;
  constexpr int KP = 16 * MT;
  constexpr int kWLd = KP + 8;
  constexpr int kSlab = KP * kCLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wt_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wt_lo = wt_hi + KP * kWLd;     // (KP, kWLd): W^T [j][i]
  __nv_bfloat16* ring = wt_lo + KP * kWLd;      // per stage: g, proj, out
  const int slabs = out ? 3 : 2;

  const int kern = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nd = n_kernels * d, kk = K * K;
  const size_t plane = (static_cast<size_t>(b) * n_kernels + kern) * kk;
  const size_t slab = static_cast<size_t>(b) * K * nd + kern * d;
  const int chunks = (d + kCw - 1) / kCw;
  constexpr int kPieces = kCw / 8;  // 16-byte pieces a row

  // rows past K and columns past d arrive as zeros; a chunk past the
  // last commits an empty group, so that every thread counts the same
  // groups
  auto load_chunk = [&](int c) {
    __nv_bfloat16* st = ring + (c % kStages) * slabs * kSlab;
    for (int idx = tid; c < chunks && idx < KP * kPieces; idx += kThreads) {
      const int i = idx / kPieces, p = (idx % kPieces) * 8, col = c * kCw + p;
      const bool valid = i < K && col < d;
      const size_t at = valid ? slab + static_cast<size_t>(i) * nd + col : 0;
      cp_async_16(st + i * kCLd + p, g + at, valid);
      cp_async_16(st + kSlab + i * kCLd + p, proj + at, valid);
      if (out) cp_async_16(st + 2 * kSlab + i * kCLd + p, out + at, valid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load_chunk(c);

  for (int e = tid; e < KP * KP; e += kThreads) {
    const int i = e / KP, j = e % KP;
    const float w = i < K && j < K
                        ? sel[static_cast<size_t>(b) * kk + i * K + j] *
                              ghat[plane + i * K + j]
                        : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(w);
    wt_hi[j * kWLd + i] = hi;
    wt_lo[j * kWLd + i] = __float2bfloat16_rn(w - __bfloat162float(hi));
  }

  // G_n's tiles: (m, n) 16 x 16 tile u = warp, warp + 8 of MT x MT
  float acc_g[2][2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_g[q][h][r] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of chunk c
    __nv_bfloat16* g_s = ring + (c % kStages) * slabs * kSlab;
    const __nv_bfloat16* p_s = g_s + kSlab;
    if (out) {  // this thread's own pieces have landed
      const __nv_bfloat16* o_s = g_s + 2 * kSlab;
      for (int idx = tid; idx < KP * kPieces; idx += kThreads) {
        const int at = (idx / kPieces) * kCLd + (idx % kPieces) * 8;
        uint4 gv = *reinterpret_cast<const uint4*>(g_s + at);
        const uint4 ov = *reinterpret_cast<const uint4*>(o_s + at);
        uint32_t* gw = reinterpret_cast<uint32_t*>(&gv);
        const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // out > 0 for a bf16 half u: 0 < u <= 0x7f80 (+inf included,
          // NaN and every negative excluded)
          const uint32_t lo = ow[q] & 0xffffu, hi = ow[q] >> 16;
          const uint32_t keep = (lo - 1u < 0x7f80u ? 0x0000ffffu : 0u) |
                                (hi - 1u < 0x7f80u ? 0xffff0000u : 0u);
          gw[q] &= keep;
        }
        *reinterpret_cast<uint4*>(g_s + at) = gv;
      }
    }
    __syncthreads();  // chunk c is whole; chunk c - 1's stage is free
    load_chunk(c + kStages - 1);

#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = warp + q * kMmaWarps;
      if (u >= MT * MT) break;
      const int mt = u / MT, nt = u % MT;
#pragma unroll
      for (int ks = 0; ks < kCw / 16; ++ks) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, g_s + (mt * 16 + (lane & 15)) * kCLd + ks * 16 +
                        (lane >> 4) * 8);
        ldsm_x4(bf, p_s + (nt * 16 + (lane & 7) + (lane >> 4) * 8) * kCLd +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc_g[q][0], af, bf[0], bf[1]);
        mma_bf16(acc_g[q][1], af, bf[2], bf[3]);
      }
    }

    // dproj: (m = j tile, 16-column group) units u = warp, warp + 8
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = warp + q * kMmaWarps;
      if (u >= MT * (kCw / 16)) break;
      const int mt = u / (kCw / 16), grp = u % (kCw / 16);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) {
        uint32_t bf[4], af[4];
        ldsm_x4_trans(bf, g_s + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    kCLd + grp * 16 + (lane >> 4) * 8);
        const int a_at = (mt * 16 + (lane & 15)) * kWLd + kt * 16 +
                         (lane >> 4) * 8;
        ldsm_x4(af, wt_hi + a_at);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
        ldsm_x4(af, wt_lo + a_at);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = mt * 16 + (lane >> 2) + r * 8;
          const int col = c * kCw + grp * 16 + h * 8 + (lane & 3) * 2;
          if (j < K && col < d)
            *reinterpret_cast<__nv_bfloat162*>(
                dproj + slab + static_cast<size_t>(j) * nd + col) =
                __floats2bfloat162_rn(acc[h][2 * r] * inv_keep,
                                      acc[h][2 * r + 1] * inv_keep);
        }
    }
  }
  cp_async_wait<0>();  // only empty groups remain

#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int u = warp + q * kMmaWarps;
    if (u >= MT * MT) break;
    const int mt = u / MT, nt = u % MT;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = mt * 16 + (lane >> 2) + (r >> 1) * 8;
        const int j = nt * 16 + h * 8 + (lane & 3) * 2 + (r & 1);
        if (i < K && j < K) ge[plane + i * K + j] = acc_g[q][h][r] * inv_keep;
      }
  }
}

template <int MT>
cudaError_t launch_dot_mma(const void* g, const void* sel, const void* ghat,
                           const void* proj, const void* out, void* ge,
                           void* dproj, int B, int K, int n_kernels, int d,
                           float inv_keep, cudaStream_t stream) {
  const size_t smem = dot_mma_smem_bytes(16 * MT, out != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edge_aggregate_bwd_dot_mma_kernel<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  edge_aggregate_bwd_dot_mma_kernel<MT>
      <<<dim3(n_kernels, B), kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(g),
          static_cast<const float*>(sel), static_cast<const float*>(ghat),
          static_cast<const __nv_bfloat16*>(proj),
          static_cast<const __nv_bfloat16*>(out), static_cast<float*>(ge),
          static_cast<__nv_bfloat16*>(dproj), K, n_kernels, d, inv_keep);
  return cudaGetLastError();
}

cudaError_t dot_mma(const void* g, const void* sel, const void* ghat,
                    const void* proj, const void* out, void* ge, void* dproj,
                    int B, int K, int n_kernels, int d, float inv_keep,
                    cudaStream_t s) {
  switch ((K + 15) / 16) {
    case 1:
      return launch_dot_mma<1>(g, sel, ghat, proj, out, ge, dproj, B, K,
                               n_kernels, d, inv_keep, s);
    case 2:
      return launch_dot_mma<2>(g, sel, ghat, proj, out, ge, dproj, B, K,
                               n_kernels, d, inv_keep, s);
    case 3:
      return launch_dot_mma<3>(g, sel, ghat, proj, out, ge, dproj, B, K,
                               n_kernels, d, inv_keep, s);
    default:
      return launch_dot_mma<4>(g, sel, ghat, proj, out, ge, dproj, B, K,
                               n_kernels, d, inv_keep, s);
  }
}

template <typename T>
cudaError_t dot_simt(const void* g, const void* sel, const void* ghat,
                     const void* proj, const void* out, void* ge, void* dproj,
                     int B, int K, int n_kernels, int d, float inv_keep,
                     cudaStream_t stream) {
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
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* g, const void* sel, const void* ghat,
                const void* denom, const void* pseudo, const void* proj,
                const void* gparams, const void* out, void* ge, void* dsel,
                void* dpseudo, void* dproj, void* dgp_part, int B, int K,
                int n_kernels, int d, float inv_keep, bool mma,
                cudaStream_t stream) {
  cudaError_t e;
  if (mma) {
    e = dot_mma(g, sel, ghat, proj, out, ge, dproj, B, K, n_kernels, d,
                inv_keep, stream);
  } else {
    e = dot_simt<T>(g, sel, ghat, proj, out, ge, dproj, B, K, n_kernels, d,
                    inv_keep, stream);
  }
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
// 4, n). Needs K <= 64 and n <= 32. body: 0 = the SIMT dot part (any
// dtype), 1 = the bf16 mma dot part (bfloat16, d a multiple of 8, g, proj,
// out and dproj 16-byte aligned). Two launches. Returns cudaError_t.
extern "C" int edge_aggregate_bwd(const void* g, const void* sel,
                                  const void* ghat, const void* denom,
                                  const void* pseudo, const void* proj,
                                  const void* gparams, const void* out,
                                  void* ge, void* dsel, void* dpseudo,
                                  void* dproj, void* dgp_part, int B, int K,
                                  int n_kernels, int d, float inv_keep,
                                  int dtype, int body, void* stream) {
  if (B <= 0 || K <= 0 || d <= 0 || n_kernels <= 0 || B > 65535 ||
      K * K > kMaxG * kThreads || n_kernels > kMaxKernels || body < 0 ||
      body > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (body == 1 && (dtype != 1 || d % 8 || !aligned(g) || !aligned(proj) ||
                    !aligned(out) || !aligned(dproj)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = run<float>(g, sel, ghat, denom, pseudo, proj, gparams, out, ge, dsel,
                   dpseudo, dproj, dgp_part, B, K, n_kernels, d, inv_keep,
                   false, s);
  else if (dtype == 1)
    e = run<__nv_bfloat16>(g, sel, ghat, denom, pseudo, proj, gparams, out,
                           ge, dsel, dpseudo, dproj, dgp_part, B, K,
                           n_kernels, d, inv_keep, body == 1, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
