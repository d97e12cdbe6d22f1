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
// What bounds it on an H100: operations. At B=64 (B*K = 2304 rows, F1 =
// 2052, n*d1 = 2048, n*d2 = 1024) the products dW2, g1 and dW1 are ~39
// GFLOP (0.039 ms at the bf16 peak; dfeats, which the model never asks
// for, adds 19 GFLOP) and the two aggregation backwards ~1 GFLOP of f32
// FMAs (0.015 ms at the f32 rate), against ~80 MB of inputs and outputs
// (0.024 ms at 3.35 TB/s).
//
// What holds it back (PERF.md, B=64 on an H100): the dot part, about two
// fifths of I's time at ~3.6x its 75 MB byte bound. Both of its products
// read their two operands from shared memory, 7-8 16-byte reads for every
// 48-64 FMAs of a warp, and at 110-128 registers two blocks of 8 warps
// share an SM, so the chunk barriers leave little to overlap. Then the
// products: g1's gated f32 epilogue (19 MB out, 9 MB of gate in) runs
// after only 16 K steps with the tensor cores idle.
//
// Design, up to eight launches, per conv (conv2, then conv1):
// (1) the dot part: one block per (Gaussian kernel, image) forms the K x
//     K weights w_n = sel * ghat_n once and walks its d columns in chunks
//     of 64, staging g (and conv2's gate, out) and proj as f32 by
//     cp.async one chunk ahead; conv2's gate is applied by each thread to
//     the pieces it staged itself, so it costs no barrier. Two register
//     tiles, exact f32 FMAs: dp_n = w_n^T g_n, RT rows x 4 columns a
//     thread (the sum over i in order, as kernel H's aggregation), rounded
//     once to the compute dtype; and G_n = g_n proj_n^T, 4 x 4 entries a
//     thread from float4 reads of both operands, the chunk's 16 column
//     quads dealt round-robin to `groups` thread groups when K is small
//     (K = 36: 81 tiles, 3 groups), whose sums meet in a fixed order at
//     the end. Both products read their operands from shared memory. They
//     stay off the tensor cores on purpose: g and proj are f32, and the
//     plain version sums them in f32.
// (2) the edge part, on a grid of (row group, image): each block owns
//     `rows` adjacency rows of an image (K = 36: 6 rows, 216 edges; 384
//     blocks at B=64), a thread one edge across all n kernels (dsel, dadj
//     with the row sums of the softmax VJP, which stay inside the block,
//     dpseudo) and the block's (4, n) gparams partials reduced in a fixed
//     order; the wrapper sums the (4, n, B * groups) partials along their
//     rows, so a run repeats bit for bit: no atomics anywhere.
// Between them the products, on wgmma_gemm.cuh's wgmma + TMA product
// where the operands are bf16 and fit TMA (wgmma_gemm::fits), else on
// tile_gemm.cuh (f32, the exact parity path, and other widths): TN for
// the weight gradients (both operands MN-major; feats read by its row
// stride ldf, TMA zero-filling the M edge at F1 and the K tail at B*K),
// NT with the relu/dropout gate as its epilogue for g1 (read from h1 at
// each fragment's row and column), NT storing bf16 for dfeats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma_sync.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using tile_gemm::store;
using tile_gemm::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kMaxKernels = 32;
constexpr int kWarps = kThreads / 32;
constexpr int kCT = 64;                // columns of g / proj per chunk
constexpr int kCG = kCT / 4;           // column quads of a chunk
constexpr int kRG = kThreads / kCG;    // dp's row groups
constexpr int kLd = kCT + 4;           // staged row: 17 16-byte units, odd
constexpr int kGT = 4;                 // G's register tile: kGT x kGT

// jnp.sign: 0 at 0 (copysignf would give +-1)
__device__ __forceinline__ float sign0(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// kBytes global -> shared through L1 (.ca takes 4, 8 or 16); zero fill
// when !valid
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(mma_sync::smem_u32(dst)), "l"(src), "n"(kBytes),
                  "r"(valid ? kBytes : 0)
               : "memory");
}

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

// ---------------- the dot part ----------------

// G's kGT x kGT tiles per side: rows ti + kt * u, u < kGT (K = 36: 9)
__host__ __device__ inline int g_tiles(int K) { return (K + kGT - 1) / kGT; }

// thread groups that split a chunk's column quads for G
inline int g_groups(int K) {
  const int t2 = g_tiles(K) * g_tiles(K);
  const int s = kThreads / t2;
  return s < kCG ? s : kCG;
}

struct DotArgs {
  const float* g;       // (B*K, nd) f32
  const void* gate;     // (B*K, nd) in T: conv2's out, or null
  const float* sel;     // (B, K, K): alpha (conv1) or the 0/1 mask (conv2)
  const float* ghat;    // (B, n, K, K)
  const float* proj;    // (B*K, nd) f32
  float* ge;            // (B, n, K, K): G_n
  void* dproj;          // (B*K, nd) in T
  int K, n_kernels, d;
  int groups;           // g_groups(K)
  int vec;              // stage by cp.async (16-byte pieces)
};

template <typename T>
size_t dot_smem_bytes(int K, bool gated) {
  const size_t w = static_cast<size_t>(K) * ((K + 3) / 4 * 4) * 4;
  size_t stage = static_cast<size_t>(4) * K * kLd * 4;
  if (gated) stage += static_cast<size_t>(2) * K * kCT * sizeof(T);
  const int t2 = g_tiles(K) * g_tiles(K);
  const size_t red =
      static_cast<size_t>(g_groups(K) - 1) * kGT * kGT * t2 * 4;
  return w + (stage > red ? stage : red);
}

template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
block_bwd_dot_kernel(DotArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int K = a.K, kw = (K + 3) / 4 * 4, d = a.d;
  const int nd = a.n_kernels * d, kk = K * K;
  float* w_s = smem;                    // (K, kw): w_s[j][i] = w_n[i][j]
  float* g_s = w_s + K * kw;            // 2 x (K, kLd) g chunks
  float* p_s = g_s + 2 * K * kLd;       // 2 x (K, kLd) proj chunks
  T* o_s = reinterpret_cast<T*>(p_s + 2 * K * kLd);  // 2 x (K, kCT) gate
  const int kern = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t slab = static_cast<size_t>(b) * K * nd + kern * d;
  const float* g_b = a.g + slab;
  const float* p_b = a.proj + slab;
  const T* o_b = a.gate ? static_cast<const T*>(a.gate) + slab : nullptr;
  const int chunks = (d + kCT - 1) / kCT;

  // chunk c into buffer c % 2: 16-byte pieces by cp.async (columns past d
  // zero-filled), thread tid taking pieces tid, tid + kThreads, ..; else
  // plain loads, gated on the way
  const auto stage = [&](int c) {
    float* gd = g_s + (c % 2) * K * kLd;
    float* pd = p_s + (c % 2) * K * kLd;
    T* od = o_s + (c % 2) * K * kCT;
    const int c0 = c * kCT;
    if (a.vec) {
      for (int idx = tid; idx < K * kCG; idx += kThreads) {
        const int j = idx / kCG, q = idx % kCG * 4, col = c0 + q;
        const bool valid = col < d;
        const size_t at = static_cast<size_t>(j) * nd + (valid ? col : 0);
        mma_sync::cp_async_16(gd + j * kLd + q, g_b + at, valid);
        mma_sync::cp_async_16(pd + j * kLd + q, p_b + at, valid);
        if (o_b)
          cp_async_ca<4 * sizeof(T)>(od + j * kCT + q, o_b + at, valid);
      }
      mma_sync::cp_async_commit();
    } else {
      for (int idx = tid; idx < K * kCT; idx += kThreads) {
        const int j = idx / kCT, q = idx % kCT, col = c0 + q;
        float gv = 0.f, pv = 0.f;
        if (col < d) {
          const size_t at = static_cast<size_t>(j) * nd + col;
          gv = g_b[at];
          if (o_b && !(to_f32(o_b[at]) > 0.f)) gv = 0.f;
          pv = p_b[at];
        }
        gd[j * kLd + q] = gv;
        pd[j * kLd + q] = pv;
      }
    }
  };
  stage(0);
  const float* sel_b = a.sel + static_cast<size_t>(b) * kk;
  const float* gh_b =
      a.ghat + (static_cast<size_t>(b) * a.n_kernels + kern) * kk;
  for (int e = tid; e < kk; e += kThreads)
    w_s[e % K * kw + e / K] = sel_b[e] * gh_b[e];

  // dp: rows rg + kRG r of the chunk's 64 columns, 4 columns a thread
  const int cg = tid % kCG, rg = tid / kCG;
  const float* wr[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) wr[r] = w_s + min(rg + kRG * r, K - 1) * kw;
  T* dp_b = static_cast<T*>(a.dproj) + slab;
  // G: group sg's tile (ti, tj), rows ti + kt u and tj + kt v, so that
  // neighbouring threads read neighbouring rows
  const int kt = g_tiles(K), t2 = kt * kt;
  const int sg = tid / t2, tt = tid % t2, ti = tt / kt, tj = tt % kt;
  int ri[kGT], rj[kGT];
#pragma unroll
  for (int u = 0; u < kGT; ++u) {
    ri[u] = min(ti + kt * u, K - 1);
    rj[u] = min(tj + kt * u, K - 1);
  }
  float gacc[kGT][kGT];
#pragma unroll
  for (int u = 0; u < kGT; ++u)
#pragma unroll
    for (int v = 0; v < kGT; ++v) gacc[u][v] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      // buffer (c + 1) % 2 was last read in step c - 1, before the barrier
      // that ended it
      stage(c + 1);
      if (a.vec) mma_sync::cp_async_wait<1>();
    } else if (a.vec) {
      mma_sync::cp_async_wait<0>();
    }
    float* gc = g_s + (c % 2) * K * kLd;
    const float* pc = p_s + (c % 2) * K * kLd;
    if (a.vec && o_b) {
      // conv2's relu: the pieces this thread staged are visible to it once
      // its copies are complete, so it gates them itself before the barrier
      const T* oc = o_s + (c % 2) * K * kCT;
      for (int idx = tid; idx < K * kCG; idx += kThreads) {
        const int j = idx / kCG, q = idx % kCG * 4;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (!(to_f32(oc[j * kCT + q + t]) > 0.f)) gc[j * kLd + q + t] = 0.f;
      }
    }
    __syncthreads();  // chunk c (and, at c = 0, the weights) in place

    // dp[j][col] = sum over i = 0, 1, .. K-1 of w[i][j] g[i][col]
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    const float* gq = gc + 4 * cg;
    int i = 0;
    for (; i + 4 <= K; i += 4) {
      float4 x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        x[t] = *reinterpret_cast<const float4*>(gq + (i + t) * kLd);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 w4 = *reinterpret_cast<const float4*>(wr[r] + i);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[r][0] = fmaf(w[t], x[t].x, acc[r][0]);
          acc[r][1] = fmaf(w[t], x[t].y, acc[r][1]);
          acc[r][2] = fmaf(w[t], x[t].z, acc[r][2]);
          acc[r][3] = fmaf(w[t], x[t].w, acc[r][3]);
        }
      }
    }
    for (; i < K; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(gq + i * kLd);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float w = wr[r][i];
        acc[r][0] = fmaf(w, x.x, acc[r][0]);
        acc[r][1] = fmaf(w, x.y, acc[r][1]);
        acc[r][2] = fmaf(w, x.z, acc[r][2]);
        acc[r][3] = fmaf(w, x.w, acc[r][3]);
      }
    }
    const int col0 = c * kCT + 4 * cg;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int j = rg + kRG * r;
      if (j >= K || col0 >= d) continue;
      T* p = dp_b + static_cast<size_t>(j) * nd + col0;
      if (a.vec) {  // col0 < d and d % 4 == 0: all four columns lie inside
        store4(p, acc[r]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col0 + q < d) store(p + q, acc[r][q]);
      }
    }

    // G[i][j] += sum over this group's column quads of g[i][.] p[j][.]
    if (sg < a.groups) {
      for (int c4 = sg; c4 < kCG; c4 += a.groups) {
        float4 x[kGT], y[kGT];
#pragma unroll
        for (int u = 0; u < kGT; ++u) {
          x[u] = *reinterpret_cast<const float4*>(gc + ri[u] * kLd + 4 * c4);
          y[u] = *reinterpret_cast<const float4*>(pc + rj[u] * kLd + 4 * c4);
        }
#pragma unroll
        for (int u = 0; u < kGT; ++u)
#pragma unroll
          for (int v = 0; v < kGT; ++v) {
            gacc[u][v] = fmaf(x[u].x, y[v].x, gacc[u][v]);
            gacc[u][v] = fmaf(x[u].y, y[v].y, gacc[u][v]);
            gacc[u][v] = fmaf(x[u].z, y[v].z, gacc[u][v]);
            gacc[u][v] = fmaf(x[u].w, y[v].w, gacc[u][v]);
          }
      }
    }
    __syncthreads();  // every read of buffer c % 2 is done
  }

  // the groups' sums meet in group order, through the staging space
  constexpr int kE = kGT * kGT;
  float* red = g_s;  // (groups - 1, kE, t2)
  if (sg > 0 && sg < a.groups)
#pragma unroll
    for (int e = 0; e < kE; ++e)
      red[((sg - 1) * kE + e) * t2 + tt] = gacc[e / kGT][e % kGT];
  __syncthreads();
  if (sg == 0) {
    float* ge_b = a.ge + (static_cast<size_t>(b) * a.n_kernels + kern) * kk;
#pragma unroll
    for (int u = 0; u < kGT; ++u)
#pragma unroll
      for (int v = 0; v < kGT; ++v) {
        const int gi = ti + kt * u, gj = tj + kt * v;
        if (gi >= K || gj >= K) continue;
        float x = gacc[u][v];
        for (int q = 1; q < a.groups; ++q)
          x += red[((q - 1) * kE + kGT * u + v) * t2 + tt];
        ge_b[gi * K + gj] = x;
      }
  }
}

template <typename T, int RT>
cudaError_t launch_dot_rt(const DotArgs& a, int B, cudaStream_t s) {
  const size_t smem = dot_smem_bytes<T>(a.K, a.gate != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_bwd_dot_kernel<T, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  block_bwd_dot_kernel<T, RT><<<dim3(a.n_kernels, B), kThreads, smem, s>>>(
      a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dot(const DotArgs& a, int B, cudaStream_t s) {
  switch ((a.K + kRG - 1) / kRG) {
    case 1:
      return launch_dot_rt<T, 1>(a, B, s);
    case 2:
      return launch_dot_rt<T, 2>(a, B, s);
    case 3:
      return launch_dot_rt<T, 3>(a, B, s);
    default:
      return launch_dot_rt<T, 4>(a, B, s);
  }
}

// ---------------- the edge part ----------------

// adjacency rows a block owns: as many as keep its edges within one per
// thread, spread evenly over the row groups (K = 36: 6 groups of 6)
inline int edge_groups(int K) {
  const int rows = K < kThreads / K ? K : kThreads / K;
  return (K + rows - 1) / rows;
}
inline int edge_rows(int K) {
  const int groups = edge_groups(K);
  return (K + groups - 1) / groups;
}

struct EdgeArgs {
  const float* ge;       // (B, n, K, K)
  const float* sel;      // (B, K, K)
  const float* ghat;     // (B, n, K, K)
  const float* denom;    // (B, K, K)
  const float* pseudo;   // (B, K, K, 2)
  const float* gparams;  // (4, n)
  float* dadj;           // (B, K, K), conv1 only
  float* dpseudo;        // (B, K, K, 2)
  float* dgp_part;       // (4, n, B * groups)
  int K, n_kernels, rows, groups;
  int accumulate;        // add to the dpseudo conv2's pass stored
};

// Block (row group, image): thread t owns edge (i0 + t / K, t % K) across
// all n kernels. With kAlpha (conv1), also dadj through the softmax.
template <bool kAlpha>
__global__ void __launch_bounds__(kThreads)
block_bwd_edge_kernel(EdgeArgs a) {
  __shared__ float gp_s[4 * kMaxKernels];
  __shared__ float red_s[kWarps][kMaxKernels][4];
  __shared__ float dsel_s[kThreads];
  __shared__ float row_s[kMaxK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = blockIdx.x, b = blockIdx.y, K = a.K, nk = a.n_kernels;
  const int kk = K * K, i0 = rg * a.rows;
  const int nrows = min(a.rows, K - i0);
  const bool valid = tid < nrows * K;
  const size_t at = static_cast<size_t>(b) * kk + i0 * K + tid;
  const size_t planes = static_cast<size_t>(b) * nk * kk + i0 * K + tid;
  const float two_pi = 6.283185307179586f;

  for (int i = tid; i < 4 * nk; i += kThreads) gp_s[i] = a.gparams[i];
  float s = 0.f, ds = 0.f, sc = 0.f, den = 1.f, ind = 0.f, rho = 0.f,
        theta = 0.f;
  if (valid) {
    s = a.sel[at];
    for (int q = 0; q < nk; ++q) {
      const float gm = a.ge[planes + static_cast<size_t>(q) * kk];
      const float hm = a.ghat[planes + static_cast<size_t>(q) * kk];
      ds += gm * hm;
      // rounded as the plain version rounds them (no fused multiply-add),
      // so that gm * sel - scross is exactly 0 where ghat is 1 (n = 1):
      // their true difference, which inv_r would otherwise amplify
      sc = __fadd_rn(sc, __fmul_rn(__fmul_rn(gm, s), hm));
    }
    den = a.denom[at];
    ind = den > 1e-20f ? 1.f : 0.f;
    rho = a.pseudo[2 * at];
    theta = a.pseudo[2 * at + 1];
  }
  __syncthreads();  // gp_s

  float drho = 0.f, dth = 0.f;
  for (int q = 0; q < nk; ++q) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};  // dmu_r, dmu_t, dprec_r, dprec_t
    if (valid) {
      const float mu_r = gp_s[q], mu_t = gp_s[nk + q];
      const float pr = gp_s[2 * nk + q], pt = gp_s[3 * nk + q];
      const float inv_r = 1.f / (1e-14f + pr * pr);
      const float inv_t = 1.f / (1e-14f + pt * pt);
      const float gm = a.ge[planes + static_cast<size_t>(q) * kk];
      const float hm = a.ghat[planes + static_cast<size_t>(q) * kk];
      const float dw =
          __fsub_rn(__fmul_rn(gm, s), __fmul_rn(ind, sc)) / den;
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
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t[r] += __shfl_down_sync(0xffffffffu, t[r], off);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) red_s[warp][q][r] = t[r];
  }
  if (kAlpha) dsel_s[tid] = ds;
  __syncthreads();

  // the block's partials, the warps added in order: column b * groups +
  // rg of the (4, n) rows, so that the wrapper's sum runs along rows
  const size_t parts = static_cast<size_t>(gridDim.y) * a.groups;
  const size_t col = static_cast<size_t>(b) * a.groups + rg;
  for (int idx = tid; idx < 4 * nk; idx += kThreads) {
    const int r = idx / nk, q = idx % nk;
    float x = 0.f;
    for (int w = 0; w < kWarps; ++w) x += red_s[w][q][r];
    a.dgp_part[idx * parts + col] = x;
  }
  if (kAlpha) {
    if (tid < nrows) {
      const float* sel_row = a.sel + static_cast<size_t>(b) * kk +
                             (i0 + tid) * K;
      float x = 0.f;
      for (int j = 0; j < K; ++j) x += dsel_s[tid * K + j] * sel_row[j];
      row_s[tid] = x;
    }
    __syncthreads();
  }
  if (valid) {
    if (kAlpha) a.dadj[at] = s * (ds - row_s[tid / K]);
    const float pr_ = a.accumulate ? a.dpseudo[2 * at] : 0.f;
    const float pt_ = a.accumulate ? a.dpseudo[2 * at + 1] : 0.f;
    a.dpseudo[2 * at] = pr_ + drho;
    a.dpseudo[2 * at + 1] = pt_ + dth;
  }
}

// ---------------- the products and the order of launches ----------------

// C = op(A) op(B) in layout L through the epilogue (mode, C, ldc, gate,
// scale): on wgmma where the operands are bf16 and fit TMA, else on
// tile_gemm.cuh. The two share the epilogue modes' codes.
template <int L, typename T>
cudaError_t product(const T* A, int lda, const T* B, int ldb, int mode,
                    void* C, int ldc, const T* gate, float scale, int M,
                    int N, int K, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (wgmma_gemm::fits(A, lda, B, ldb))
      return wgmma_gemm::gemm<L>(
          A, lda, B, ldb, wgmma_gemm::Epilogue{mode, C, ldc, gate, scale}, M,
          N, K, 0, 0, s);
  return tile_gemm::gemm<T>(L, A, B, M, N, K, lda, ldb,
                            tile_gemm::Epilogue<T>{mode, C, ldc, gate, scale},
                            s);
}

template <typename T>
bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename T>
cudaError_t conv_bwd(const float* g, const T* gate, const float* sel,
                     const float* ghat, const float* denom,
                     const float* pseudo, const float* gparams,
                     const float* proj, float* ge, T* dproj, float* dadj,
                     float* dpseudo, float* dgp_part, int B, int K, int n,
                     int d, cudaStream_t s) {
  const int nd = n * d;
  const int vec = d % 4 == 0 && nd % 4 == 0 && aligned<float>(g) &&
                  aligned<float>(proj) && aligned<T>(dproj) &&
                  (gate == nullptr || aligned<T>(gate));
  cudaError_t e = launch_dot<T>(
      DotArgs{g, gate, sel, ghat, proj, ge, dproj, K, n, d, g_groups(K),
              vec},
      B, s);
  if (e != cudaSuccess) return e;
  const EdgeArgs ea{ge, sel, ghat, denom, pseudo, gparams, dadj, dpseudo,
                    dgp_part, K, n, edge_rows(K), edge_groups(K),
                    dadj != nullptr};
  const dim3 grid(ea.groups, B);
  if (dadj)
    block_bwd_edge_kernel<true><<<grid, kThreads, 0, s>>>(ea);
  else
    block_bwd_edge_kernel<false><<<grid, kThreads, 0, s>>>(ea);
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
  using tile_gemm::kGateF32;
  using tile_gemm::kNT;
  using tile_gemm::kStoreF32;
  using tile_gemm::kStoreT;
  using tile_gemm::kTN;
  const int rows = B * K, nd1 = n * d1, nd2 = n * d2;
  // conv2 first stores dpseudo; conv1's pass adds to it and writes dadj
  cudaError_t e = conv_bwd<T>(g, out, mask, ghat2, den2, pseudo, gp2, proj2,
                              ge, dp2, nullptr, dpseudo, dgp2_part, B, K, n,
                              d2, s);
  if (e != cudaSuccess) return e;
  e = product<kTN, T>(h1, nd1, dp2, nd2, kStoreF32, dw2cat, nd2, nullptr,
                      1.f, nd1, nd2, rows, s);
  if (e != cudaSuccess) return e;
  e = product<kNT, T>(dp2, nd2, w2cat, nd2, kGateF32, g1, nd1, h1, inv_keep,
                      rows, nd1, nd2, s);
  if (e != cudaSuccess) return e;
  e = conv_bwd<T>(g1, nullptr, alpha, ghat1, den1, pseudo, gp1, proj1, ge,
                  dp1, dadj, dpseudo, dgp1_part, B, K, n, d1, s);
  if (e != cudaSuccess) return e;
  e = product<kTN, T>(feats, ldf, dp1, nd1, kStoreF32, dw1cat, nd1, nullptr,
                      1.f, F1, nd1, rows, s);
  if (e != cudaSuccess || !dfeats) return e;
  return product<kNT, T>(dp1, nd1, w1cat, nd1, kStoreT, dfeats, F1, nullptr,
                         1.f, rows, F1, nd1, s);
}

}  // namespace

// Rows of (4, n) gparams partials each image contributes per conv: the
// edge part's row groups.
extern "C" int graph_block_bwd_groups(int K) {
  return K > 0 && K <= kMaxK ? edge_groups(K) : 0;
}

// Kernel I. dtype 0 = float32, 1 = bfloat16 for out (B, K, n*d2), h1
// (B, K, n*d1), feats (B*K rows of F1, row stride ldf, as kernel H reads
// it), w1cat (F1, n*d1), w2cat (n*d1, n*d2),
// the scratch dp2 (B*K, n*d2) and dp1 (B*K, n*d1), and dfeats (B, K, F1;
// null skips it); float32: g (B, K, n*d2), kernel H's proj1, proj2,
// alpha, mask, ghat1, ghat2, den1, den2, pseudo and dpseudo (B, K, K, 2),
// gp1, gp2 (4, n), the scratch ge (B, n, K, K) and g1 (B*K, n*d1), dadj
// (B, K, K), dw1cat (F1, n*d1), dw2cat (n*d1, n*d2), and the partials
// dgp1_part, dgp2_part (4, n, B * graph_block_bwd_groups(K)). Needs K <=
// 64, n <= 32. Each product runs on wgmma where its operands fit (bf16,
// wgmma_gemm::fits), else on tile_gemm.cuh. Up to eight launches.
// Returns cudaError_t.
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
  if (B <= 0 || K <= 0 || K > kMaxK || F1 <= 0 || ldf < F1 || n <= 0 ||
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
