// Backward of the GRU recurrence (kernel E) for Hopper (sm_90a): the
// reverse-time sweep and the hidden-weight gradient.
//
// Replaces the TPU kernel vqa_project_tpu/ops/pallas/gru_scan.py
// ::_gru_bwd_kernel (the VJP of pallas_gru; same numbers as its default
// _bwd_xla_reference). With gh the gradient reaching h_out at step t:
//
//   hp = h_prev @ W^T + b (h_prev cast to W's dtype, f32 sum)
//   r, z, n as in the forward;  keep = t < qlen[b]
//   g_new = keep ? gh : 0 ;  pass = keep ? 0 : gh
//   dz = g_new (h_prev - n)    dn = g_new (1 - z)     dn_pre = dn (1 - n^2)
//   dr = dn_pre hn             dhn = dn_pre r
//   dr_pre = dr r (1 - r)      dz_pre = dz z (1 - z)
//   dhp = [dr_pre; dz_pre; dhn]  (stored in W's dtype)
//   dxp = [dr_pre; dz_pre; dn_pre]  (f32)
//   gh at step t-1 = pass + g_new z + dhp @ W     (dhp cast to W's dtype)
//   dW = sum_{t,b} dhp[t,b]^T h_prev[t,b],  db = sum_{t,b} dhp[t,b]  (f32)
//
// What bounds it on an H100: the latency of the T dependent steps, and
// bytes: every step needs the whole dhp of the step after (B x 3H) against
// all of W_hh (6.3 MB in bf16 at H=1024). ops/gru_scan.py::sweep_kernel
// picks one of two sweeps from (weight dtype, B, H).
//
// gru_sweep_persistent_kernel (bf16 weights, 1 <= B <= 256, H % 64 == 0,
// H <= 1024; entry gru_scan_bwd_persistent): one cooperative launch for
// all T reverse steps, on kernel B's pattern (csrc/gru_scan.cu). Each of
// the H/8 blocks owns a fixed slice of hidden units for the whole sweep:
// 8 units and every batch row at B <= 16; past one 16-row tile two blocks
// split the batch and each owns 16 units, so that a block reads half of
// dhp[t+1] per step. The units' carry pass + g_new z stays in registers
// from step to step. The block's columns of W (3H x units: 48 or 96 KB in
// bf16, stored as rows of W^T, padded by 16 bytes for conflict-free
// ldmatrix) are loaded into shared memory once. Per step the block
// streams its rows of dhp[t+1] (bf16, written by every block in the step
// before) from L2 through a 4-stage cp.async.cg ring of ~30 KB chunks and
// multiplies on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
// sum): M is the batch in 16-row tiles, N one n8 tile per 8 units, K = 3H
// split across the warps that M leaves free, the K-split partials added
// through shared memory in a fixed order (runs repeat bit for bit). The
// thread that holds a (row, unit) of the C fragment applies the gate
// algebra and the qlen freeze, writes dhp[t] (bf16) and dxp[t] (f32) and
// updates the carry. Then one grid barrier per step (release add,
// acquire loads, a counter zeroed on the stream before the launch); the
// entry refuses a grid that cannot be resident all at once. dhp is read
// only through L2 (cp.async.cg): other blocks wrote it in this launch.
//
// The hp recompute: route (b). hp does not depend on gh, so it is off the
// critical chain, but recomputing it would keep the block's 3 x units rows
// of W resident too: 2 x 49.5 KB at 8 units fits, 2 x 99 KB at 16 units
// (B > 16 here, B > 128 in kernel B's plan) does not fit 227 KB. So
// kernel B writes hp (T, B, 3H) f32 in training, from the sums it holds
// in its C fragments anyway (12.6 MB at B=64), and the sweep reads the
// slice of its units with the step's xp and h_prev (f32, for dz) before
// each barrier. Only W's columns are resident: 98.6 KB at 16 units,
// plus a ring of 4 x <= 30 KB and <= 7 KB of K-split partials, <= 226 KB.
// hp then carries kernel B's mma.sync summation order instead of a
// recompute's: it differs from the plain version at f32 rounding only.
//
// gru_bwd_step_kernel (f32 weights and any shape the persistent sweep
// cannot hold; entry gru_scan_bwd_step): one launch per step, from T-1
// down to 0, in the forward's per-step layout: a block owns kWarps
// hidden units j and kRows batch rows; each warp owns one unit, its lanes
// split the reduction 4-wide (coalesced weight rows, conflict-free
// shared-memory reads) and a butterfly of shuffles gives every lane the
// totals. Launch t first completes gh for its units from the dhp that
// launch t+1 wrote: gh = carry + dhp_next . W[:, j], reading column j of
// W as row j of a transposed copy W^T (H, 3H) so the loads stay
// coalesced; carry = pass + g_new z is what launch t+1 left for it. It
// then recomputes hp for its units from h_prev = hs[t-1] (zeros at t=0),
// staged once in shared memory like the forward's h tile, and applies
// the gate algebra and the qlen freeze in the lane that owns the row.
//
// gru_wgrad_kernel: the TPU kernel accumulates dW in VMEM across its
// sweep; here it is one tiled reduction after the sweep over the stacked
// dhp (T, B, 3H) and hs: 64 x 64 output tiles, rows of both operands
// staged 16 at a time in shared memory, 4 x 4 f32 accumulators per
// thread. h_prev is rounded to W's dtype as the product sees it. The
// tiles of the first column also sum db over all rows, in a fixed order.
// No atomics: a run is repeatable. (bf16 weights take the wgmma product
// of csrc/gru_wgrad.cu instead.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kWarps = 8;  // hidden units per block: one per warp
constexpr int kRows = 4;   // batch rows per block

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* w) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a value as the products see it: rounded to the weight dtype
__device__ __forceinline__ float as_operand(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float as_operand(float x, const float*) { return x; }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// dhp_next tile (kRows, 3H) and h_prev tile (kRows, H), f32
size_t step_smem_bytes(int H) {
  return static_cast<size_t>(kRows) * 4 * H * sizeof(float);
}

template <typename W>
__global__ void __launch_bounds__(kWarps * 32)
gru_bwd_step_kernel(const float* __restrict__ xp_t,     // (B, 3H)
                    const W* __restrict__ w_hh,         // (3H, H)
                    const W* __restrict__ w_t,          // (H, 3H) = W^T
                    const float* __restrict__ b_hh,     // (3H)
                    const int* __restrict__ qlen,       // (B)
                    const float* __restrict__ h_prev,   // (B, H) or null
                    const W* __restrict__ dhp_next,     // (B, 3H) or null
                    const float* __restrict__ carry_in, // (B, H)
                    float* __restrict__ dxp_t,          // (B, 3H)
                    W* __restrict__ dhp_t,              // (B, 3H)
                    float* __restrict__ carry_out,      // (B, H)
                    int B, int H, int t) {
  extern __shared__ float4 smem4[];
  float* d_s = reinterpret_cast<float*>(smem4);  // (kRows, 3H) dhp_next
  float* h_s = d_s + kRows * 3 * H;              // (kRows, H) h_prev
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kRows;
  const int j = blockIdx.x * kWarps + warp;  // H % kWarps == 0
  const int h3 = 3 * H;

  // stage both tiles at once: independent loads in flight
  for (int i = threadIdx.x; i < kRows * h3; i += blockDim.x) {
    const int r = i / h3;
    d_s[i] = (dhp_next && b0 + r < B)
                 ? to_f32(dhp_next[static_cast<size_t>(b0) * h3 + i]) : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    const int r = i / H;
    h_s[i] = (h_prev && b0 + r < B)
                 ? as_operand(h_prev[static_cast<size_t>(b0) * H + i], w_hh)
                 : 0.f;
  }
  __syncthreads();

  // gh's product: dhp_next[r, :] . W[:, j] = dhp_next[r, :] . W^T[j, :]
  float gacc[kRows];
  // hp recompute: h_prev[r, :] . W[g*H + j, :] for the three gates
  float acc[3][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    gacc[r] = 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g) acc[g][r] = 0.f;
  }
  if (dhp_next) {
    const W* wt_row = w_t + static_cast<size_t>(j) * h3;
#pragma unroll 2
    for (int k = 4 * lane; k < h3; k += 128) {
      float w[4];
      load4(wt_row + k, w);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(d_s + r * h3 + k);
        gacc[r] = fmaf(w[0], dv.x, gacc[r]);
        gacc[r] = fmaf(w[1], dv.y, gacc[r]);
        gacc[r] = fmaf(w[2], dv.z, gacc[r]);
        gacc[r] = fmaf(w[3], dv.w, gacc[r]);
      }
    }
  }
  if (h_prev) {
#pragma unroll 2
    for (int k = 4 * lane; k < H; k += 128) {
      float w[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        load4(w_hh + static_cast<size_t>(g * H + j) * H + k, w[g]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(h_s + r * H + k);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          acc[g][r] = fmaf(w[g][0], hv.x, acc[g][r]);
          acc[g][r] = fmaf(w[g][1], hv.y, acc[g][r]);
          acc[g][r] = fmaf(w[g][2], hv.z, acc[g][r]);
          acc[g][r] = fmaf(w[g][3], hv.w, acc[g][r]);
        }
      }
    }
  }

  // butterfly sums: every lane ends with all totals
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      gacc[r] += __shfl_xor_sync(0xffffffffu, gacc[r], off);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);
    }

  // lane r finishes batch row b0 + r (static indexing keeps acc in registers)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (lane != r || b >= B) continue;
    const size_t row = static_cast<size_t>(b) * H + j;
    const size_t row3 = static_cast<size_t>(b) * h3;
    const float gh = carry_in[row] + gacc[r];
    const float hp = h_prev ? h_prev[row] : 0.f;
    const float* x = xp_t + row3;
    const float hn = acc[2][r] + b_hh[2 * H + j];
    const float rg = sigmoid(x[j] + (acc[0][r] + b_hh[j]));
    const float z = sigmoid(x[H + j] + (acc[1][r] + b_hh[H + j]));
    const float n = tanhf(x[2 * H + j] + rg * hn);
    const bool keep = t < qlen[b];
    const float g_new = keep ? gh : 0.f;
    const float pass = keep ? 0.f : gh;
    const float dz = g_new * (hp - n);
    const float dn = g_new * (1.f - z);
    const float dn_pre = dn * (1.f - n * n);
    const float dr = dn_pre * hn;
    const float dhn = dn_pre * rg;
    const float dr_pre = dr * rg * (1.f - rg);
    const float dz_pre = dz * z * (1.f - z);
    store(dhp_t + row3 + j, dr_pre);
    store(dhp_t + row3 + H + j, dz_pre);
    store(dhp_t + row3 + 2 * H + j, dhn);
    dxp_t[row3 + j] = dr_pre;
    dxp_t[row3 + H + j] = dz_pre;
    dxp_t[row3 + 2 * H + j] = dn_pre;
    carry_out[row] = pass + g_new * z;
  }
}

constexpr int kTileM = 64;   // rows of dW (gate units) per block
constexpr int kTileN = 64;   // columns of dW (hidden inputs) per block
constexpr int kTileK = 16;   // (t, b) rows staged per pass
constexpr int kGemmThreads = 256;

// dW[g, h] = sum_r D[r + B, g] * Hp[r, h] over r < (T-1) B, with D the
// stacked dhp (T B, 3H) and Hp = hs (T B, H) rounded to W's dtype, so row
// r + B of D (step t) meets row r of hs (step t-1); the t=0 rows meet
// h_prev = 0 and add nothing. Blocks with blockIdx.x == 0 also write
// db[g] = sum over all T B rows of D.
template <typename W>
__global__ void __launch_bounds__(kGemmThreads)
gru_wgrad_kernel(const W* __restrict__ dhp,   // (T B, 3H)
                 const float* __restrict__ hs, // (T B, H)
                 float* __restrict__ dw,       // (3H, H)
                 float* __restrict__ db,       // (3H)
                 int rows, int B, int H) {
  __shared__ __align__(16) float a_s[kTileK][kTileM];
  __shared__ __align__(16) float b_s[kTileK][kTileN];
  __shared__ float red_s[4][kTileM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int h3 = 3 * H;
  const int kr = tid / 16, kc = (tid % 16) * 4;  // this thread's loads
  const int gemm_rows = rows - B;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (int r0 = 0; r0 < gemm_rows; r0 += kTileK) {
    const int r = r0 + kr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + kc + q, n = n0 + kc + q;
      a_s[kr][kc + q] = (r < gemm_rows && m < h3)
          ? to_f32(dhp[static_cast<size_t>(r + B) * h3 + m]) : 0.f;
      b_s[kr][kc + q] = (r < gemm_rows && n < H)
          ? as_operand(hs[static_cast<size_t>(r) * H + n], dhp) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= h3) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < H) dw[static_cast<size_t>(m) * H + n] = acc[i][jj];
    }
  }

  if (blockIdx.x != 0) return;
  // db: 4 row groups of 64 threads, then the groups in order
  const int grp = tid / kTileM, col = tid % kTileM, m = m0 + col;
  float s = 0.f;
  if (m < h3)
    for (int r = grp; r < rows; r += 4)
      s += to_f32(dhp[static_cast<size_t>(r) * h3 + m]);
  red_s[grp][col] = s;
  __syncthreads();
  if (tid < kTileM && m0 + tid < h3)
    db[m0 + tid] = ((red_s[0][tid] + red_s[1][tid]) + red_s[2][tid]) +
                   red_s[3][tid];
}

// ---------------- the persistent sweep (bf16 weights) ----------------

constexpr int kSThreads = 256;  // 8 warps
constexpr int kSUnits = 8;      // hidden units per octet
constexpr int kSStages = 4;     // cp.async ring depth for dhp[t+1] chunks
constexpr int kSPad = 8;        // bf16 padding per shared row (16 bytes)
constexpr int kSMaxBatch = 256;
constexpr int kSStageBytes = 30 * 1024;  // a ring stage holds at most this

// How a launch splits its work, from B and H alone (the host computes it
// and passes the fields; every block sees the same numbers).
struct SweepPlan {
  int groups;  // batch groups: blocks along the batch (1 or 2)
  int octets;  // unit octets per block (= groups): 8 * octets units
  int mt;      // 16-row batch tiles of a group (<= 8)
  int mw;      // warps along M (1, 2, 4 or 8): one tile each, mt <= mw
  int kw;      // warps along K: 8 / mw
  int kc;      // K chunk of dhp[t+1] staged per ring stage (multiple of 32)
  int stages;  // ring stages allocated (min(kSStages, chunks))
};

SweepPlan make_sweep_plan(int B, int H) {
  SweepPlan p;
  const int tiles = (B + 15) / 16;
  // past one tile, two blocks split the batch and each owns 16 units:
  // every block then reads half of dhp[t+1] per step
  p.groups = tiles > 1 ? 2 : 1;
  p.octets = p.groups;
  p.mt = (tiles + p.groups - 1) / p.groups;
  p.mw = 1;
  while (p.mw < p.mt) p.mw *= 2;
  p.kw = 8 / p.mw;
  // the widest chunk whose stage fits kSStageBytes: 928 columns at 16
  // rows, 448 at 32, 96 at 128
  p.kc = (kSStageBytes / 2 / (16 * p.mt) - kSPad) / 32 * 32;
  if (p.kc > 3 * H) p.kc = 3 * H;
  const int chunks = (3 * H + p.kc - 1) / p.kc;
  p.stages = chunks < kSStages ? chunks : kSStages;
  return p;
}

size_t sweep_smem_bytes(const SweepPlan& p, int H) {
  return static_cast<size_t>(kSUnits * p.octets) * (3 * H + kSPad) * 2 +
         static_cast<size_t>(p.stages) * p.mt * 16 * (p.kc + kSPad) * 2 +
         static_cast<size_t>(p.kw - 1) * p.mw * p.octets * 128 * 4;
}

template <int NO>  // unit octets per block
__global__ void __launch_bounds__(kSThreads, 1)
gru_sweep_persistent_kernel(const float* __restrict__ xp,            // (T, B, 3H)
                            const __nv_bfloat16* __restrict__ w_hh,  // (3H, H)
                            const float* __restrict__ hp,            // (T, B, 3H)
                            const float* __restrict__ hs,            // (T, B, H)
                            const int* __restrict__ qlen,            // (B)
                            const float* __restrict__ gh_final,      // (B, H)
                            float* __restrict__ dxp,                 // (T, B, 3H)
                            // (T, B, 3H): written and read by every block
                            // within the launch
                            __nv_bfloat16* dhp, unsigned int* counter,
                            int T, int B, int H, SweepPlan plan) {
  extern __shared__ uint4 sweep_smem[];
  const int h3 = 3 * H;
  __nv_bfloat16* wt_s = reinterpret_cast<__nv_bfloat16*>(sweep_smem);
  const int wt_ld = h3 + kSPad;
  __nv_bfloat16* ring = wt_s + kSUnits * NO * wt_ld;
  const int rows = plan.mt * 16;
  const int r_ld = plan.kc + kSPad;
  const int stage_elems = rows * r_ld;
  float* red = reinterpret_cast<float*>(ring + plan.stages * stage_elems);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp (wm, kg) multiplies batch tile wm over the K slices s = kg mod kw
  const int wm = warp % plan.mw, kg = warp / plan.mw;
  const bool has_tile = wm < plan.mt;  // warp-uniform
  const int unit_blocks = H / (kSUnits * NO);
  const int j0 = (blockIdx.x % unit_blocks) * kSUnits * NO;
  const int b0 = (blockIdx.x / unit_blocks) * rows;  // this block's batch rows
  const size_t step3 = static_cast<size_t>(B) * h3;

  // this block's columns of W once, as rows of W^T: unit j0 + 8 o + u at
  // shared row 8 o + u, all 3H inputs; one 16-byte load is 8 units of a
  // row of W
  for (int i = tid; i < h3 * NO; i += kSThreads) {
    const int k = i / NO, o = i % NO;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        w_hh + static_cast<size_t>(k) * H + j0 + kSUnits * o));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int u = 0; u < kSUnits; ++u) wt_s[(kSUnits * o + u) * wt_ld + k] = e[u];
  }

  // the C fragment positions this thread finishes (warps with kg == 0):
  // rows row[0] and row[0] + 8 of tile wm, units j0 + 8 o + uo and + 1;
  // element e of an octet's fragment is (row e / 2, unit e % 2)
  const bool owner = kg == 0 && has_tile;
  const int uo = (lane & 3) * 2;
  int row[2], q[2];
  float carry[NO][4], xv[NO][3][4], hv[NO][3][4], hprev[NO][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = b0 + wm * 16 + (lane >> 2) + 8 * h;
    q[h] = (owner && row[h] < B) ? qlen[row[h]] : 0;
  }
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      carry[o][e] = hprev[o][e] = 0.f;
#pragma unroll
      for (int g = 0; g < 3; ++g) xv[o][g][e] = hv[o][g][e] = 0.f;
    }
  // step t's hp, xp and h_prev (f32) of the owned elements; written before
  // the launch, so the read-only path is safe
  auto load_step = [&](int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!owner || row[h] >= B) continue;
      const size_t r3 = (static_cast<size_t>(t) * B + row[h]) * h3 + j0 + uo;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const size_t at = r3 + g * H + kSUnits * o;
          const float2 p = __ldg(reinterpret_cast<const float2*>(hp + at));
          const float2 x = __ldg(reinterpret_cast<const float2*>(xp + at));
          hv[o][g][2 * h] = p.x;
          hv[o][g][2 * h + 1] = p.y;
          xv[o][g][2 * h] = x.x;
          xv[o][g][2 * h + 1] = x.y;
        }
        float2 v = make_float2(0.f, 0.f);
        if (t > 0)
          v = __ldg(reinterpret_cast<const float2*>(
              hs + (static_cast<size_t>(t - 1) * B + row[h]) * H + j0 +
              kSUnits * o + uo));
        hprev[o][2 * h] = v.x;
        hprev[o][2 * h + 1] = v.y;
      }
    }
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!owner || row[h] >= B) continue;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(
          gh_final + static_cast<size_t>(row[h]) * H + j0 + kSUnits * o + uo));
      carry[o][2 * h] = v.x;
      carry[o][2 * h + 1] = v.y;
    }
  }
  load_step(T - 1);
  __syncthreads();  // W^T in shared memory

  const int chunks = (h3 + plan.kc - 1) / plan.kc;
  for (int t = T - 1; t >= 0; --t) {
    float acc[NO][4];  // gh's product dhp[t+1] . W[:, j], one n8 tile per octet
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;

    if (t < T - 1) {  // at t = T-1, gh is gh_final: no product
      const __nv_bfloat16* src = dhp + static_cast<size_t>(t + 1) * step3;
      auto load_chunk = [&](int c) {
        if (c < chunks) {
          const int k0 = c * plan.kc;
          const int kn = min(plan.kc, h3 - k0);
          __nv_bfloat16* dst = ring + (c % kSStages) * stage_elems;
          const int per_row = kn / 8;
          for (int i = tid; i < rows * per_row; i += kSThreads) {
            const int r = i / per_row, p = (i % per_row) * 8;
            const bool valid = b0 + r < B;
            cp_async_16(dst + r * r_ld + p,
                        src + (valid ? static_cast<size_t>(b0 + r) * h3 + k0 + p : 0),
                        valid);
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int c = 0; c < kSStages - 1; ++c) load_chunk(c);
      for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kSStages - 2>();
        __syncthreads();  // chunk c landed; stage (c-1) % kSStages is free
        load_chunk(c + kSStages - 1);
        const __nv_bfloat16* a_s = ring + (c % kSStages) * stage_elems;
        const int k0 = c * plan.kc;
        const int slices = has_tile ? min(plan.kc, h3 - k0) / 32 : 0;
        for (int s = kg; s < slices; s += plan.kw) {
          const int kk = s * 32;
          // per octet: b0, b1 of k16 step 0, then step 1
          uint32_t bf[NO][4];
#pragma unroll
          for (int o = 0; o < NO; ++o)
            ldsm_x4(bf[o], wt_s + (o * kSUnits + (lane & 7)) * wt_ld + k0 + kk +
                               (lane >> 3) * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t af[4];
            ldsm_x4(af, a_s + (wm * 16 + (lane & 15)) * r_ld + kk + h * 16 +
                            (lane >> 4) * 8);
#pragma unroll
            for (int o = 0; o < NO; ++o)
              mma_bf16(acc[o], af, bf[o][2 * h], bf[o][2 * h + 1]);
          }
        }
      }
      cp_async_wait<0>();  // only empty groups remain

      if (plan.kw > 1) {  // K-split partials, added in a fixed order
        if (kg > 0) {
          float* slot = red + ((kg - 1) * plan.mw + wm) * 128 * NO;
#pragma unroll
          for (int o = 0; o < NO; ++o)
#pragma unroll
            for (int e = 0; e < 4; ++e) slot[(o * 4 + e) * 32 + lane] = acc[o][e];
        }
        __syncthreads();
        if (kg == 0) {
          for (int k = 1; k < plan.kw; ++k) {
            const float* slot = red + ((k - 1) * plan.mw + wm) * 128 * NO;
#pragma unroll
            for (int o = 0; o < NO; ++o)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[o][e] += slot[(o * 4 + e) * 32 + lane];
          }
        }
      }
    }

    if (owner) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = row[h];
        if (b >= B) continue;
        const bool keep = t < q[h];
        const size_t r3 = (static_cast<size_t>(t) * B + b) * h3 + j0 + uo;
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          float dr_pre[2], dz_pre[2], dn_pre[2], dhn[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * h + u;
            const float gh = carry[o][e] + acc[o][e];
            const float hn = hv[o][2][e];
            const float rg = sigmoid(xv[o][0][e] + hv[o][0][e]);
            const float z = sigmoid(xv[o][1][e] + hv[o][1][e]);
            const float n = tanhf(xv[o][2][e] + rg * hn);
            const float g_new = keep ? gh : 0.f;
            const float pass = keep ? 0.f : gh;
            const float dz = g_new * (hprev[o][e] - n);
            const float dn = g_new * (1.f - z);
            dn_pre[u] = dn * (1.f - n * n);
            const float dr = dn_pre[u] * hn;
            dhn[u] = dn_pre[u] * rg;
            dr_pre[u] = dr * rg * (1.f - rg);
            dz_pre[u] = dz * z * (1.f - z);
            carry[o][e] = pass + g_new * z;
          }
          const size_t at = r3 + kSUnits * o;
          *reinterpret_cast<__nv_bfloat162*>(dhp + at) =
              __floats2bfloat162_rn(dr_pre[0], dr_pre[1]);
          *reinterpret_cast<__nv_bfloat162*>(dhp + at + H) =
              __floats2bfloat162_rn(dz_pre[0], dz_pre[1]);
          *reinterpret_cast<__nv_bfloat162*>(dhp + at + 2 * H) =
              __floats2bfloat162_rn(dhn[0], dhn[1]);
          *reinterpret_cast<float2*>(dxp + at) = make_float2(dr_pre[0], dr_pre[1]);
          *reinterpret_cast<float2*>(dxp + at + H) = make_float2(dz_pre[0], dz_pre[1]);
          *reinterpret_cast<float2*>(dxp + at + 2 * H) = make_float2(dn_pre[0], dn_pre[1]);
        }
      }
    }
    if (t > 0) {
      load_step(t - 1);  // in flight across the barrier
      grid_barrier(counter, static_cast<unsigned int>(T - t) * gridDim.x);
    }
  }
}

template <int NO>
cudaError_t launch_sweep(const float* xp, const __nv_bfloat16* w,
                         const float* hp, const float* hs, const int* qlen,
                         const float* gh, float* dxp, __nv_bfloat16* dhp,
                         unsigned int* counter, int T, int B, int H,
                         const SweepPlan& plan, cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes(plan, H);
  auto kernel = gru_sweep_persistent_kernel<NO>;
  const int blocks = H / (kSUnits * NO) * plan.groups;
  cudaError_t e = check_coresident(kernel, kSThreads, smem, blocks);
  if (e != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(counter, 0, sizeof(unsigned int), stream)) != cudaSuccess)
    return e;
  SweepPlan p = plan;
  void* args[] = {&xp, &w, &hp, &hs, &qlen, &gh, &dxp, &dhp, &counter,
                  &T, &B, &H, &p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(blocks), dim3(kSThreads), args,
                                     smem, stream);
}

template <typename W>
cudaError_t run_step(const float* xp_t, const void* w_hh, const void* w_t,
                     const float* b_hh, const int* qlen, const float* h_prev,
                     const void* dhp_next, const float* carry_in,
                     float* dxp_t, void* dhp_t, float* carry_out, int B,
                     int H, int t, cudaStream_t stream) {
  const size_t smem = step_smem_bytes(H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_bwd_step_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(H / kWarps, (B + kRows - 1) / kRows);
  gru_bwd_step_kernel<W><<<grid, kWarps * 32, smem, stream>>>(
      xp_t, static_cast<const W*>(w_hh), static_cast<const W*>(w_t), b_hh,
      qlen, h_prev, static_cast<const W*>(dhp_next), carry_in, dxp_t,
      static_cast<W*>(dhp_t), carry_out, B, H, t);
  return cudaGetLastError();
}

}  // namespace

// One reverse step t. xp_t (B, 3H) f32; w_hh (3H, H) and w_t = its
// transpose (H, 3H), both f32 (dtype 0) or bf16 (dtype 1); b_hh (3H) f32;
// qlen (B) int32; h_prev = hs[t-1] (B, H) f32, null at t=0; dhp_next =
// dhp[t+1] (B, 3H) in W's dtype, null at t=T-1; carry_in (B, H) f32: the
// gradient of h_out[T-1] at t=T-1, else the carry_out of step t+1. Writes
// dxp_t (B, 3H) f32, dhp_t (B, 3H) in W's dtype and carry_out (B, H) f32.
// Needs H % 8 == 0 and H <= 3632. Returns cudaError_t.
extern "C" int gru_scan_bwd_step(const void* xp_t, const void* w_hh,
                                 const void* w_t, const void* b_hh,
                                 const void* qlen, const void* h_prev,
                                 const void* dhp_next, const void* carry_in,
                                 void* dxp_t, void* dhp_t, void* carry_out,
                                 int B, int H, int t, int dtype,
                                 void* stream) {
  if (B <= 0 || H <= 0 || H % 8 != 0 || (B + kRows - 1) / kRows > 65535 ||
      step_smem_bytes(H) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xp_t);
  const float* bias = static_cast<const float*>(b_hh);
  const int* q = static_cast<const int*>(qlen);
  const float* hp = static_cast<const float*>(h_prev);
  const float* cin = static_cast<const float*>(carry_in);
  float* dx = static_cast<float*>(dxp_t);
  float* cout = static_cast<float*>(carry_out);
  cudaError_t e;
  if (dtype == 0)
    e = run_step<float>(x, w_hh, w_t, bias, q, hp, dhp_next, cin, dx, dhp_t,
                        cout, B, H, t, s);
  else if (dtype == 1)
    e = run_step<__nv_bfloat16>(x, w_hh, w_t, bias, q, hp, dhp_next, cin, dx,
                                dhp_t, cout, B, H, t, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The persistent sweep, all T reverse steps in one cooperative launch.
// xp (T, B, 3H) f32; w_hh (3H, H) bf16; hp (T, B, 3H) f32: kernel B's
// h_prev @ W^T + b of every step (gru_scan_persistent's hp); hs (T, B, H)
// f32 states; qlen (B) int32; gh_final (B, H) f32. Writes dxp (T, B, 3H)
// f32 and dhp (T, B, 3H) bf16; counter: one unsigned int of scratch
// (zeroed here, on the stream). Needs 1 <= B <= 256, H % 64 == 0,
// H <= 1024 and the H / 8 blocks resident together (else
// cudaErrorCooperativeLaunchTooLarge, before anything is launched).
// Returns cudaError_t.
extern "C" int gru_scan_bwd_persistent(const void* xp, const void* w_hh,
                                       const void* hp, const void* hs,
                                       const void* qlen, const void* gh_final,
                                       void* dxp, void* dhp, void* counter,
                                       int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || B > kSMaxBatch || H <= 0 || H % 64 != 0 ||
      H > 1024 || !xp || !w_hh || !hp || !hs || !qlen || !gh_final || !dxp ||
      !dhp || !counter)
    return static_cast<int>(cudaErrorInvalidValue);
  const SweepPlan plan = make_sweep_plan(B, H);
  const auto* x = static_cast<const float*>(xp);
  const auto* w = static_cast<const __nv_bfloat16*>(w_hh);
  const auto* pre = static_cast<const float*>(hp);
  const auto* all = static_cast<const float*>(hs);
  const auto* q = static_cast<const int*>(qlen);
  const auto* g = static_cast<const float*>(gh_final);
  auto* dx = static_cast<float*>(dxp);
  auto* dh = static_cast<__nv_bfloat16*>(dhp);
  auto* c = static_cast<unsigned int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      plan.octets == 2
          ? launch_sweep<2>(x, w, pre, all, q, g, dx, dh, c, T, B, H, plan, s)
          : launch_sweep<1>(x, w, pre, all, q, g, dx, dh, c, T, B, H, plan, s);
  return static_cast<int>(e);
}

// dhp (T, B, 3H) in W's dtype (0 = f32, 1 = bf16) and hs (T, B, H) f32 ->
// dw (3H, H) f32 and db (3H) f32. One launch. Returns cudaError_t.
extern "C" int gru_wgrad(const void* dhp, const void* hs, void* dw, void* db,
                         int T, int B, int H, int dtype, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || (3 * H + kTileM - 1) / kTileM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + kTileN - 1) / kTileN, (3 * H + kTileM - 1) / kTileM);
  const float* h = static_cast<const float*>(hs);
  float* w = static_cast<float*>(dw);
  float* bb = static_cast<float*>(db);
  if (dtype == 0)
    gru_wgrad_kernel<float><<<grid, kGemmThreads, 0, s>>>(
        static_cast<const float*>(dhp), h, w, bb, T * B, B, H);
  else if (dtype == 1)
    gru_wgrad_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dhp), h, w, bb, T * B, B, H);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
