// Backward of the GRU recurrence (kernel E) for Hopper (sm_90a): the
// reverse-time sweep and the hidden-weight gradient.
//
// Replaces the TPU kernel vqa_project_tpu/ops/pallas/gru_scan.py
// ::_gru_bwd_kernel (the VJP of pallas_gru; same numbers as its default
// _bwd_xla_reference). With gh the gradient reaching h_out at step t:
//
//   hp = h_prev @ W^T + b (recomputed, h_prev cast to W's dtype, f32 sum)
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
// What bounds it on an H100: bytes and the T dependent steps, as in the
// forward (csrc/gru_scan.cu): every step needs all of W_hh twice (the
// recompute of hp and the product dhp @ W), 12.6 MB in bf16 at H=1024,
// against a small (B, 3H) state. The weight gradient is a (3H, H) x
// (T B) product, bound by operations at large B.
//
// Design. gru_bwd_step_kernel: one launch per step, from T-1 down to 0,
// in the forward kernel's layout: a block owns kWarps hidden units j and
// kRows batch rows; each warp owns one unit, its lanes split the
// reduction 4-wide (coalesced weight rows, conflict-free shared-memory
// reads) and a butterfly of shuffles gives every lane the totals. The
// product dhp @ W that finishes gh needs the whole 3H-wide dhp row of
// the step after, which no block of that step's launch held, so launch t
// first completes gh for its units from the dhp that launch t+1 wrote:
// gh = carry + dhp_next . W[:, j], reading column j of W as row j of a
// transposed copy W^T (H, 3H) so the loads stay coalesced; carry =
// pass + g_new z is what launch t+1 left for it. It then recomputes hp
// for its units from h_prev = hs[t-1] (zeros at t=0), staged once in
// shared memory like the forward's h tile, and applies the gate algebra
// and the qlen freeze in the lane that owns the row. Nothing but dxp,
// dhp and the (B, H) carry leaves the chip.
//
// gru_wgrad_kernel: the TPU kernel accumulates dW in VMEM across its
// sweep; here it is one tiled reduction after the sweep over the stacked
// dhp (T, B, 3H) and hs: 64 x 64 output tiles, rows of both operands
// staged 16 at a time in shared memory, 4 x 4 f32 accumulators per
// thread. h_prev is rounded to W's dtype as the product sees it. The
// tiles of the first column also sum db over all rows, in a fixed order.
// No atomics: a run is repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
