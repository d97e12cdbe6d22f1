// GRU recurrence (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel vqa_project_tpu/ops/pallas/gru_scan.py
// ::_gru_kernel (entries pallas_gru / gru_encode_pallas). Per step t:
//
//   hp = h_prev @ W_hh^T + b_hh          (h_prev cast to W's dtype, f32 sum)
//   r = sigmoid(xr + hr)  z = sigmoid(xz + hz)  n = tanh(xn + r * hn)
//   h = (1 - z) * n + z * h_prev;  h_out = t < qlen[b] ? h : h_prev
//
// with gate order [r; z; n] and xp = emb @ W_ih^T + b_ih precomputed
// outside (a plain GEMM, as on the TPU).
//
// What bounds it on an H100: bytes, and the latency of the T dependent
// steps. Every step needs all of W_hh (3H x H: 6.3 MB in bf16 at
// H=1024) against a small h (B x H); at B=16 that is ~2 flops per weight
// byte. The TPU kernel kept W_hh resident in its VMEM across steps;
// one SM has 227 KB of shared memory, so here the weights are
// streamed every step instead (they fit the 50 MB L2, which serves the
// re-reads after the first step).
//
// Design: one launch per time step (T launches ordered on one stream;
// inference ping-pongs h between two f32 buffers, training writes every
// step's h to hs (T, B, H), which the backward sweep reads,
// csrc/gru_scan_bwd.cu).
// A block owns kWarps hidden units and a tile of kRows batch rows. It
// first stages its whole (kRows, H) h_prev tile in shared memory, already
// rounded to W's dtype, with all 16-byte loads in flight together. Each
// warp then owns one unit j; its lanes split the reduction axis, lane l
// taking inputs 4l..4l+3 of every 128, so the rows j, H+j and 2H+j of
// W_hh (contiguous in the torch (3H, H) layout) stream in as coalesced
// loads and the shared-memory reads are conflict-free. Each lane keeps
// 3 x kRows f32 partial sums, reduced across the warp by shuffles; lane
// r then applies the gate math and the qlen freeze for batch row r, so
// no pre-activation leaves the chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // hidden units per block: one per warp
// batch rows per block: small tiles keep many blocks in flight at the
// serving batch (B=16 gives 4 x 128 blocks); larger B re-reads W_hh
// from L2 once per tile
constexpr int kRows = 4;

// 4 consecutive weights as f32, from one 8-byte (bf16) or 16-byte load
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

// h_prev as the product sees it: rounded to the weight dtype
__device__ __forceinline__ float as_operand(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float as_operand(float x, const float*) { return x; }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

size_t smem_bytes(int H) { return static_cast<size_t>(kRows) * H * sizeof(float); }

template <typename W>
__global__ void __launch_bounds__(kWarps * 32)
gru_step_kernel(const float* __restrict__ xp_t,    // (B, 3H) this step
                const W* __restrict__ w_hh,        // (3H, H)
                const float* __restrict__ b_hh,    // (3H)
                const int* __restrict__ qlen,      // (B)
                const float* __restrict__ h_prev,  // (B, H)
                float* __restrict__ h_next,        // (B, H)
                int B, int H, int t) {
  extern __shared__ float4 h_s4[];  // (kRows, H) h_prev tile, as operands
  const float* h_s = reinterpret_cast<const float*>(h_s4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kRows;
  const int j = blockIdx.x * kWarps + warp;  // H % kWarps == 0

  // stage the whole tile at once: independent 16-byte loads in flight
  const int n4 = kRows * H / 4;
  const float4* src = reinterpret_cast<const float4*>(h_prev) +
                      static_cast<size_t>(b0) * H / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b0 + (4 * i) / H < B) v = src[i];
    v.x = as_operand(v.x, w_hh); v.y = as_operand(v.y, w_hh);
    v.z = as_operand(v.z, w_hh); v.w = as_operand(v.w, w_hh);
    h_s4[i] = v;
  }
  __syncthreads();

  float acc[3][kRows];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.f;

  // lane takes inputs k..k+3 of every 128: coalesced weight loads and
  // conflict-free 16-byte shared-memory reads
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

  // butterfly sums: every lane ends with all 3 x kRows totals
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);

  // lane r finishes batch row b0 + r (static indexing keeps acc in registers)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (lane != r || b >= B) continue;
    const float hp = h_prev[static_cast<size_t>(b) * H + j];
    float h_out = hp;
    if (t < qlen[b]) {
      const float* x = xp_t + static_cast<size_t>(b) * 3 * H;
      const float rg = sigmoid(x[j] + (acc[0][r] + b_hh[j]));
      const float z = sigmoid(x[H + j] + (acc[1][r] + b_hh[H + j]));
      const float n = tanhf(x[2 * H + j] + rg * (acc[2][r] + b_hh[2 * H + j]));
      h_out = (1.f - z) * n + z * hp;
    }
    h_next[static_cast<size_t>(b) * H + j] = h_out;
  }
}

template <typename W>
cudaError_t run(const float* xp, const void* w_hh, const float* b_hh,
                const int* qlen, float* h_a, float* h_b, float* hs, int T,
                int B, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes(H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_step_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(H / kWarps, (B + kRows - 1) / kRows);
  const size_t step = static_cast<size_t>(B) * H;
  for (int t = 0; t < T; ++t) {
    // training keeps every step's state in hs[t] (h0 = the zeros in h_a);
    // inference ping-pongs between h_a and h_b
    const float* src = hs ? (t == 0 ? h_a : hs + (t - 1) * step)
                          : ((t % 2 == 0) ? h_a : h_b);
    float* dst = hs ? hs + t * step : ((t % 2 == 0) ? h_b : h_a);
    gru_step_kernel<W><<<grid, kWarps * 32, smem, stream>>>(
        xp + static_cast<size_t>(t) * B * 3 * H, static_cast<const W*>(w_hh),
        b_hh, qlen, src, dst, B, H, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// xp (T, B, 3H) f32; w_hh (3H, H) f32 (dtype 0) or bf16 (dtype 1);
// b_hh (3H) f32; qlen (B) int32; h_a holds h0 (zeros). With hs null the
// two (B, H) f32 buffers h_a and h_b alternate and the final state is in
// h_a when T is even, else in h_b; with hs a (T, B, H) f32 buffer, step t
// writes hs[t] (the final state is hs[T-1]) and h_b is not used. Needs
// H % 8 == 0 and H <= 3632 (the h_prev tile lives in shared memory).
// Launches T kernels. Returns cudaError_t.
extern "C" int gru_scan_fwd(const void* xp, const void* w_hh,
                            const void* b_hh, const void* qlen, void* h_a,
                            void* h_b, void* hs, int T, int B, int H,
                            int dtype, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % 8 != 0 ||
      (B + kRows - 1) / kRows > 65535 || smem_bytes(H) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xp);
  const float* bias = static_cast<const float*>(b_hh);
  const int* q = static_cast<const int*>(qlen);
  float* a = static_cast<float*>(h_a);
  float* b = static_cast<float*>(h_b);
  float* all = static_cast<float*>(hs);
  cudaError_t e;
  if (dtype == 0)
    e = run<float>(x, w_hh, bias, q, a, b, all, T, B, H, s);
  else if (dtype == 1)
    e = run<__nv_bfloat16>(x, w_hh, bias, q, a, b, all, T, B, H, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
