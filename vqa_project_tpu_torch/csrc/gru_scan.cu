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
// What bounds it on an H100: the latency of the T dependent steps, and
// bytes. Every step needs all of W_hh (3H x H: 6.3 MB in bf16 at
// H=1024) against a small h (B x H); at B=16 that is ~2 flops per weight
// byte. The TPU kernel kept W_hh resident in its VMEM across steps; no
// single SM can hold it (227 KB of shared memory), but the card's 132
// SMs together can, one slice each.
//
// Two kernels; ops/gru_scan.py::scan_kernel is the rule that picks one
// from (weight dtype, B, H).
//
// gru_persistent_kernel (bf16 weights, 1 <= B <= 256, H % 64 == 0,
// H <= 1024; entry gru_scan_persistent): one cooperative launch for all
// T steps, the TPU kernel's design carried over. Each of the H/8 blocks
// (128 at H=1024, one per SM) owns 8 hidden units and every batch row;
// past 128 rows two blocks split the batch and each owns 16 units, so
// that a block reads half of h_prev per step. A block loads its units'
// rows of W_hh (r, z, n: 48 or 96 KB in bf16) into shared memory once;
// they stay there for every step, rows padded by 16 bytes so that
// ldmatrix reads them without bank conflicts. Per step the block streams
// its rows of h_prev in bf16 (written by every block in the step before)
// from L2 in K-chunks through a 4-stage cp.async ring and multiplies on
// the tensor cores with mma.sync.m16n8k16 (bf16 in, f32 sum): M is the
// batch in 16-row tiles, N is three n8 tiles (r, z, n) per 8 units, and
// K is split across the warps that M leaves free. The three n8 tiles give
// a thread the r, z and n sums of the same (row, unit) in the same
// registers, so the gate math, the qlen freeze and h itself (f32,
// carried in registers from step to step) never leave the chip. The
// K-split partials are added through shared memory in a fixed order,
// so runs repeat bit for bit. The block writes h_t in bf16 (the next
// step's operand: hs16[t] in training, else one of two ping-pong
// buffers) and, in training, in f32 to hs[t]; inference writes only the
// final state in f32. Training may also ask for hp[t] = h_prev @ W_hh^T +
// b_hh in f32, every row (12.6 MB at B=64, T=16, H=1024): the sums are
// already in the C fragments, and kernel E's persistent sweep
// (csrc/gru_scan_bwd.cu) reads them instead of recomputing the product,
// which leaves it only W's columns to hold. Before a step's grid barrier the block loads the
// next step's xp for its units. Steps are separated by a grid barrier
// on a global counter (release add, acquire loads); the launch is
// cooperative, and the entry refuses a grid that cannot be resident all
// at once rather than let the barrier deadlock. h_prev is read with
// cp.async.cg (L2 only): other blocks wrote it during this launch, so no
// load may go through the non-coherent L1/texture path. wgmma is not
// used here: its 64-row minimum would leave three quarters of the tile
// empty at the serving batch of 16, and this kernel is bound by the
// latency of the T dependent steps, not by operations.
//
// gru_step_kernel (f32 weights, and any shape the persistent kernel
// cannot hold; entry gru_scan_fwd): exact f32 on the SIMT cores, one
// launch per time step (T launches ordered on one stream;
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

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

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

// ---------------- the persistent kernel (bf16 weights) ----------------

constexpr int kPThreads = 256;  // 8 warps
constexpr int kUnits = 8;       // hidden units per octet
constexpr int kStages = 4;      // cp.async ring depth for h_prev chunks
constexpr int kPad = 8;         // bf16 padding per shared row (16 bytes)
constexpr int kMaxBatch = 256;

// How a launch splits its work, from B and H alone (the host computes it
// and passes the fields; every block sees the same numbers).
struct Plan {
  int groups;  // batch groups: blocks along the batch (1 or 2)
  int octets;  // unit octets per block (1 or 2): 8 * octets units
  int mt;      // 16-row batch tiles of a group
  int mw;      // warps along M (1, 2, 4 or 8): one tile each, mt <= mw
  int kw;      // warps along K: 8 / mw
  int kc;      // K chunk of h_prev staged per ring stage
  int stages;  // ring stages allocated (min(kStages, chunks))
};

Plan make_plan(int B, int H) {
  Plan p;
  p.mt = (B + 15) / 16;
  // past 8 tiles, two blocks split the batch and each owns 16 units:
  // every block then reads half of h_prev per step
  p.groups = p.mt > 8 ? 2 : 1;
  p.octets = p.groups;
  p.mt = (p.mt + p.groups - 1) / p.groups;
  p.mw = 1;
  while (p.mw < p.mt && p.mw < 8) p.mw *= 2;
  p.kw = 8 / p.mw;
  // ~32 KB per stage: the whole h_prev at B=16, 4 chunks at B=64
  p.kc = 64 * (256 / (16 * p.mt) > 1 ? 256 / (16 * p.mt) : 1) / p.octets;
  if (p.kc > H) p.kc = H;
  const int chunks = (H + p.kc - 1) / p.kc;
  p.stages = chunks < kStages ? chunks : kStages;
  return p;
}

size_t persistent_smem_bytes(const Plan& p, int H) {
  return static_cast<size_t>(3 * kUnits * p.octets) * (H + kPad) * 2 +
         static_cast<size_t>(p.stages) * p.mt * 16 * (p.kc + kPad) * 2 +
         static_cast<size_t>(p.kw - 1) * p.mw * p.octets * 384 * 4;
}

template <int NO>  // unit octets per block
__global__ void __launch_bounds__(kPThreads, 1)
gru_persistent_kernel(const float* __restrict__ xp,            // (T, B, 3H)
                      const __nv_bfloat16* __restrict__ w_hh,  // (3H, H)
                      const float* __restrict__ b_hh,          // (3H)
                      const int* __restrict__ qlen,            // (B)
                      float* __restrict__ h_out,  // (B, H) or null
                      float* __restrict__ hs,     // (T, B, H) or null
                      float* __restrict__ hp,     // (T, B, 3H) or null
                      // (T, B, H) with hs, else (2, B, H): written and
                      // read by every block within the launch
                      __nv_bfloat16* h16, unsigned int* counter, int T,
                      int B, int H, Plan plan) {
  extern __shared__ uint4 smem4[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int w_ld = H + kPad;
  __nv_bfloat16* ring = w_s + 3 * kUnits * NO * w_ld;
  const int rows = plan.mt * 16;
  const int r_ld = plan.kc + kPad;
  const int stage_elems = rows * r_ld;
  float* red = reinterpret_cast<float*>(ring + plan.stages * stage_elems);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp (wm, kg) multiplies batch tile wm over the K slices s = kg mod kw
  const int wm = warp % plan.mw, kg = warp / plan.mw;
  const bool has_tile = wm < plan.mt;  // warp-uniform
  const int unit_blocks = H / (kUnits * NO);
  const int j0 = (blockIdx.x % unit_blocks) * kUnits * NO;
  const int b0 = (blockIdx.x / unit_blocks) * rows;  // this block's batch rows
  const int h3 = 3 * H;
  const size_t step = static_cast<size_t>(B) * H;

  // this block's weight rows once: octet o, gate g, unit u at shared row
  // (3 o + g) 8 + u (r, z, n of units j0 + 8 o + u)
  for (int i = tid; i < 3 * kUnits * NO * (H / 8); i += kPThreads) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8;
    const int o = r / (3 * kUnits), g = (r / kUnits) % 3, u = r % kUnits;
    *reinterpret_cast<uint4*>(w_s + r * w_ld + c) = __ldg(reinterpret_cast<const uint4*>(
        w_hh + static_cast<size_t>(g * H + j0 + kUnits * o + u) * H + c));
  }

  // the C fragment positions this thread finishes (warps with kg == 0):
  // rows row[0] and row[0] + 8 of tile wm, units j0 + 8 o + uo and + 1;
  // element e of a gate's fragment is (row e / 2, unit e % 2)
  const int uo = (lane & 3) * 2;
  int row[2], q[2];
  float hreg[NO][4], xv[NO][3][4], bias[NO][3][2];
#pragma unroll
  for (int o = 0; o < NO; ++o) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[o][g][e] = b_hh[g * H + j0 + kUnits * o + uo + e];
#pragma unroll
    for (int e = 0; e < 4; ++e) hreg[o][e] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = b0 + wm * 16 + (lane >> 2) + 8 * h;
    q[h] = row[h] < B ? qlen[row[h]] : 0;
  }
  auto load_xp = [&](int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kg != 0 || !has_tile || row[h] >= B) continue;
      const float* x = xp + (static_cast<size_t>(t) * B + row[h]) * h3 + j0 + uo;
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(x + g * H + kUnits * o));
          xv[o][g][2 * h] = v.x;
          xv[o][g][2 * h + 1] = v.y;
        }
    }
  };
  load_xp(0);
  __syncthreads();

  const int chunks = (H + plan.kc - 1) / plan.kc;
  for (int t = 0; t < T; ++t) {
    float acc[3 * NO][4];  // (octet, gate) n8 tiles of this warp's tile
#pragma unroll
    for (int g = 0; g < 3 * NO; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

    if (t > 0) {  // at t = 0, h_prev = 0 and the product is 0
      const __nv_bfloat16* src =
          h16 + (hs ? static_cast<size_t>(t - 1) : static_cast<size_t>((t - 1) & 1)) * step;
      auto load_chunk = [&](int c) {
        if (c < chunks) {
          const int k0 = c * plan.kc;
          const int kn = min(plan.kc, H - k0);
          __nv_bfloat16* dst = ring + (c % kStages) * stage_elems;
          const int per_row = kn / 8;
          for (int i = tid; i < rows * per_row; i += kPThreads) {
            const int r = i / per_row, p = (i % per_row) * 8;
            const bool valid = b0 + r < B;
            cp_async_16(dst + r * r_ld + p,
                        src + (valid ? static_cast<size_t>(b0 + r) * H + k0 + p : 0),
                        valid);
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int c = 0; c < kStages - 1; ++c) load_chunk(c);
      for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk c landed; stage (c-1) % kStages is free
        load_chunk(c + kStages - 1);
        const __nv_bfloat16* a_s = ring + (c % kStages) * stage_elems;
        const int k0 = c * plan.kc;
        const int slices = has_tile ? min(plan.kc, H - k0) / 32 : 0;
        for (int s = kg; s < slices; s += plan.kw) {
          const int kk = s * 32;
          // per (octet, gate): b0, b1 of k16 step 0, then step 1
          uint32_t bf[3 * NO][4];
#pragma unroll
          for (int g = 0; g < 3 * NO; ++g)
            ldsm_x4(bf[g], w_s + (g * kUnits + (lane & 7)) * w_ld + k0 + kk +
                               (lane >> 3) * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t af[4];
            ldsm_x4(af, a_s + (wm * 16 + (lane & 15)) * r_ld + kk + h * 16 +
                            (lane >> 4) * 8);
#pragma unroll
            for (int g = 0; g < 3 * NO; ++g)
              mma_bf16(acc[g], af, bf[g][2 * h], bf[g][2 * h + 1]);
          }
        }
      }
      cp_async_wait<0>();  // only empty groups remain

      if (plan.kw > 1) {  // K-split partials, added in a fixed order
        if (kg > 0) {
          float* slot = red + ((kg - 1) * plan.mw + wm) * 384 * NO;
#pragma unroll
          for (int g = 0; g < 3 * NO; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) slot[(g * 4 + e) * 32 + lane] = acc[g][e];
        }
        __syncthreads();
        if (kg == 0) {
          for (int k = 1; k < plan.kw; ++k) {
            const float* slot = red + ((k - 1) * plan.mw + wm) * 384 * NO;
#pragma unroll
            for (int g = 0; g < 3 * NO; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[g][e] += slot[(g * 4 + e) * 32 + lane];
          }
        }
      }
    }

    if (kg == 0 && has_tile) {
      __nv_bfloat16* d16 =
          h16 + (hs ? static_cast<size_t>(t) : static_cast<size_t>(t & 1)) * step;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = row[h];
        if (b >= B) continue;
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          float out[2], pre[3][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * h + u;
#pragma unroll
            for (int g = 0; g < 3; ++g) pre[g][u] = acc[3 * o + g][e] + bias[o][g][u];
            const float h_prev = hreg[o][e];
            float h_new = h_prev;
            if (t < q[h]) {
              const float rg = sigmoid(xv[o][0][e] + pre[0][u]);
              const float z = sigmoid(xv[o][1][e] + pre[1][u]);
              const float n = tanhf(xv[o][2][e] + rg * pre[2][u]);
              h_new = (1.f - z) * n + z * h_prev;
            }
            hreg[o][e] = h_new;
            out[u] = h_new;
          }
          if (hp) {  // the sweep's hp: every row, frozen or not
#pragma unroll
            for (int g = 0; g < 3; ++g)
              *reinterpret_cast<float2*>(
                  hp + (static_cast<size_t>(t) * B + b) * h3 + g * H + j0 +
                  kUnits * o + uo) = make_float2(pre[g][0], pre[g][1]);
          }
          const size_t at = static_cast<size_t>(b) * H + j0 + kUnits * o + uo;
          *reinterpret_cast<__nv_bfloat162*>(d16 + at) = __floats2bfloat162_rn(out[0], out[1]);
          if (hs)
            *reinterpret_cast<float2*>(hs + t * step + at) = make_float2(out[0], out[1]);
          else if (t == T - 1)
            *reinterpret_cast<float2*>(h_out + at) = make_float2(out[0], out[1]);
        }
      }
    }
    if (t + 1 < T) {
      load_xp(t + 1);  // in flight across the barrier
      grid_barrier(counter, static_cast<unsigned int>(t + 1) * gridDim.x);
    }
  }
}

template <int NO>
cudaError_t launch_persistent(const float* xp, const __nv_bfloat16* w,
                              const float* b_hh, const int* qlen,
                              float* h_out, float* hs, float* hp,
                              __nv_bfloat16* h16, unsigned int* counter,
                              int T, int B, int H, const Plan& plan,
                              cudaStream_t stream) {
  const size_t smem = persistent_smem_bytes(plan, H);
  auto kernel = gru_persistent_kernel<NO>;
  const int blocks = H / (kUnits * NO) * plan.groups;
  cudaError_t e = check_coresident(kernel, kPThreads, smem, blocks);
  if (e != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(counter, 0, sizeof(unsigned int), stream)) != cudaSuccess)
    return e;
  Plan p = plan;
  void* args[] = {&xp, &w, &b_hh, &qlen, &h_out, &hs, &hp, &h16, &counter,
                  &T, &B, &H, &p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(blocks), dim3(kPThreads), args,
                                     smem, stream);
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

// The persistent kernel: xp (T, B, 3H) f32; w_hh (3H, H) bf16; b_hh (3H)
// f32; qlen (B) int32; counter: one unsigned int of scratch (zeroed
// here, on the stream). Training (hs a (T, B, H) f32 buffer): writes
// every step's state to hs and its bf16 rounding to h16 (T, B, H);
// h_out is not used; with hp a (T, B, 3H) f32 buffer it also writes every
// step's hidden-side products h_prev @ W_hh^T + b_hh there (the input of
// kernel E's persistent sweep). Inference (hs and hp null): h16 is
// (2, B, H) bf16 scratch and the final state goes to h_out (B, H) f32.
// Needs 1 <= B <= 256, H % 64 == 0, H <= 1024, and the H / 8 blocks
// resident together (else cudaErrorCooperativeLaunchTooLarge, before
// anything is launched). One cooperative launch. Returns cudaError_t.
extern "C" int gru_scan_persistent(const void* xp, const void* w_hh,
                                   const void* b_hh, const void* qlen,
                                   void* h_out, void* hs, void* hp,
                                   void* h16, void* counter, int T, int B,
                                   int H, void* stream) {
  if (T <= 0 || B <= 0 || B > kMaxBatch || H <= 0 || H % 64 != 0 ||
      H > 1024 || (hs == nullptr && h_out == nullptr) ||
      (hp != nullptr && hs == nullptr) || h16 == nullptr ||
      counter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(B, H);
  const auto* x = static_cast<const float*>(xp);
  const auto* w = static_cast<const __nv_bfloat16*>(w_hh);
  const auto* bias = static_cast<const float*>(b_hh);
  const auto* q = static_cast<const int*>(qlen);
  auto* out = static_cast<float*>(h_out);
  auto* all = static_cast<float*>(hs);
  auto* pre = static_cast<float*>(hp);
  auto* h = static_cast<__nv_bfloat16*>(h16);
  auto* c = static_cast<unsigned int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      plan.octets == 2
          ? launch_persistent<2>(x, w, bias, q, out, all, pre, h, c, T, B, H, plan, s)
          : launch_persistent<1>(x, w, bias, q, out, all, pre, h, c, T, B, H, plan, s);
  return static_cast<int>(e);
}
