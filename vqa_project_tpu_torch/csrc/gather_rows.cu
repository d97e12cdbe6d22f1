// Row gathers from the device-resident feature cache, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of vqa_project_tpu/ops/pallas/gather_rows.py:
//
//   F  gather_rows_packed <- _dma_kernel (entries gather_rows_dma and
//      pack_table): out[i] = table[clamp(rows[i], 0, N-1)] for all B rows
//      in one launch. The TPU kernel ring-buffers B HBM->HBM DMAs over a
//      tile-aligned (N, S, K*F/S) view; on the card the table is flat,
//      N rows of row_bytes, and needs no such view. With an int8 table and
//      its (N, K) f32 scales the epilogue dequantizes:
//      out = (float(q) * scales[row, k]) rounded once to f32 or bf16, the
//      JAX step's make_image_fn arithmetic (train/steps.py:146-151).
//   G  gather_rows_blocked <- _copy_kernel (entry gather_rows_blocked): one
//      block per output row, any (K, F) row shape, in the widest element
//      (16, 8, 4, 2 or 1 bytes) that divides the row.
//
//   G  gather_image_rows <- _copy_kernel too, redesigned: the step's boxes
//      are gathered inside F's launch, which writes the model's input
//      directly (below).
//
// Rows are clamped as jnp.take(mode="clip") does, so a bad index never
// reads out of bounds. Row offsets are 64-bit: the VQA v2 table holds
// 123,287 x 36 x 2048 = 9.1e9 elements (18.2 GB in bf16).
//
// What bounds them on an H100: bytes. Each gathered row is read once and
// written once, 2 x B x row_bytes (18.9 MB at B=64 from the bf16 (36, 2048)
// table, 5.6 us at 3.35 TB/s), plus the int8 path's scales; there is no
// arithmetic to speak of. So F's design is about keeping DRAM busy:
//
// - One block per (chunk, row), a chunk being kChunk = 1024 16-byte
//   vectors, so a (36, 2048) bf16 row of 9216 vectors takes exactly 9
//   blocks; the grid is launched once and the blocks retire as they go.
//   Several blocks fit on an SM (ptxas -v in the build log gives the
//   registers), each thread with kPer 16-byte loads in flight, and a
//   block's stores overlap the loads of the blocks that follow it.
// - Each thread issues its kPer = 4 loads, coalesced across the block,
//   before its stores.
// - Each row is read once and each output written once: the loads are
//   ld.global.nc.L1::no_allocate with an L2::256B prefetch, the stores
//   st.global.cs (streaming).
//
// A grid of the card's resident blocks, each walking an even share of
// all B x row_vecs vectors with a software pipeline in registers, was
// built and measured slower at B=256 (PERF.md): its doubled registers
// let fewer blocks, and so fewer loads, stay in flight on an SM. A
// bulk-copy (TMA) ring was not built.
//
// The int8 path walks the same way over 16-int8 input vectors (F % 16 ==
// 0: a vector lies inside one box and takes one scale), storing 64 (f32)
// or 32 (bf16) bytes per vector. Where F % 16 != 0 an element-wise
// kernel takes the rows, one block per (kChunk elements, row).

// gather_image_rows: the cache-mode step's whole image assembly in one
// launch. G alone moved 576 bytes an image in a launch of its own (~2.6
// us of ramp for a 22 ns bound), and the model then cast the boxes and
// concatenated them onto F's features, a second pass over F's bytes. Here
// each row's blocks convert F's vectors straight into the node rows
// nodes[i, k, :] = cvt(features[r, k, :]) || cvt(boxes[r, k, :]) || 0-pad
// at the row stride ld (F + 4, or padded for the merged block's TMA), and
// chunk 0's first K threads also carry the box tails and the f32 boxes.
// cvt is a copy, an exact bf16 -> f32 widening, one round to nearest
// f32 -> bf16, or float(q) * scale rounded once (F's int8 arithmetic).
// Each thread's input vector is as wide as gives it 16 output bytes (8
// for f32 -> bf16), so that every warp's store fills whole 32-byte
// sectors: 16 int8 -> 32 bf16 bytes in two stores would leave each
// store instruction half of every sector it touches (a quarter in 8-byte
// stores), for the memory system to merge. Odd boxes of an
// unpadded bf16 row start 8 bytes off 16: their lanes realign in
// registers (a warp shuffle) and store 16-byte vectors. Shapes that do
// not split into such vectors take an element-wise variant, one block per
// (kChunk elements, image).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                     // 16-byte vectors per thread
constexpr int kChunk = kThreads * kPer;     // vectors per block: 16 KB
constexpr int kBlockedThreads = 128;        // G: one block per row

__device__ __forceinline__ long long clamp_row(const int* rows, int i,
                                               long long n_rows) {
  const long long r = rows[i];
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// 16 bytes read once: no L1 line, a 256-byte L2 prefetch
__device__ __forceinline__ uint4 load16(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes written once: a streaming store
__device__ __forceinline__ void store16(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// F, plain copy: row_vecs 16-byte vectors per row
__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const uint4* __restrict__ table,
                   const int* __restrict__ rows, uint4* __restrict__ out,
                   long long n_rows, long long row_vecs) {
  const int i = blockIdx.y;
  const uint4* src = table + clamp_row(rows, i, n_rows) * row_vecs;
  uint4* dst = out + static_cast<long long>(i) * row_vecs;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk +
                         threadIdx.x;
  uint4 v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = base + j * kThreads;
    if (e < row_vecs) v[j] = load16(src + e);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = base + j * kThreads;
    if (e < row_vecs) store16(dst + e, v[j]);
  }
}

// one dequantized value: int8 -> f32 is exact, one f32 multiply, one
// rounding to the output type
__device__ __forceinline__ void put(float* o, long long t, float x) {
  o[t] = x;
}
__device__ __forceinline__ void put(__nv_bfloat16* o, long long t, float x) {
  o[t] = __float2bfloat16_rn(x);
}

// F, int8 table with per-box scales: 16 int8 per vector. F % 16 == 0, so
// a vector lies inside one box and takes one scale.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
gather_dequant_kernel(const int8_t* __restrict__ table,
                      const float* __restrict__ scales,
                      const int* __restrict__ rows, Out* __restrict__ out,
                      long long n_rows, int K, int F) {
  const int i = blockIdx.y;
  const long long r = clamp_row(rows, i, n_rows);
  const long long row_elems = static_cast<long long>(K) * F;
  const long long row_vecs = row_elems / 16;
  const uint4* src = reinterpret_cast<const uint4*>(table + r * row_elems);
  const float* sc = scales + r * K;
  const int fvecs = F / 16;   // vectors per box
  Out* dst = out + static_cast<long long>(i) * row_elems;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk +
                         threadIdx.x;
  uint4 v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = base + j * kThreads;
    if (e < row_vecs) v[j] = load16(src + e);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long e = base + j * kThreads;
    if (e >= row_vecs) continue;
    // the box of vector e (< K * F / 16, an int): a 32-bit division
    const float s = __ldg(sc + static_cast<int>(e) / fvecs);
    const int8_t* q = reinterpret_cast<const int8_t*>(&v[j]);
    // 16 outputs: 64 bytes in f32, 32 in bf16, stored as 16-byte vectors
    constexpr int kOut = 16 * sizeof(Out) / 16;
    uint4 o[kOut];
    Out* ov = reinterpret_cast<Out*>(o);
#pragma unroll
    for (int t = 0; t < 16; ++t) put(ov, t, static_cast<float>(q[t]) * s);
    uint4* d = reinterpret_cast<uint4*>(dst + e * 16);
#pragma unroll
    for (int t = 0; t < kOut; ++t) store16(d + t, o[t]);
  }
}

// F, int8 table whose F is not a multiple of 16: one element per thread
template <typename Out>
__global__ void __launch_bounds__(kThreads)
gather_dequant_scalar_kernel(const int8_t* __restrict__ table,
                             const float* __restrict__ scales,
                             const int* __restrict__ rows,
                             Out* __restrict__ out, long long n_rows, int K,
                             int F) {
  const int i = blockIdx.y;
  const long long r = clamp_row(rows, i, n_rows);
  const long long row_elems = static_cast<long long>(K) * F;
  const int8_t* src = table + r * row_elems;
  const float* sc = scales + r * K;
  Out* dst = out + static_cast<long long>(i) * row_elems;
  const long long stop =
      min(row_elems, static_cast<long long>(blockIdx.x + 1) * kChunk);
  for (long long e = static_cast<long long>(blockIdx.x) * kChunk +
                     threadIdx.x;
       e < stop; e += kThreads)
    put(dst, e, static_cast<float>(src[e]) * __ldg(sc + e / F));
}

// G: one block per output row, row_elems elements of type V
template <typename V>
__global__ void __launch_bounds__(kBlockedThreads)
gather_blocked_kernel(const V* __restrict__ table,
                      const int* __restrict__ rows, V* __restrict__ out,
                      long long n_rows, long long row_elems) {
  const int i = blockIdx.x;
  const V* src = table + clamp_row(rows, i, n_rows) * row_elems;
  V* dst = out + static_cast<long long>(i) * row_elems;
  for (long long e = threadIdx.x; e < row_elems; e += kBlockedThreads)
    dst[e] = src[e];
}

// ---- gather_image_rows: the image rows as the model reads them ----

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename Out>
__device__ __forceinline__ Out from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 bytes written once
__device__ __forceinline__ void store8(void* p, uint32_t x, uint32_t y) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};\n"
               :: "l"(p), "r"(x), "r"(y) : "memory");
}

// 8 and 4 bytes read once, as load16
__device__ __forceinline__ uint2 load_nc(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t load_nc(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];\n"
      : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint4 load_nc(const uint4* p) { return load16(p); }

// The input vector of an (In, Out) pair: as many input bytes as give at
// most 16 output bytes, so that a warp's store covers whole 32-byte
// sectors (16 int8 in, 32 bf16 bytes out, would leave each store
// instruction a half-written sector behind it)
template <int kBytes> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = uint32_t; };

template <typename In, typename Out>
struct ImagePair {
  static constexpr int kInBytes =
      sizeof(In) >= sizeof(Out) ? 16 : 16 * sizeof(In) / sizeof(Out);
  static constexpr int kIn = kInBytes / sizeof(In);      // elements
  static constexpr int kOutBytes = kIn * sizeof(Out);    // 16, or 8
  static constexpr int kPerT = 64 / kInBytes;   // loads in flight: 64 B
  using V = typename Raw<kInBytes>::T;
};

// one input vector -> its kIn outputs of Out, as 32-bit words; s is the
// box's scale (int8 only)
template <typename In, typename Out, typename V>
__device__ __forceinline__ void convert(const V& v, float s, uint32_t* w) {
  constexpr int kIn = sizeof(V) / sizeof(In);
  if constexpr (std::is_same<In, Out>::value) {
    const uint32_t* x = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int t = 0; t < static_cast<int>(sizeof(V) / 4); ++t) w[t] = x[t];
  } else {
    const In* x = reinterpret_cast<const In*>(&v);
    Out* o = reinterpret_cast<Out*>(w);
#pragma unroll
    for (int t = 0; t < kIn; ++t) {
      if constexpr (std::is_same<In, int8_t>::value)
        o[t] = from_float<Out>(to_float(x[t]) * s);
      else
        o[t] = from_float<Out>(to_float(x[t]));
    }
  }
}

// box k's tail of node row (i, k): its 4 coordinates in Out, then zeros
// up to ld; and the f32 box to boxes_out
template <typename Out>
__device__ __forceinline__ void write_tail(Out* row, float* box_out,
                                           uint4 bx, int F, int ld) {
  store16(reinterpret_cast<uint4*>(box_out), bx);
  const float b[4] = {__uint_as_float(bx.x), __uint_as_float(bx.y),
                      __uint_as_float(bx.z), __uint_as_float(bx.w)};
#pragma unroll
  for (int q = 0; q < 4; ++q) row[F + q] = from_float<Out>(b[q]);
  for (int c = F + 4; c < ld; ++c) row[c] = from_float<Out>(0.0f);
}

// One block per (chunk of kThreads * kPerT input vectors, image i), as
// F: each thread loads its kPerT vectors (and, in chunk 0, box
// threadIdx.x) before it converts and stores them. F % kIn == 0, so a
// vector lies inside one box; ld * sizeof(Out) % 8 == 0 and nodes is
// 16-byte aligned, so every output vector starts on 8 bytes. A box whose
// node row starts 8 bytes off 16 (odd boxes of an unpadded bf16 row) is
// realigned in registers: each lane stores its high 8 bytes with the
// next lane's low 8 as one 16-byte vector, and only a run's first low
// half and last high half go out as 8-byte stores.
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
gather_image_kernel(const In* __restrict__ table,
                    const float* __restrict__ scales,
                    const float* __restrict__ boxes,
                    const int* __restrict__ rows, Out* __restrict__ nodes,
                    float* __restrict__ boxes_out, long long n_rows, int K,
                    int F, int ld) {
  using P = ImagePair<In, Out>;
  using V = typename P::V;
  constexpr int kWords = P::kOutBytes / 4;
  const int i = blockIdx.y;
  const long long r = clamp_row(rows, i, n_rows);
  const int vpb = F / P::kIn;                 // vectors per box
  const int row_vecs = K * vpb;
  const V* src = reinterpret_cast<const V*>(
      table + r * K * static_cast<long long>(F));
  Out* dst = nodes + static_cast<long long>(i) * K * ld;
  const uint4* bsrc = reinterpret_cast<const uint4*>(boxes) + r * K;
  float* bdst = boxes_out + static_cast<long long>(i) * K * 4;
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kThreads * P::kPerT + threadIdx.x;
  V v[P::kPerT];
#pragma unroll
  for (int j = 0; j < P::kPerT; ++j) {
    const int e = base + j * kThreads;
    if (e < row_vecs) v[j] = load_nc(src + e);
  }
  const bool tails = blockIdx.x == 0;
  uint4 bx;
  if (tails && static_cast<int>(threadIdx.x) < K)
    bx = load16(bsrc + threadIdx.x);
#pragma unroll
  for (int j = 0; j < P::kPerT; ++j) {
    const int e = base + j * kThreads;
    const bool valid = e < row_vecs;
    const int k = valid ? e / vpb : 0;        // 32-bit: e < K * F
    const int at = e - k * vpb;               // the vector's place in box k
    uint32_t w[kWords] = {};
    if (valid) {
      float s = 1.0f;
      if constexpr (std::is_same<In, int8_t>::value)
        s = __ldg(scales + r * K + k);
      convert<In, Out>(v[j], s, w);
    }
    char* d = reinterpret_cast<char*>(dst + static_cast<long long>(k) * ld +
                                      at * P::kIn);
    if constexpr (P::kOutBytes == 16) {
      // every lane takes part: the next lane's low half
      const uint32_t nx = __shfl_down_sync(0xffffffffu, w[0], 1);
      const uint32_t ny = __shfl_down_sync(0xffffffffu, w[1], 1);
      if (!valid) continue;
      if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
        store16(reinterpret_cast<uint4*>(d),
                make_uint4(w[0], w[1], w[2], w[3]));
      } else {
        // lane - 1 holds vector e - 1 and lane + 1 vector e + 1: in this
        // box unless a box starts there, and stored unless past the row
        const bool after_prev = lane > 0 && at != 0;
        const bool before_next = lane < 31 && e + 1 < row_vecs &&
                                 at + 1 != vpb;
        if (!after_prev) store8(d, w[0], w[1]);
        if (before_next)
          store16(reinterpret_cast<uint4*>(d + 8),
                  make_uint4(w[2], w[3], nx, ny));
        else
          store8(d + 8, w[2], w[3]);
      }
    } else {
      if (valid) store8(d, w[0], w[1]);
    }
  }
  if (tails) {
    for (int k = threadIdx.x; k < K; k += kThreads) {
      if (k != static_cast<int>(threadIdx.x)) bx = load16(bsrc + k);
      write_tail(dst + static_cast<long long>(k) * ld, bdst + 4 * k, bx, F,
                 ld);
    }
  }
}

// The element-wise variant: one output element of the (K, ld) node row
// per thread, one block per (kChunk elements, image); chunk 0 also copies
// the f32 boxes
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
gather_image_scalar_kernel(const In* __restrict__ table,
                           const float* __restrict__ scales,
                           const float* __restrict__ boxes,
                           const int* __restrict__ rows,
                           Out* __restrict__ nodes,
                           float* __restrict__ boxes_out, long long n_rows,
                           int K, int F, int ld) {
  const int i = blockIdx.y;
  const long long r = clamp_row(rows, i, n_rows);
  const long long n = static_cast<long long>(K) * ld;
  const In* src = table + r * K * static_cast<long long>(F);
  const float* bsrc = boxes + r * K * 4;
  Out* dst = nodes + i * n;
  const long long stop =
      min(n, static_cast<long long>(blockIdx.x + 1) * kChunk);
  for (long long e = static_cast<long long>(blockIdx.x) * kChunk +
                     threadIdx.x;
       e < stop; e += kThreads) {
    const int k = static_cast<int>(e / ld);
    const int c = static_cast<int>(e - static_cast<long long>(k) * ld);
    float x = 0.0f;
    if (c < F) {
      x = to_float(src[static_cast<long long>(k) * F + c]);
      if constexpr (std::is_same<In, int8_t>::value)
        x *= __ldg(scales + r * K + k);
    } else if (c < F + 4) {
      x = bsrc[4 * k + c - F];
    }
    dst[e] = from_float<Out>(x);
  }
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < 4 * K; e += kThreads)
      boxes_out[static_cast<long long>(i) * K * 4 + e] = bsrc[e];
}

template <typename In, typename Out>
cudaError_t launch_image(const void* table, const float* scales,
                         const float* boxes, const int* rows, void* nodes,
                         float* boxes_out, long long n_rows, int B, int K,
                         int F, int ld, cudaStream_t s) {
  using P = ImagePair<In, Out>;
  const In* t = static_cast<const In*>(table);
  Out* o = static_cast<Out*>(nodes);
  const long long row_vecs = static_cast<long long>(K) * F / P::kIn;
  if (F % P::kIn == 0 && row_vecs < (1LL << 31) &&
      (static_cast<long long>(ld) * sizeof(Out)) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(nodes) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(boxes) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(boxes_out) % 16 == 0) {
    const long long chunk = kThreads * P::kPerT;
    const dim3 grid((row_vecs + chunk - 1) / chunk, B);
    gather_image_kernel<In, Out><<<grid, kThreads, 0, s>>>(
        t, scales, boxes, rows, o, boxes_out, n_rows, K, F, ld);
  } else {
    const long long n = static_cast<long long>(K) * ld;
    const dim3 grid((n + kChunk - 1) / kChunk, B);
    gather_image_scalar_kernel<In, Out><<<grid, kThreads, 0, s>>>(
        t, scales, boxes, rows, o, boxes_out, n_rows, K, F, ld);
  }
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_image_to(int out_dtype, const void* table,
                            const float* scales, const float* boxes,
                            const int* rows, void* nodes, float* boxes_out,
                            long long n_rows, int B, int K, int F, int ld,
                            cudaStream_t s) {
  if (out_dtype == 0)
    return launch_image<In, float>(table, scales, boxes, rows, nodes,
                                   boxes_out, n_rows, B, K, F, ld, s);
  if (out_dtype == 1)
    return launch_image<In, __nv_bfloat16>(table, scales, boxes, rows, nodes,
                                           boxes_out, n_rows, B, K, F, ld, s);
  return cudaErrorInvalidValue;
}

size_t elem_bytes(int dtype) {
  return dtype == 0 ? 4 : dtype == 1 ? 2 : dtype == 2 ? 1 : 0;
}

template <typename Out>
cudaError_t launch_dequant(const void* table, const float* scales,
                           const int* rows, void* out, long long n_rows,
                           int B, int K, int F, cudaStream_t s) {
  const long long row_elems = static_cast<long long>(K) * F;
  const int8_t* t = static_cast<const int8_t*>(table);
  Out* o = static_cast<Out*>(out);
  if (F % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const dim3 grid((row_elems / 16 + kChunk - 1) / kChunk, B);
    gather_dequant_kernel<Out><<<grid, kThreads, 0, s>>>(t, scales, rows, o,
                                                         n_rows, K, F);
  } else {
    const dim3 grid((row_elems + kChunk - 1) / kChunk, B);
    gather_dequant_scalar_kernel<Out><<<grid, kThreads, 0, s>>>(
        t, scales, rows, o, n_rows, K, F);
  }
  return cudaGetLastError();
}

}  // namespace

// Kernel F. table (n_rows, K, F) of dtype in_dtype (0 f32, 1 bf16,
// 2 int8); rows (B) int32, clamped to [0, n_rows); out (B, K, F).
// Without scales the rows are copied as they are (row bytes a multiple of
// 16, table and out 16-byte aligned). With scales (n_rows, K) f32 the
// table must be int8 and out is out_dtype (0 f32, 1 bf16), dequantized.
// One launch. Returns cudaError_t.
extern "C" int gather_rows_packed(const void* table, const void* scales,
                                  const void* rows, void* out,
                                  long long n_rows, int B, int K, int F,
                                  int in_dtype, int out_dtype, void* stream) {
  const size_t es = elem_bytes(in_dtype);
  if (n_rows <= 0 || B <= 0 || B > 65535 || K <= 0 || F <= 0 || es == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  if (scales != nullptr) {
    if (in_dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
    const float* sc = static_cast<const float*>(scales);
    if (out_dtype == 0)
      return static_cast<int>(
          launch_dequant<float>(table, sc, r, out, n_rows, B, K, F, s));
    if (out_dtype == 1)
      return static_cast<int>(launch_dequant<__nv_bfloat16>(
          table, sc, r, out, n_rows, B, K, F, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row_bytes = static_cast<long long>(K) * F * es;
  if (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long row_vecs = row_bytes / 16;
  const dim3 grid((row_vecs + kChunk - 1) / kChunk, B);
  gather_copy_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(table), r, static_cast<uint4*>(out), n_rows,
      row_vecs);
  return static_cast<int>(cudaGetLastError());
}

// Kernel G. table (n_rows, row_bytes) of any shape and dtype; rows (B)
// int32, clamped; out (B, row_bytes). width (16, 8, 4, 2 or 1) is the
// element the block copies, dividing row_bytes and both pointers'
// alignment. One launch of B blocks. Returns cudaError_t.
extern "C" int gather_rows_blocked(const void* table, const void* rows,
                                   void* out, long long n_rows, int B,
                                   long long row_bytes, int width,
                                   void* stream) {
  if (n_rows <= 0 || B <= 0 || row_bytes <= 0 || width <= 0 ||
      row_bytes % width != 0 ||
      reinterpret_cast<uintptr_t>(table) % width != 0 ||
      reinterpret_cast<uintptr_t>(out) % width != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const long long n = row_bytes / width;
  switch (width) {
    case 16:
      gather_blocked_kernel<uint4><<<B, kBlockedThreads, 0, s>>>(
          static_cast<const uint4*>(table), r, static_cast<uint4*>(out),
          n_rows, n);
      break;
    case 8:
      gather_blocked_kernel<uint2><<<B, kBlockedThreads, 0, s>>>(
          static_cast<const uint2*>(table), r, static_cast<uint2*>(out),
          n_rows, n);
      break;
    case 4:
      gather_blocked_kernel<unsigned int><<<B, kBlockedThreads, 0, s>>>(
          static_cast<const unsigned int*>(table), r,
          static_cast<unsigned int*>(out), n_rows, n);
      break;
    case 2:
      gather_blocked_kernel<unsigned short><<<B, kBlockedThreads, 0, s>>>(
          static_cast<const unsigned short*>(table), r,
          static_cast<unsigned short*>(out), n_rows, n);
      break;
    case 1:
      gather_blocked_kernel<unsigned char><<<B, kBlockedThreads, 0, s>>>(
          static_cast<const unsigned char*>(table), r,
          static_cast<unsigned char*>(out), n_rows, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel G, redesigned: the cache-mode step's images in one launch.
// features (n_rows, K, F) of in_dtype (0 f32, 1 bf16, 2 int8; int8 with
// its (n_rows, K) f32 scales, else scales null); boxes (n_rows, K, 4)
// f32; rows (B) int32, clamped to [0, n_rows). Writes nodes (B, K, ld) of
// out_dtype (0 f32, 1 bf16), ld >= F + 4: columns 0..F-1 the features
// converted, F..F+3 the boxes rounded to out_dtype, the rest 0; and
// boxes_out (B, K, 4) f32. Returns cudaError_t.
extern "C" int gather_image_rows(const void* table, const void* scales,
                                 const void* boxes, const void* rows,
                                 void* nodes, void* boxes_out,
                                 long long n_rows, int B, int K, int F,
                                 int ld, int in_dtype, int out_dtype,
                                 void* stream) {
  if (n_rows <= 0 || B <= 0 || B > 65535 || K <= 0 || F <= 0 ||
      ld < F + 4 || (in_dtype == 2) != (scales != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const float* bx = static_cast<const float*>(boxes);
  const int* r = static_cast<const int*>(rows);
  float* bo = static_cast<float*>(boxes_out);
  switch (in_dtype) {
    case 0:
      return static_cast<int>(launch_image_to<float>(
          out_dtype, table, sc, bx, r, nodes, bo, n_rows, B, K, F, ld, s));
    case 1:
      return static_cast<int>(launch_image_to<__nv_bfloat16>(
          out_dtype, table, sc, bx, r, nodes, bo, n_rows, B, K, F, ld, s));
    case 2:
      return static_cast<int>(launch_image_to<int8_t>(
          out_dtype, table, sc, bx, r, nodes, bo, n_rows, B, K, F, ld, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
