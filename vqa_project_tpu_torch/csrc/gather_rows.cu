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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
