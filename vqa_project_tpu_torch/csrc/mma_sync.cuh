// Pieces shared by the tensor-core kernels written on mma.sync (kernel
// B's recurrence, csrc/gru_scan.cu; kernel E's reverse sweep,
// csrc/gru_scan_bwd.cu; the bf16 bodies of kernels A, C and D,
// csrc/edge_aggregate.cu and edge_aggregate_bwd.cu): ldmatrix (plain and
// transposed) and mma.sync.m16n8k16 (bf16 in, f32 sum), cp.async through
// L2 only, the grid barrier of a cooperative launch, and the host check
// that a grid can be resident all at once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_sync {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same four 8x8 matrices, each transposed on the way into registers:
// a row-major [k][n] tile gives mma's B fragments (lanes 0-7 address k
// rows 0-7 at column n, lanes 8-15 rows 8-15, lanes 16-31 the same at
// column n + 8: r0, r1 = b0, b1 of columns n..n+7 and r2, r3 of n+8..)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared through L2 only (.cg); zero fill when !valid.
// Data that other blocks wrote during the same launch must come this way
// (or by ld.global.cg), never through the non-coherent L1/texture path.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// All blocks of the launch meet here; `target` is the number of arrivals
// that completes this barrier (the counter only grows, and is zeroed on
// the stream before the launch). After the block's barrier, thread 0
// publishes the block's writes with a release add and takes the others'
// with acquire loads; the block's barrier after it hands them on
// (CUTLASS's generic barrier does the same).
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(counter) : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// A grid barrier needs every block resident at once: refuse a grid that
// cannot be (cudaErrorCooperativeLaunchTooLarge, the error the
// cooperative launch would give) before anything runs, so that no launch
// can deadlock. Sets the kernel's dynamic shared memory first.
template <typename Kernel>
cudaError_t check_coresident(Kernel kernel, int threads, size_t smem,
                             int blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (!coop || per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace mma_sync
