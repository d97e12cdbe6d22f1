// Adam's update of every parameter in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves optax's Adam to XLA,
// which fuses it per leaf. The port stepped it as fourteen torch._foreach
// passes over every parameter (train/state.py's plain version, kept for
// the CPU), each reading and writing f32 lists, with fresh moment lists
// every step; on an H100 that ran 6x over the bytes the update needs.
//
// What bounds it: bytes. Per element it reads p, g, mu and nu and writes
// p, mu and nu once: 28 bytes with f32 moments (20 with both in bf16),
// 0.79 ms for VQA v2's 28.2 M parameters and 1.68 ms for MCAN-large's
// 201.6 M at 3.35 TB/s. The arithmetic (a dozen f32 operations, one
// square root) is far below the card's rate. So the design keeps DRAM
// busy and touches each byte once:
//
// - One launch for all tensors. A device table holds, per tensor, the
//   addresses of p, g, mu and nu, its element count and the first chunk
//   it owns in the concatenated index space (a chunk is 4 elements), and
//   a last row whose start is the total. A grid of the card's resident
//   blocks (a few per SM, from the occupancy calculator) strides over the
//   chunks; each thread walks the table forward as its chunk index grows,
//   so finding a chunk's tensor costs one comparison in the common case.
// - 16-byte loads and stores: 4 f32 of p, g and f32 moments (8 bytes of
//   bf16 moments) a chunk, when the tensor's four addresses are aligned
//   for them; a tensor's last partial chunk, and any tensor whose
//   addresses are not aligned (a tensor-parallel shard inside a flat
//   buffer), takes element-wise loads.
// - The moments are updated in place.
//
// The arithmetic is the plain version's op by op (optax's order), each
// operation with a _rn intrinsic so that nothing is contracted into an
// FMA: mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, then
// p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), where a
// division by a bias correction is, as torch's division of a tensor by a
// scalar on the card computes it, a product with its f32 reciprocal
// (1 / (1 - b^t) rounded once). A bf16 mu
// has b1 mu rounded to bf16 before the sum (b1 itself as bf16 holds it);
// the update uses the f32 sum, and bf16(mu) is stored. A bf16 nu is
// widened, stepped in f32 and rounded back. lr, 1 - b1^t and 1 - b2^t are
// read from a 3-float device tensor, which the host writes by one
// stream-ordered copy before each launch or graph replay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // elements a chunk

struct Row {
  long long p, g, mu, nu, numel, start;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// b1 mu as the plain version forms it: an f32 product, rounded to the
// moment's dtype (exact in f32 for bf16 operands, then one rounding)
template <typename MU>
__device__ __forceinline__ float decayed(float mu, float b1m) {
  return widen(narrow<MU>(__fmul_rn(mu, b1m)));
}

struct Consts {
  float c1, b1m, c2, b2, eps, lr, inv_bc1, inv_bc2;
};

// one element: p, mu and nu in f32 on entry (mu, nu widened from their
// storage), the new ones on return
template <typename MU>
__device__ __forceinline__ void update(float& p, float g, float& mu, float& nu,
                                       const Consts& k) {
  mu = __fadd_rn(__fmul_rn(g, k.c1), decayed<MU>(mu, k.b1m));
  nu = __fadd_rn(__fmul_rn(__fmul_rn(g, g), k.c2), __fmul_rn(nu, k.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, k.inv_bc2)), k.eps);
  const float u = __fdiv_rn(__fmul_rn(mu, k.inv_bc1), den);
  p = __fadd_rn(p, __fmul_rn(u, -k.lr));
}

// 4 moments of one dtype as one 16-byte (f32) or 8-byte (bf16) access
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  __device__ __forceinline__ static void load(const float* a, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(a);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* a, const float* v) {
    *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* a,
                                              float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(a);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* a,
                                               const float* v) {
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                                 __float2bfloat16_rn(v[1]));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                                 __float2bfloat16_rn(v[3]));
    uint2 x;
    x.x = *reinterpret_cast<const uint32_t*>(&lo);
    x.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(a) = x;
  }
};

template <typename T>
__device__ __forceinline__ bool aligned(long long addr) {
  return addr % (kVec * static_cast<long long>(sizeof(T))) == 0;
}

template <typename MU, typename NU>
__global__ void __launch_bounds__(kThreads)
adam_fused_kernel(const Row* __restrict__ rows, long long chunks,
                  const float* __restrict__ scalars, float c1, float b1m,
                  float c2, float b2, float eps) {
  const Consts k{c1, b1m, c2, b2, eps, scalars[0],
                 __fdiv_rn(1.0f, scalars[1]), __fdiv_rn(1.0f, scalars[2])};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  int t = 0;
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       c < chunks; c += stride) {
    while (rows[t + 1].start <= c) ++t;  // empty tensors own no chunk
    const Row r = rows[t];
    float* p = reinterpret_cast<float*>(r.p);
    const float* g = reinterpret_cast<const float*>(r.g);
    MU* mu = reinterpret_cast<MU*>(r.mu);
    NU* nu = reinterpret_cast<NU*>(r.nu);
    const long long i0 = (c - r.start) * kVec;
    const long long left = r.numel - i0;
    if (left >= kVec && aligned<float>(r.p) && aligned<float>(r.g) &&
        aligned<MU>(r.mu) && aligned<NU>(r.nu)) {
      float pv[kVec], gv[kVec], mv[kVec], nv[kVec];
      Vec4<float>::load(p + i0, pv);
      Vec4<float>::load(g + i0, gv);
      Vec4<MU>::load(mu + i0, mv);
      Vec4<NU>::load(nu + i0, nv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) update<MU>(pv[j], gv[j], mv[j], nv[j], k);
      Vec4<float>::store(p + i0, pv);
      Vec4<MU>::store(mu + i0, mv);
      Vec4<NU>::store(nu + i0, nv);
    } else {
      const int n = left < kVec ? static_cast<int>(left) : kVec;
      for (int j = 0; j < n; ++j) {
        const long long i = i0 + j;
        float pj = p[i], mj = widen(mu[i]), nj = widen(nu[i]);
        update<MU>(pj, g[i], mj, nj, k);
        p[i] = pj;
        mu[i] = narrow<MU>(mj);
        nu[i] = narrow<NU>(nj);
      }
    }
  }
}

template <typename MU, typename NU>
cudaError_t launch(const Row* rows, long long chunks, const float* scalars,
                   float c1, float b1m, float c2, float b2, float eps,
                   cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adam_fused_kernel<MU, NU>, kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long need = (chunks + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(need < resident ? need : resident);
  adam_fused_kernel<MU, NU><<<grid, kThreads, 0, s>>>(
      rows, chunks, scalars, c1, b1m, c2, b2, eps);
  return cudaGetLastError();
}

}  // namespace

// table: (n + 1) rows of 6 int64 (p, g, mu, nu, numel, first chunk), the
// last one's first chunk the total `chunks`; scalars: 3 f32 on the card
// (lr, 1 - b1^t, 1 - b2^t); c1 = 1 - b1, b1m = b1 in mu's dtype, c2 = 1 -
// b2, b2, eps as f32; moment dtypes 0 = f32, 1 = bf16.
extern "C" int adam_fused_step(const void* table, long long chunks,
                               const void* scalars, float c1, float b1m,
                               float c2, float b2, float eps, int mu_dtype,
                               int nu_dtype, void* stream) {
  if (chunks < 0 || table == nullptr || scalars == nullptr ||
      mu_dtype < 0 || mu_dtype > 1 || nu_dtype < 0 || nu_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 0) return static_cast<int>(cudaSuccess);
  const Row* rows = static_cast<const Row*>(table);
  const float* sc = static_cast<const float*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mu_dtype == 0 && nu_dtype == 0)
    e = launch<float, float>(rows, chunks, sc, c1, b1m, c2, b2, eps, s);
  else if (mu_dtype == 0)
    e = launch<float, __nv_bfloat16>(rows, chunks, sc, c1, b1m, c2, b2, eps,
                                     s);
  else if (nu_dtype == 0)
    e = launch<__nv_bfloat16, float>(rows, chunks, sc, c1, b1m, c2, b2, eps,
                                     s);
  else
    e = launch<__nv_bfloat16, __nv_bfloat16>(rows, chunks, sc, c1, b1m, c2,
                                             b2, eps, s);
  return static_cast<int>(e);
}
