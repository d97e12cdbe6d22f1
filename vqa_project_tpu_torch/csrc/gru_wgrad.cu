// Weight gradient of the GRU recurrence (kernel E, dW/db) with bf16
// operands, on the tensor cores, for Hopper (sm_90a).
//
// Replaces the weight-gradient half of the TPU kernel
// vqa_project_tpu/ops/pallas/gru_scan.py::_gru_bwd_kernel (its dw_scr /
// db_scr accumulators) for bf16 weights; the f32 path keeps the SIMT
// reduction of csrc/gru_scan_bwd.cu::gru_wgrad. With D = dhp[1:] as
// (R, 3H) and Hp = hs16[:-1] as (R, H), R = (T-1) B:
//
//   dW (3H, H) = D^T Hp      db (3H) = sum over all T B rows of dhp
//
// in f32. hs16 is the bf16 rounding of the forward's states that kernel
// B writes in training (csrc/gru_scan.cu), so the operand is exactly
// the plain version's hs.to(bfloat16) (ops/gru.py::gru_wgrad_reference).
//
// What bounds it on an H100: bytes at the training batch (B=64: the
// 12.6 MB f32 dW write against 6 GFLOP), operations from B ~ 256 on.
// What holds it back there is the operand stream from L2: every block
// reads 40 KB a K step, ~6 TB/s over the grid at B=256 (PERF.md).
//
// Design: the product is computed as dW^T (H, 3H) = Hp^T D, a TN product
// with both operands reduced over their rows, so both tiles sit in
// shared memory MN-major and wgmma reads them with its transpose bits
// set. A tile is 128 units of H (64 per consumer warpgroup, the wgmma's
// M) by 192 rows of dW (three 64-wide D boxes, its N): 8 x 16 = 128
// tiles at H=1024, one per SM in one wave. This is cuBLAS's tile for
// the same product on an H100; it beat 192 x 128 tiles with N = 128 and
// three consumer groups, and 128 x 128 tiles walked two a block (see
// PERF.md). The blocks run a persistent tile loop: at most one block
// per SM, each walking the tiles with a stride of the grid, the tiles
// split evenly over the blocks. Every tile is summed over all R rows: a
// 5-stage ring of 64-row K steps filled by TMA (one producer thread, 64
// x 64 boxes, 128-byte swizzle, the rows past R zero-filled by the
// hardware) and drained by the two consumer warpgroups, each issuing
// m64n192k16 wgmmas, one stage's group in flight while it waits for the
// next; full/empty mbarriers hand the stages over. The ring runs on
// across tiles, so the producer fills the next tile's stages while this
// one's last products and epilogue run. The epilogue stores straight
// from the accumulator fragments: a warp's store writes 8 consecutive
// floats of 4 rows of dW, whole 32-byte sectors, with no staging buffer
// and no barrier. No split over K and no atomics: each element of dW is
// summed over the K steps in one order, whatever the tiling, so dW
// repeats bit for bit.
//
// The producer warpgroup's other three warps sum a slice of db (the
// columns split evenly over the blocks) straight from dhp, every row in
// a fixed order, while the products run. Since H % 64 == 0, 3H is a
// multiple of the tile's 192 rows; a unit tile past H (H % 128 == 64) is
// zero-filled by TMA and not stored.

#include "wgmma.cuh"

namespace {

constexpr int kNC = 2;      // consumer warpgroups: 64 kNC units of H a tile
constexpr int kTM = 64 * kNC;
constexpr int kTN = 192;    // rows of dW a tile (three 64-wide D boxes)
constexpr int kBK = 64;     // rows of D and Hp per ring stage
constexpr int kStages = 5;
constexpr int kBox = 64 * kBK * 2;  // bytes of one 64 x 64 bf16 box
constexpr int kDbThreads = 96;      // the producer group's warps 1..3

constexpr int kStageBytes = (kNC + 3) * kBox;  // Hp boxes, then D boxes
constexpr int kRing = kStages * kStageBytes;
constexpr int kBars = kRing;                     // full, then empty
constexpr int kDb = kBars + 2 * kStages * 8;     // db partials
constexpr int kSmemBytes = kDb + kDbThreads * 8 * 4;
static_assert(kSmemBytes + 1024 <= 227 * 1024, "shared memory per block");

__global__ void __launch_bounds__((kNC + 1) * 128, 1)
gru_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_d,  // (R, 3H)
                       const __grid_constant__ CUtensorMap map_h,  // (R, H)
                       const __nv_bfloat16* __restrict__ dhp,  // (T B, 3H)
                       float* __restrict__ dw,                 // (3H, H)
                       float* __restrict__ db,                 // (3H)
                       int rows_all, int R, int H, int db_cols) {
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled boxes need 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;
  float* db_s = reinterpret_cast<float*>(smem + kDb);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int h3 = 3 * H;
  const int tiles_m = (H + kTM - 1) / kTM;
  const int tiles = tiles_m * (h3 / kTN);
  const int nk = (R + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], kNC * 4);  // one arrival per consumer warp
    }
    wgmma::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kNC) {  // the producer warpgroup
    const int w = (tid % 128) / 32;
    if (w == 0) {
      if (lane == 0) {
        int it = 0;  // K steps issued, over all tiles: the ring position
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int h0 = tile % tiles_m * kTM, d0 = tile / tiles_m * kTN;
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % kStages, round = it / kStages;
            if (round > 0) wgmma::mbar_wait(&empty[s], (round - 1) & 1);
            uint8_t* st = smem + s * kStageBytes;
            wgmma::mbar_arrive_expect_tx(&full[s], kStageBytes);
            for (int c = 0; c < kNC; ++c)
              wgmma::tma_load_2d(st + c * kBox, &map_h, &full[s],
                                 h0 + 64 * c, kt * kBK);
            for (int c = 0; c < 3; ++c)
              wgmma::tma_load_2d(st + (kNC + c) * kBox, &map_d, &full[s],
                                 d0 + 64 * c, kt * kBK);
          }
        }
      }
    } else {
      // db: this block's db_cols columns, 16-byte chunks of 8; thread
      // (group g, chunk c) sums rows g, g + groups, ... in order, then
      // the groups are added in order
      const int t = tid % 128 - 32;
      const int c0 = blockIdx.x * db_cols;
      const int chunks = db_cols / 8, groups = kDbThreads / chunks;
      const int c = t % chunks, g = t / chunks;
      const int col = c0 + c * 8;
      float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (g < groups && col < h3) {
        for (int r = g; r < rows_all; r += groups) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              dhp + static_cast<size_t>(r) * h3 + col));
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            sum[2 * e] += f.x;
            sum[2 * e + 1] += f.y;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) db_s[t * 8 + e] = sum[e];
      asm volatile("bar.sync 8, %0;\n" :: "n"(kDbThreads) : "memory");
      // column j is element j % 8 of chunk j / 8; db_cols is up to 8 x
      // kDbThreads, so a thread may finish several
      for (int j = t; j < db_cols && c0 + j < h3; j += kDbThreads) {
        float s = 0.f;
        for (int gg = 0; gg < groups; ++gg)
          s += db_s[(gg * chunks + j / 8) * 8 + j % 8];
        db[c0 + j] = s;
      }
    }
    return;
  }

  // consumer warpgroup wg: units h0 + 64 wg .. + 63 of each tile
  const int wr = ((tid % 128) / 32) * 16 + lane / 4, wc = (lane % 4) * 2;
  int it = 0;  // K steps consumed, over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int h0 = tile % tiles_m * kTM, d0 = tile / tiles_m * kTN;
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      wgmma::mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a = wgmma::smem_u32(smem + s * kStageBytes + wg * kBox);
      const uint32_t b = wgmma::smem_u32(smem + s * kStageBytes + kNC * kBox);
      wgmma::fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        wgmma::mma_m64n192k16<1, 1>(
            acc, wgmma::desc_sw128(a + k * 2048, kBox, 1024),
            wgmma::desc_sw128(b + k * 2048, kBox, 1024));
      wgmma::commit();
      // keep this stage's products in flight; the previous stage's are
      // done, so its buffers go back to the producer
      wgmma::wait<1>();
      __syncwarp();
      if (kt > 0 && lane == 0)
        wgmma::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma::wait<0>();
    __syncwarp();
    if (nk > 0 && lane == 0) wgmma::mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue: fragment (unit m, row n) -> dw[n][m], 4-byte stores of 8
    // consecutive units per row; the producer is already filling the
    // ring for the next tile
    const int m = h0 + 64 * wg + wr;
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int n = d0 + 8 * i + wc;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* p = dw + static_cast<size_t>(n + e) * H + m;
        if (m < H) p[0] = acc[4 * i + e];
        if (m + 8 < H) p[8] = acc[4 * i + 2 + e];
      }
    }
  }
}

cudaError_t launch(const __nv_bfloat16* dhp, const __nv_bfloat16* hs16,
                   float* dw, float* db, int T, int B, int H,
                   cudaStream_t stream) {
  const int h3 = 3 * H;
  const int R = (T - 1) * B;
  CUtensorMap map_d, map_h;
  // with R = 0 (T = 1) no box is loaded; the maps only need to be valid
  const int rows = R > 0 ? R : 1;
  cudaError_t e = wgmma::make_map_bf16(
      &map_d, R > 0 ? dhp + static_cast<size_t>(B) * h3 : dhp, h3, rows,
      static_cast<uint64_t>(h3) * 2, 64, kBK);
  if (e != cudaSuccess) return e;
  e = wgmma::make_map_bf16(&map_h, hs16, H, rows,
                           static_cast<uint64_t>(H) * 2, 64, kBK);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  // as few blocks as keep the busiest one to the same number of tiles
  const int tiles = (H + kTM - 1) / kTM * (h3 / kTN);
  const int waves = (tiles + sms - 1) / sms;
  const int blocks = (tiles + waves - 1) / waves;
  const int db_cols = 8 * ((h3 / 8 + blocks - 1) / blocks);
  if (db_cols / 8 > kDbThreads) return cudaErrorInvalidValue;
  const int smem = kSmemBytes + 1024;  // + alignment slack
  e = cudaFuncSetAttribute(gru_wgrad_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  gru_wgrad_wgmma_kernel<<<blocks, (kNC + 1) * 128, smem, stream>>>(
      map_d, map_h, dhp, dw, db, T * B, R, H, db_cols);
  return cudaGetLastError();
}

}  // namespace

// dhp (T, B, 3H) bf16 and hs16 (T, B, H) bf16 -> dw (3H, H) f32 and db
// (3H) f32. Needs H % 64 == 0. One launch. Returns cudaError_t.
extern "C" int gru_wgrad_wgmma(const void* dhp, const void* hs16, void* dw,
                               void* db, int T, int B, int H,
                               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % 64 != 0 ||
      static_cast<long long>(T) * B * 3 * H >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      static_cast<const __nv_bfloat16*>(dhp),
      static_cast<const __nv_bfloat16*>(hs16), static_cast<float*>(dw),
      static_cast<float*>(db), T, B, H, static_cast<cudaStream_t>(stream)));
}
