// Grouped matmul for Hopper's tensor cores (sm_90a): the bf16 prefill route
// of the port's gmm (kernel.py picks it with _gmm_route; float32, the
// decode blocks of 16 and 32 rows and ragged shapes keep moe_gmm.cu).
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/moe_gmm/kernel.py:gmm (_gmm_kernel) and computes its
// function, as moe_gmm.cu does:
//
//   x [M, K], w [E, K, N] (bf16), block_expert / nvalid [M / block_m]
//   (int32) -> out [M, N] (bf16):
//   out[mi*bm : (mi+1)*bm] = x[mi*bm : (mi+1)*bm] @ w[block_expert[mi]]
//                            if nvalid[mi] > 0, else 0,
//
// with float32 accumulation and one rounding.  A valid block computes all
// block_m rows, padding rows included; a block with nvalid == 0 writes
// zeros and reads neither its rows of x nor any weights.  block_m is a
// multiple of 64; K and N multiples of 8 (rows of 16 bytes, for TMA).
//
// What bounds it on this card.  At moonshot-v1-16b-a3b's prefill (E 64,
// block_m 128, K 2048, N 1408) and the jamba cut's (8 experts of K 8192,
// N 24576) a call reads each valid expert's weights once: ~195 flops a
// byte, just below the card's ridge, so bytes bound it (3.35 TB/s) a
// little above the bf16 tensor cores (989 TFLOP/s).  The design keeps the
// products on the tensor cores and reads each weight tile from device
// memory about once.
//
// Design.  One CTA per (64 NWG rows, TN = 128 columns) output tile: NWG
// consumer warpgroups of 64 rows (two when block_m is a multiple of 128)
// and one producer warp.  The tile lies in one row block, whose
// block_expert / nvalid entry the CTA reads itself.  The producer's lane
// 0 streams K in 64-deep tiles through a four-stage TMA ring: x's
// [64 NWG x 64] tile (a 2-D map over [M, K]; K-major) and w's [64 x 128]
// tile as two 64-column boxes (a 3-D map over [E, K, N], so a ragged last
// K tile reads zeros, never the next expert's rows; MN-major, the
// instruction's transpose bit set).  Each consumer runs wgmma m64n128k16
// over a stage's 64-deep slice of K into 64 float32 partial sums per
// thread, frees the stage, and adds the partial sums into its float32
// accumulators on the CUDA cores.  The tensor cores' own float32
// accumulation is not float32 addition: it drifts with the depth (at
// the jamba cut's K of 8192 and 24576 beyond the limit the kernel is held
// to at outputs near zero), while a 64-deep partial sum stays far inside
// it and the adds round as float32 does.  The
// epilogue rounds once to bf16 and stores (columns past N are not
// stored).  Raster order: CTAs sharing a weight tile (the row tiles of one
// expert) run side by side.  The grid is 1-D over groups of GROUP = 6 row
// tiles; inside a group the row tile is the fast index, then the N tile.
// An expert's rows span 1, 2 or 3 row tiles at the served shapes (block
// 64 at 512 tokens, 2 x 128 at moonshot's 2048, 3 x 128 in the jamba cut),
// and 6 is a multiple of each, so no expert straddles two groups: its
// weight tiles are read while its row tiles run together, and a group's
// x rows (at most 6 x 128 x K bf16: 12.6 MB at K 8192) stay in the 50 MB
// L2 across the group's N tiles.

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;

constexpr int TK = 64;       // K depth of a stage
constexpr int TN = 128;      // output columns per CTA
constexpr int STAGES = 4;
constexpr int GROUP = 6;     // row tiles per raster group
constexpr int ROW = 128;     // bytes per swizzled tile row (64 bf16)

template <int NWG>
struct Layout {
  static constexpr int X_STAGE = NWG * 64 * ROW;        // [64 NWG][64]
  static constexpr int W_STAGE = (TN / 64) * TK * ROW;  // 2 x [64][64]
  static constexpr int W = STAGES * X_STAGE;
  static constexpr int BAR = W + STAGES * W_STAGE;      // full[S], free[S]
  static constexpr int BYTES = BAR + 8 * 2 * STAGES;
};

template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              const int* __restrict__ block_expert,
              const int* __restrict__ nvalid, __nv_bfloat16* __restrict__ out,
              int M, int K, int N, int E, int block_m) {
  using L = Layout<NWG>;
  constexpr int BM = 64 * NWG;
  const int nm = M / BM, nn = (N + TN - 1) / TN;
  const int g = blockIdx.x / (GROUP * nn), r = blockIdx.x % (GROUP * nn);
  const int rows = min(GROUP, nm - g * GROUP);   // row tiles in this group
  const int m0 = (g * GROUP + r % rows) * BM, n0 = (r / rows) * TN;
  const int blk = m0 / block_m;

  if (nvalid[blk] <= 0) {  // an empty block: zeros, and no reads of x or w
    for (int e = threadIdx.x; e < BM * TN / 2; e += blockDim.x) {
      const int c = n0 + 2 * (e % (TN / 2));
      if (c < N)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)(m0 + e / (TN / 2)) * N + c) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }
  const int ex = block_expert[blk];
  if (ex < 0 || ex >= E) __trap();  // an expert id out of range is a bug

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* free_ = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(free_ + s, 4 * NWG);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int nk = (K + TK - 1) / TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * NWG) {  // the producer warp: TMA loads by lane 0
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(free_ + s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, L::X_STAGE + L::W_STAGE);
        tma_load_2d(smem + s * L::X_STAGE, &tx, full + s, kt * TK, m0);
        for (int a = 0; a < TN / 64; ++a)
          tma_load_3d(smem + L::W + s * L::W_STAGE + a * TK * ROW, &tw,
                      full + s, n0 + 64 * a, kt * TK, ex);
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wg + [0, 64).  Each stage's 64-deep
  // partial product is summed by the tensor cores into `part` and then
  // added to `acc` in float32 on the CUDA cores
  const int wg = warp / 4;
  float acc[TN / 2], part[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    const uint8_t* xs = smem + s * L::X_STAGE + wg * 64 * ROW;
    const uint8_t* ws = smem + L::W + s * L::W_STAGE;
    mbar_wait(full + s, (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_ss_n128<1>(part, desc_sw128(xs + kk * 32, 16, 1024),
                       desc_sw128(ws + kk * 16 * ROW, TK * ROW, 1024),
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(free_ + s);   // this warp is done with stage s
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] += part[i];
  }

  const int row = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    if (c < N) {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + c) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * N + c) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <int NWG>
cudaError_t launch(const void* x, const void* w, const int* be,
                   const int* nv, void* out, int M, int K, int N, int E,
                   int block_m, cudaStream_t stream) {
  using L = Layout<NWG>;
  CUtensorMap mx, mw;
  const uint64_t B2 = sizeof(__nv_bfloat16);
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)M}, sx[1] = {K * B2};
  const uint64_t dw[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t sw[2] = {N * B2, (uint64_t)K * N * B2};
  const uint32_t bx[2] = {TK, 64 * NWG}, bw[3] = {64, TK, 1};
  if (!hopper_host::encode_bf16(&mx, x, 2, dx, sx, bx) ||
      !hopper_host::encode_bf16(&mw, w, 3, dw, sw, bw))
    return cudaErrorInvalidValue;
  const int smem = L::BYTES + 1024;   // + the base's alignment to 1024
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tc_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ctas =
      (long long)(M / (64 * NWG)) * ((N + TN - 1) / TN);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gmm_tc_kernel<NWG><<<(unsigned)ctas, NWG * 128 + 32, smem, stream>>>(
      mx, mw, be, nv, static_cast<__nv_bfloat16*>(out), M, K, N, E,
      block_m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 x [M, K], w [E, K, N], int32 block_expert / nvalid [M / block_m],
// bf16 out [M, N]; contiguous, 16-byte aligned; block_m a multiple of 64
// dividing M, K and N multiples of 8.  Returns a cudaError_t
// (cudaErrorInvalidValue for a shape or pointer it does not take, or a
// tensor map that cannot be encoded).
int moe_gmm_tc(const void* x, const void* w, const void* block_expert,
               const void* nvalid, void* out, int M, int K, int N, int E,
               int block_m, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || block_m <= 0 ||
      block_m % 64 || M % block_m || K % 8 || N % 8 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  const int* nv = static_cast<const int*>(nvalid);
  return (int)(block_m % 128 == 0
                   ? launch<2>(x, w, be, nv, out, M, K, N, E, block_m, s)
                   : launch<1>(x, w, be, nv, out, M, K, N, E, block_m, s));
}

}  // extern "C"
