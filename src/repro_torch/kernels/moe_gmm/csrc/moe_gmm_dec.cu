// Grouped matmul for Hopper (sm_90a), the decode route of the port's gmm:
// bf16 row blocks of 16 or 32 rows on the tensor cores with mma.sync, the
// weights streamed by TMA (kernel.py picks it with _gmm_route; blocks of a
// multiple of 64 rows take moe_gmm_tc.cu, float32 and ragged shapes
// moe_gmm.cu).
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
// with float32 sums and one rounding.  A valid block computes all block_m
// rows, padding rows included; a block with nvalid == 0 writes zeros and
// reads neither its rows of x nor any weights.
//
// What bounds it on this card.  At decode one token fills a few experts
// with one row each (moonshot: 6 of 64 blocks of 16 rows; the jamba cut:
// 1 of 8, 2 rows), so a call reads each valid expert's [K, N] weights once
// and little else: bytes bound it (moonshot's gate/up 34.6 MB, 10.3 us at
// 3.35 TB/s).  But the function computes all 16 rows of a valid block, as
// the Pallas kernel does: 32 flops per 2-byte weight, 16 a byte, which at
// the bytes bound is 53.6 TFLOP/s, 80 % of the CUDA cores' 67 before any
// conversion or shared-memory load.  So the CUDA-core kernel (moe_gmm.cu)
// cannot come near the bound at block_m 16, and this one does the products
// on the tensor cores (mma.sync m16n8k16: its 16 rows are one block; a
// 32-row block is two), where they cost nothing next to the bytes.  What
// is left is keeping enough bytes in flight to stream at the memory's
// rate, and filling the card when only 6 x 11 output tiles have work.
//
// Precision.  The tensor cores' own float32 accumulation aligns and
// truncates the terms (PERF.md), so each 64-deep slice of K is summed by
// four chained mma from a zero accumulator and then added into float32
// registers on the CUDA cores, as moe_gmm_tc.cu does.
//
// Design.  A persistent grid (about three CTAs an SM, as many as fit) of
// CTAs with one producer warp and four consumer warps.  Every CTA counts
// the valid blocks V with warp ballots over nvalid and derives the same
// work list: V x nt output tiles of 16 or 32 rows by TN = 128 columns,
// each cut into S K-splits, S = clamp(grid / (V nt), 1, min(nk, 16)), so
// that the items fill the grid (moonshot gate/up: 66 tiles x 6 splits;
// down: 96 x 4; the jamba cut: 192 x 2 and 64 x 6); split s takes the
// 64-deep K tiles [s nk / S, (s + 1) nk / S).  CTA c takes items c, c +
// grid, ...  The producer's lane 0 streams an item's K tiles through a
// four-stage TMA ring (x's [block_m x 64] tile from a 2-D map over [M, K],
// w's [64 x 128] tile as two 64-column boxes of a 3-D map over [E, K, N],
// so a ragged K or N tile reads zeros, never the next expert's rows; the
// 128-byte swizzle), running ahead into the next item.  Consumer warp w
// owns columns 32 w .. 32 w + 31: per 64-deep stage it loads x with
// ldmatrix and w with ldmatrix.trans (w's rows are N-contiguous) and runs
// 4 k-steps x 4 n8 tiles x block_m / 16 mma, then frees the stage and adds
// the slice into its accumulators.  With S = 1 it rounds to bf16 and
// stores; else it writes its float32 partial to a scratch, adds one to
// the tile's counter, and the tile's last CTA adds the S partials in split
// order, rounds once to bf16, stores, and sets the counter back to 0.  No
// float atomics.  Before its items, every CTA writes its share of the
// empty blocks' zero rows.

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;

constexpr int TK = 64;        // K depth of a stage
constexpr int TN = 128;       // output columns per item
constexpr int STAGES = 4;
constexpr int ROW = 128;      // bytes per swizzled tile row (64 bf16)
constexpr int NCW = 4;        // consumer warps
constexpr int NTH = 32 * (NCW + 1);
constexpr int S_MAX = 16;     // K splits at most

template <int MT>             // m16 tiles per row block: block_m = 16 MT
struct Layout {
  static constexpr int X_STAGE = 16 * MT * ROW;        // [16 MT][64]
  static constexpr int W_STAGE = (TN / 64) * TK * ROW;  // 2 x [64][64]
  static constexpr int STAGE = X_STAGE + W_STAGE;
  static constexpr int BAR = STAGES * STAGE;            // full[S], free[S]
  static constexpr int BYTES = BAR + 8 * 2 * STAGES + 16;  // + a flag
};

// The number of blocks with nvalid > 0 (one warp).
__device__ int count_valid(const int* __restrict__ nvalid, int nblocks) {
  int c = 0;
  for (int b0 = 0; b0 < nblocks; b0 += 32) {
    const int bi = b0 + threadIdx.x % 32;
    c += __popc(__ballot_sync(0xffffffffu, bi < nblocks && nvalid[bi] > 0));
  }
  return c;
}

// The id of the r-th (from 0) block with nvalid > 0 (one warp).
__device__ int valid_block(const int* __restrict__ nvalid, int nblocks,
                           int r) {
  for (int b0 = 0; b0 < nblocks; b0 += 32) {
    const int bi = b0 + threadIdx.x % 32;
    unsigned m =
        __ballot_sync(0xffffffffu, bi < nblocks && nvalid[bi] > 0);
    const int c = __popc(m);
    if (r < c) {
      for (int i = 0; i < r; ++i) m &= m - 1;
      return b0 + __ffs(m) - 1;
    }
    r -= c;
  }
  return -1;
}

struct Item {
  int tile, split, blk, ex, n0, k0, k1;   // k0, k1 in K tiles
};

__device__ Item item_of(int w, int S, int nt, int nk,
                        const int* __restrict__ block_expert,
                        const int* __restrict__ nvalid, int nblocks, int E) {
  Item it;
  it.tile = w / S;
  it.split = w - it.tile * S;
  it.blk = valid_block(nvalid, nblocks, it.tile / nt);
  it.n0 = (it.tile % nt) * TN;
  it.k0 = it.split * nk / S;
  it.k1 = (it.split + 1) * nk / S;
  it.ex = block_expert[it.blk];
  if (it.ex < 0 || it.ex >= E) __trap();  // an expert id out of range is a bug
  return it;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCW * 32) : "memory");
}

template <int MT>
__global__ void __launch_bounds__(NTH)
gmm_dec_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const int* __restrict__ block_expert,
               const int* __restrict__ nvalid,
               __nv_bfloat16* __restrict__ out, float* __restrict__ scratch,
               int* __restrict__ counters, int M, int K, int N, int E) {
  using L = Layout<MT>;
  constexpr int BM = 16 * MT;
  const int nblocks = M / BM, nt = (N + TN - 1) / TN, nk = (K + TK - 1) / TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this CTA's share of the empty blocks' zero rows (16-byte chunks)
  const int cpr = N / 8;
  for (long long c = (long long)blockIdx.x * NTH + threadIdx.x;
       c < (long long)M * cpr; c += (long long)gridDim.x * NTH) {
    const int row = (int)(c / cpr);
    if (nvalid[row / BM] <= 0)
      *reinterpret_cast<uint4*>(out + (size_t)row * N +
                                (c - (long long)row * cpr) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // the work list, the same in every CTA
  const int nvb = count_valid(nvalid, nblocks);
  if (nvb == 0) return;
  const int S = max(1, min(min((int)gridDim.x / (nvb * nt), nk), S_MAX));
  const int W = nvb * nt * S;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* free_ = full + STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(free_ + STAGES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(free_ + s, NCW);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NCW) {  // the producer warp: TMA loads by lane 0
    int it = 0;       // stages filled so far, over all items
    for (int w = blockIdx.x; w < W; w += gridDim.x) {
      const Item I = item_of(w, S, nt, nk, block_expert, nvalid, nblocks, E);
      if (lane == 0) {
        for (int kt = I.k0; kt < I.k1; ++kt) {
          const int s = (it + kt - I.k0) % STAGES;
          const int ph = (it + kt - I.k0) / STAGES;
          mbar_wait(free_ + s, (ph & 1) ^ 1);
          mbar_expect_tx(full + s, L::STAGE);
          uint8_t* st = smem + s * L::STAGE;
          tma_load_2d(st, &tx, full + s, kt * TK, I.blk * BM);
          for (int a = 0; a < TN / 64; ++a)
            tma_load_3d(st + L::X_STAGE + a * TK * ROW, &tw, full + s,
                        I.n0 + 64 * a, kt * TK, I.ex);
        }
      }
      it += I.k1 - I.k0;
    }
    return;
  }

  // a consumer warp: columns 32 warp .. + 31 of each item's tile
  const int g = lane / 4, t = lane % 4;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  int it = 0;
  for (int w = blockIdx.x; w < W; w += gridDim.x) {
    const Item I = item_of(w, S, nt, nk, block_expert, nvalid, nblocks, E);
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    for (int kt = I.k0; kt < I.k1; ++kt, ++it) {
      const int s = it % STAGES;
      const uint8_t* xs = smem + s * L::STAGE;
      const uint8_t* ws = xs + L::X_STAGE + (warp / 2) * (TK * ROW);
      mbar_wait(full + s, (it / STAGES) & 1);
      float part[MT][4][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t a[MT][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(a[mt], xs + sw128(16 * mt + (lane & 15),
                                        2 * kk + (lane >> 4)));
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldmatrix_x4_trans(b[p], ws + sw128(16 * kk + (lane & 15),
                                             4 * (warp % 2) + 2 * p +
                                                 (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = b[j / 2][2 * (j % 2)];
            const uint32_t b1 = b[j / 2][2 * (j % 2) + 1];
            if (kk == 0)
              mma_bf16_16816(part[mt][j], a[mt], b0, b1, zero);
            else
              mma_bf16_16816(part[mt][j], a[mt], b0, b1, part[mt][j]);
          }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(free_ + s);   // this warp is done with s
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
    }

    // fragment (mt, j, e): row 16 mt + g + 8 (e / 2), column 32 warp +
    // 8 j + 2 t + e % 2 of the tile
    const int row0 = I.blk * BM, col0 = I.n0 + 32 * warp + 2 * t;
    if (S == 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col0 + 8 * j;
          if (c >= N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (size_t)(row0 + 16 * mt + g + 8 * h) * N + c) =
                __floats2bfloat162_rn(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
      continue;
    }
    float* sp = scratch + (size_t)w * BM * TN;   // w = tile S + split
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              sp + (16 * mt + g + 8 * h) * TN + 32 * warp + 8 * j + 2 * t) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
    __threadfence();
    consumers_sync();
    if (threadIdx.x == 0) *flag = atomicAdd(counters + I.tile, 1) == S - 1;
    consumers_sync();
    if (!*flag) continue;
    __threadfence();    // the tile's last CTA: the splits in order
    const float* tp = scratch + (size_t)I.tile * S * BM * TN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off =
              (16 * mt + g + 8 * h) * TN + 32 * warp + 8 * j + 2 * t;
          float2 sum = __ldcg(reinterpret_cast<const float2*>(tp + off));
          for (int s = 1; s < S; ++s) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(
                tp + (size_t)s * BM * TN + off));
            sum.x += v.x;
            sum.y += v.y;
          }
          if (c < N)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (size_t)(row0 + 16 * mt + g + 8 * h) * N + c) =
                __floats2bfloat162_rn(sum.x, sum.y);
        }
      }
    if (threadIdx.x == 0) counters[I.tile] = 0;
  }
}

template <int MT>
cudaError_t launch(const void* x, const void* w, const int* be,
                   const int* nv, void* out, float* scratch, int* counters,
                   int M, int K, int N, int E, int grid_max,
                   cudaStream_t stream) {
  using L = Layout<MT>;
  CUtensorMap mx, mw;
  const uint64_t B2 = sizeof(__nv_bfloat16);
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)M}, sx[1] = {K * B2};
  const uint64_t dw[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t sw[2] = {N * B2, (uint64_t)K * N * B2};
  const uint32_t bx[2] = {TK, 16 * MT}, bw[3] = {64, TK, 1};
  if (!hopper_host::encode_bf16(&mx, x, 2, dx, sx, bx) ||
      !hopper_host::encode_bf16(&mw, w, 3, dw, sw, bw))
    return cudaErrorInvalidValue;
  const int smem = L::BYTES + 1024;   // + the base's alignment to 1024
  // resident CTAs an SM at this shared memory, asked once per process
  static int resident = 0, n_sm = 0;
  if (!resident) {
    cudaError_t err = cudaFuncSetAttribute(
        gmm_dec_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &resident, gmm_dec_kernel<MT>, NTH, smem)) != cudaSuccess)
      return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const int grid = min(grid_max, resident * n_sm);
  gmm_dec_kernel<MT><<<grid, NTH, smem, stream>>>(
      mx, mw, be, nv, static_cast<__nv_bfloat16*>(out), scratch, counters,
      M, K, N, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 x [M, K], w [E, K, N], int32 block_expert / nvalid [M / block_m],
// bf16 out [M, N]; contiguous, 16-byte aligned; block_m 16 or 32 dividing
// M, K and N multiples of 8.  scratch: float32 [grid_max block_m 128];
// counters: int32 [grid_max], all zero (left zero).  Runs at most
// grid_max CTAs.  Returns a cudaError_t (cudaErrorInvalidValue for a shape
// or pointer it does not take, or a tensor map that cannot be encoded).
int moe_gmm_dec(const void* x, const void* w, const void* block_expert,
                const void* nvalid, void* out, void* scratch, void* counters,
                int M, int K, int N, int E, int block_m, int grid_max,
                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || grid_max <= 0 ||
      (block_m != 16 && block_m != 32) || M % block_m || K % 8 || N % 8 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  const int* nv = static_cast<const int*>(nvalid);
  float* sc = static_cast<float*>(scratch);
  int* cn = static_cast<int*>(counters);
  return (int)(block_m == 32
                   ? launch<2>(x, w, be, nv, out, sc, cn, M, K, N, E,
                               grid_max, s)
                   : launch<1>(x, w, be, nv, out, sc, cn, M, K, N, E,
                               grid_max, s));
}

}  // extern "C"
