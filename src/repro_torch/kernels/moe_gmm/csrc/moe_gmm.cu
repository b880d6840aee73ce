// Grouped matmul for Hopper (sm_90a): the MoE expert products
// out[i] = x[i] @ w[e(i)] over expert-sorted rows, float32 or bfloat16 in,
// float32 accumulation, one rounding to the input dtype.
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/moe_gmm/kernel.py:gmm (_gmm_kernel) and computes its
// function:
//
//   x [M, K] (M % block_m == 0), w [E, K, N], block_expert [M / block_m],
//   nvalid [M / block_m] (int32) -> out [M, N] in x's dtype
//   out[mi*bm : (mi+1)*bm] = x[mi*bm : (mi+1)*bm] @ w[block_expert[mi]]
//                            if nvalid[mi] > 0, else 0.
//
// A row block with nvalid > 0 computes all block_m rows, padding rows
// included, as the Pallas kernel does; a block with nvalid == 0 writes
// zeros and reads neither its rows of x nor its expert's weights.
//
// What bounds it on this card.  At moonshot-v1-16b-a3b's prefill (E = 64,
// C = 240 rows per expert padded to 256, K = 2048, N = 1408) a call with
// every block valid is 2 * 16384 * 2048 * 1408 = 94 GFLOP against 482 MB
// of x, weights and output in bf16: ~195 flops a byte, just below the
// card's ridge (~295), so bytes (0.14 ms at 3.35 TB/s) bound it a little
// above operations (0.095 ms at 989 TFLOP/s on bf16 tensor cores).  At
// decode one token fills 6 of 64 experts, one row each: the function
// reads 6 experts' weights (35 MB in bf16) and does almost no arithmetic,
// so the bound is bytes (~10 us).  This kernel does its products with
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), fed from shared
// memory, so a prefill-sized block runs far above its bound; bf16 blocks
// of a multiple of 64 rows go to moe_gmm_tc.cu (wgmma fed by TMA;
// kernel.py's _gmm_route), and this one serves the decode blocks of 16
// and 32 rows, float32 and ragged shapes.  At decode what the design does
// about the bytes bound is the skip: only valid blocks read weights, so a
// step reads 6 experts' weights, not 64.
//
// Design.  One CTA of 256 threads (16 x 16) per (TM-row tile, 64-column
// tile); TM divides block_m, so a tile lies in one row block, whose
// block_expert / nvalid entry the CTA reads itself (the Pallas kernel's
// scalar prefetch).  A loop over K in TK-deep tiles takes the place of the
// Pallas grid's sequential k axis: x's TM x TK tile (transposed) and w's
// TK x 64 tile are staged in shared memory as float32, and each thread
// keeps a (TM/16) x 4 block of float32 accumulators in registers.  The next
// K tile is loaded into registers (16-byte loads where the shapes allow)
// while the current one is multiplied.  The tile shape follows block_m:
// TM = 64 with TK = 32 for prefill-sized blocks, TM = 16 with TK = 128 for
// decode's 16-row blocks, where deeper tiles keep more weight bytes in
// flight.  Ragged edges (K or N not a multiple of the tile) load zeros
// and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per CTA, 16 x 16
constexpr int TN = 64;   // output columns per CTA
constexpr int RN = 4;    // output columns per thread: 4 * tx + j

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The bits of element v of a 16-byte chunk, as the low bits of a word.
__device__ __forceinline__ uint32_t bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// One 16-byte chunk (16 / sizeof(T) elements) of a row, starting at column
// col; elements at or past ncols, and every element of a row that is out
// of range (!ok), read as 0.  With VEC, col and ncols are multiples of the
// chunk and the row is 16-byte aligned, so a chunk is wholly in or out.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row,
                                            int col, int ncols, bool ok) {
  constexpr int V = 16 / sizeof(T), PER = 4 / sizeof(T);
  if (!ok || col >= ncols) return make_uint4(0u, 0u, 0u, 0u);
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + col));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (col + v < ncols)
      w[v / PER] |= bits(row[col + v]) << (32 / PER * (v % PER));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The V elements of a chunk as float32 (bfloat16 is float32's top half).
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&a)[RN]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&a)[RN]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&a)[RN]) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(a[0], a[1]);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(a[2], a[3]);
}

template <typename T, int TM, int TK, bool VEC>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int* __restrict__ block_expert,
           const int* __restrict__ nvalid, T* __restrict__ out, int K, int N,
           int E, int block_m) {
  constexpr int V = 16 / sizeof(T);       // elements per 16-byte chunk
  constexpr int RM = TM / 16;             // output rows per thread
  constexpr int A_CH = TM * TK / V, B_CH = TK * TN / V;
  constexpr int A_IT = (A_CH + NT - 1) / NT, B_IT = (B_CH + NT - 1) / NT;
  constexpr int A_CPR = TK / V, B_CPR = TN / V;  // chunks per tile row
  constexpr int AS = TM + 4, BS = TN + 4;        // padded smem row strides
  __shared__ __align__(16) float As[TK * AS];  // As[k][m]: x tile, transposed
  __shared__ __align__(16) float Bs[TK * BS];  // Bs[k][n]: w tile

  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int blk = m0 / block_m;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  if (nvalid[blk] <= 0) {  // an empty block: zeros, and no reads of x or w
    for (int e = tid; e < TM * TN; e += NT) {
      const int c = n0 + e % TN;
      if (c < N) out[(size_t)(m0 + e / TN) * N + c] = from_f32<T>(0.f);
    }
    return;
  }
  const int ex = block_expert[blk];
  if (ex < 0 || ex >= E) __trap();  // an expert id out of range is a bug
  const T* xb = x + (size_t)m0 * K;
  const T* wb = w + (size_t)ex * K * N;

  uint4 ra[A_IT], rb[B_IT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int c = tid + i * NT;
      const int r = c / A_CPR, kk = (c % A_CPR) * V;
      ra[i] = load_chunk<T, VEC>(xb + (size_t)r * K, k0 + kk, K, c < A_CH);
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int c = tid + i * NT;
      const int r = c / B_CPR, nn = (c % B_CPR) * V;
      rb[i] = load_chunk<T, VEC>(wb + (size_t)(k0 + r) * N, n0 + nn, N,
                                 c < B_CH && k0 + r < K);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int c = tid + i * NT;
      if (c >= A_CH) break;
      const int r = c / A_CPR, kk = (c % A_CPR) * V;
      float f[V];
      unpack(ra[i], f);
#pragma unroll
      for (int v = 0; v < V; ++v) As[(kk + v) * AS + r] = f[v];
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int c = tid + i * NT;
      if (c >= B_CH) break;
      const int r = c / B_CPR, nn = (c % B_CPR) * V;
      float f[V];
      unpack(rb[i], f);
#pragma unroll
      for (int v = 0; v < V; ++v) Bs[r * BS + nn + v] = f[v];
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int nk = (K + TK - 1) / TK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt) __syncthreads();  // every thread is done reading the last tile
    stash();
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * TK);  // in flight during the products
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[k * AS + ty * RM + i];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k * BS + tx * RN]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] += a[i] * b.x;
        acc[i][1] += a[i] * b.y;
        acc[i][2] += a[i] * b.z;
        acc[i][3] += a[i] * b.w;
      }
    }
  }

  const int c = n0 + tx * RN;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    T* orow = out + (size_t)(m0 + ty * RM + i) * N;
    if (VEC && c + RN <= N) {
      store4<T>(orow + c, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (c + j < N) orow[c + j] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int TM, int TK>
cudaError_t launch(const void* x, const void* w, const int* be,
                   const int* nv, void* out, int M, int K, int N, int E,
                   int block_m, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = K % V == 0 && N % V == 0 &&
                   ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  const dim3 grid((N + TN - 1) / TN, M / TM);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vec)
    gmm_kernel<T, TM, TK, true>
        <<<grid, NT, 0, stream>>>(xp, wp, be, nv, op, K, N, E, block_m);
  else
    gmm_kernel<T, TM, TK, false>
        <<<grid, NT, 0, stream>>>(xp, wp, be, nv, op, K, N, E, block_m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const int* be,
                     const int* nv, void* out, int M, int K, int N, int E,
                     int block_m, cudaStream_t s) {
  if (block_m % 64 == 0)
    return launch<T, 64, 32>(x, w, be, nv, out, M, K, N, E, block_m, s);
  if (block_m % 32 == 0)
    return launch<T, 32, 64>(x, w, be, nv, out, M, K, N, E, block_m, s);
  return launch<T, 16, 128>(x, w, be, nv, out, M, K, N, E, block_m, s);
}

}  // namespace

extern "C" {

// x [M, K], w [E, K, N], block_expert / nvalid [M / block_m] int32, out
// [M, N]; one dtype (is_bf16), contiguous.  Returns a cudaError_t.
int moe_gmm(const void* x, const void* w, const void* block_expert,
            const void* nvalid, void* out, int M, int K, int N, int E,
            int block_m, int is_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || block_m <= 0 ||
      block_m % 16 || M % block_m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(block_expert);
  const int* nv = static_cast<const int*>(nvalid);
  return (int)(is_bf16
                   ? dispatch<__nv_bfloat16>(x, w, be, nv, out, M, K, N, E,
                                             block_m, s)
                   : dispatch<float>(x, w, be, nv, out, M, K, N, E, block_m,
                                     s));
}

const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
