// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of causal or
// non-causal GQA softmax attention from q, k, v, the forward's output o
// and its row log-sum-exp lse, and the output's gradient do; float32 or
// bfloat16 in, float32 accumulation.
//
// Replaces no Pallas kernel: the JAX reference trains through the jnp
// flash attention of repro/models/layers.py, whose custom-VJP backward
// _flash_bwd (layers.py:269) is two lax.scans, one pass for dq and one for
// (dk, dv), each recomputing the probability tiles from (q, k, lse).  This
// file is that backward as a kernel, with its cast points:
//   delta = rowsum(do.f32 * o.f32)            (o as the forward rounded it)
//   p     = exp(s * scale - lse), s = q.k in float32, masked scores
//           (key > query when causal) at NEG_INF = -1e30, so p = 0
//   dp    = do.f32 . v.f32
//   ds    = p * (dp - delta)
//   dq    = sum_k ds k.f32 * scale           -> cast to q's dtype
//   dv    = sum_q p do.f32,  dk = sum_q ds q.f32 * scale, each summed over
//           the G = H / Kh query heads of its kv head in float32 before
//           the one cast to k's and v's dtype.
//
//   q [B, Sq, H, D], k [B, Sk, Kh, D], v [B, Sk, Kh, Dv], o / do
//   [B, Sq, H, Dv], lse [B, H, Sq] float32 -> dq [B, Sq, H, D],
//   dk [B, Sk, Kh, D], dv [B, Sk, Kh, Dv]; D <= 256, Dv <= 128; query head
//   h reads kv head h / G.
//
// What bounds it on this card.  Five products a kept (query, key) pair,
// q.k, do.v, ds.k, p.do and ds.q: 2 (3 D + 2 Dv) flops, against a few MB
// of inputs and outputs; at the trained model's shapes (stablelm-3b: B 4,
// S 2048, H 32, D 80, causal) that is 215 GFLOP over 0.27 G kept pairs,
// far above the ridge point, so the bound is operations (989 TFLOP/s on
// the bf16 tensor cores).  This first kernel does its products with
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), fed from shared
// memory, and recomputes q.k and do.v in both passes (2 (4 D + 3 Dv) flops
// a pair), so it sits far above that bound; wgmma and TMA are later work.
//
// Design: three kernels on the caller's stream, no atomics, so every
// output is written by one thread in one order and a call is
// deterministic (a restarted training run repeats its steps bit for bit).
//   1. delta: one warp a (batch, query, head) row, lanes over Dv.
//   2. dq: one CTA of 256 threads a (64-row query tile, head, batch); the
//      query and do tiles stay in shared memory as float32, and the loop
//      walks the 64-key K / V tiles (to the diagonal when causal).  Each
//      thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//      4 (t / 16) + i, keys t % 16 + 16 j; the 16 threads of a row group
//      are one half-warp), computes p and ds there, writes ds to a shared
//      tile read back by its own half-warp, and adds ds . k into 4 rows x
//      D / 16 columns of the dq accumulator.
//   3. dk / dv: one CTA a (64-key tile, kv head, batch); the K and V tiles
//      stay in shared memory, and the loop walks the G query heads and
//      their 64-row query tiles (from the diagonal when causal).  The
//      score tile is held transposed (rows are keys), p and then ds pass
//      through one shared tile, and the thread adds p . do and ds . q into
//      4 key rows x Dv / 16 and D / 16 columns of its accumulators.
// Shared rows are padded to an odd stride, so the 16 lanes that read 16
// different rows hit 16 different banks.  Shared memory at D = 256,
// Dv = 128: 4 (2 * 64 * 257 + 2 * 64 * 129 + 64 * 65 + 128) = 214 784 bytes,
// above the default 48 KB, so the launch raises each kernel's limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int NT = 256;           // threads per CTA
constexpr int RPT = 4;            // tile rows per thread
constexpr int CPT = 4;            // tile columns per thread (stride 16)
constexpr int D_MAX = 256;
constexpr int DV_MAX = 128;
constexpr int VPT = DV_MAX / 16;  // value columns per thread (stride 16)
constexpr int PS = 65;            // padded row stride of the p / ds tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [r0, r0 + 64) of a [S, heads, width] tensor's head `hd` of batch b
// into shared memory as float32 rows of stride width + 1 (zeros past S)
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int r0, int S, int heads,
                                      int hd, int width) {
  const int ws = width + 1;
  for (int e = threadIdx.x; e < 64 * width; e += NT) {
    const int r = e / width, d = e - r * width, ri = r0 + r;
    dst[r * ws + d] =
        ri < S ? to_f32(src[((size_t)(b * S + ri) * heads + hd) * width + d])
               : 0.f;
  }
}

// acc[i][j] = sum_d A[4 rg + i][d] * Bt[cl + 16 j][d] over a shared 64-row
// pair of tiles of width w (stride w + 1)
__device__ __forceinline__ void tile_dot(float (&acc)[RPT][CPT],
                                         const float* A, const float* Bt,
                                         int w, int rg, int cl) {
  const int ws = w + 1;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < w; ++d) {
    float a[RPT], bt[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = A[(rg * RPT + i) * ws + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) bt[j] = Bt[(cl + 16 * j) * ws + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] += a[i] * bt[j];
  }
}

// acc[i][jj] += sum_c P[4 rg + i][c] * X[c][cl + 16 jj] over the first n
// rows of a shared tile X of width w (stride w + 1); P of stride PS
template <int NC>
__device__ __forceinline__ void tile_acc(float (&acc)[RPT][NC],
                                         const float* P, const float* X,
                                         int n, int w, int rg, int cl) {
  const int ws = w + 1;
  for (int c = 0; c < n; ++c) {
    float x[NC], p[RPT];
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = cl + 16 * jj;
      x[jj] = col < w ? X[c * ws + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) p[i] = P[(rg * RPT + i) * PS + c];
    // columns past w are skipped, not multiplied by zero: the test is
    // uniform over a warp when w is a multiple of 16 (80: 5 of 8 columns)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      if (16 * jj < w)
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][jj] += p[i] * x[jj];
  }
}

// delta[b, h, i] = sum_dv do[b, i, h, dv] * o[b, i, h, dv] in float32
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int Sq, int H,
                       int Dv) {
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B * Sq * H) return;
  const size_t base = (size_t)row * Dv;
  float s = 0.f;
  for (int d = lane; d < Dv; d += 32)
    s += to_f32(dout[base + d]) * to_f32(o[base + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
    delta[((size_t)b * H + h) * Sq + i] = s;
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int Kh, int D, int Dv, float scale,
                    int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);       // [BK][D + 1]
  float* dOs = Ks + BK * (D + 1);      // [BQ][Dv + 1]
  float* Vs = dOs + BQ * (Dv + 1);     // [BK][Dv + 1]
  float* Ss = Vs + BK * (Dv + 1);      // [BQ][PS]: ds
  float* Ls = Ss + BQ * PS;            // [BQ]: lse
  float* Ds = Ls + BQ;                 // [BQ]: delta

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, rg = tid / 16, cl = tid % 16;

  stage(Qs, q, b, q0, Sq, H, h, D);
  stage(dOs, dout, b, q0, Sq, H, h, Dv);
  for (int r = tid; r < BQ; r += NT) {
    const bool in = q0 + r < Sq;
    const size_t at = ((size_t)b * H + h) * Sq + q0 + r;
    Ls[r] = in ? lse[at] : 0.f;
    Ds[r] = in ? delta[at] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done (and Q, dO are in)
    stage(Ks, k, b, k0, Sk, Kh, kh, D);
    stage(Vs, v, b, k0, Sk, Kh, kh, Dv);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot(s, Qs, Ks, D, rg, cl);
    tile_dot(dp, dOs, Vs, Dv, rg, cl);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cl + 16 * j, ki = k0 + c;
        const bool kept = ki < Sk && !(causal && ki > qi);
        const float p = kept ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ss[r * PS + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncwarp();  // a row group's ds row is written and read by a half-warp
    tile_acc<DPT>(acc, Ss, Ks, min(BK, Sk - k0), D, rg, cl);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= Sq) continue;
    T* row = dq + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int col = cl + 16 * jj;
      if (col < D) store(row + col, acc[i][jj] * scale);
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int Kh, int D,
                     int Dv, float scale, int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][D + 1]
  float* Qs = Ks + BK * (D + 1);       // [BQ][D + 1]
  float* Vs = Qs + BQ * (D + 1);       // [BK][Dv + 1]
  float* dOs = Vs + BK * (Dv + 1);     // [BQ][Dv + 1]
  float* Ps = dOs + BQ * (Dv + 1);     // [BK][PS]: p, then ds (key-major)
  float* Ls = Ps + BK * PS;            // [BQ]: lse
  float* Ds = Ls + BQ;                 // [BQ]: delta

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int tid = threadIdx.x, rg = tid / 16, cl = tid % 16;

  stage(Ks, k, b, k0, Sk, Kh, kh, D);
  stage(Vs, v, b, k0, Sk, Kh, kh, Dv);

  float acc_k[RPT][DPT], acc_v[RPT][VPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc_k[i][jj] = 0.f;
#pragma unroll
    for (int jj = 0; jj < VPT; ++jj) acc_v[i][jj] = 0.f;
  }

  const int nq = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;   // tiles wholly above the diagonal
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's readers are done (and K, V are in)
      stage(Qs, q, b, q0, Sq, H, h, D);
      stage(dOs, dout, b, q0, Sq, H, h, Dv);
      for (int r = tid; r < BQ; r += NT) {
        const bool in = q0 + r < Sq;
        const size_t at = ((size_t)b * H + h) * Sq + q0 + r;
        Ls[r] = in ? lse[at] : 0.f;
        Ds[r] = in ? delta[at] : 0.f;
      }
      __syncthreads();

      // the transposed tiles: rows are keys 4 rg + i, columns queries
      float s[RPT][CPT], dp[RPT][CPT];
      tile_dot(s, Ks, Qs, D, rg, cl);
      tile_dot(dp, Vs, dOs, Dv, rg, cl);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg * RPT + i, ki = k0 + r;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = cl + 16 * j, qi = q0 + c;
          const bool kept = ki < Sk && qi < Sq && !(causal && ki > qi);
          s[i][j] = kept ? expf(s[i][j] * scale - Ls[c]) : 0.f;   // p
          Ps[r * PS + c] = s[i][j];
        }
      }
      const int qn = min(BQ, Sq - q0);
      __syncwarp();
      tile_acc<VPT>(acc_v, Ps, dOs, qn, Dv, rg, cl);
      __syncwarp();  // the half-warp is done reading p
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = cl + 16 * j;
          Ps[(rg * RPT + i) * PS + c] = s[i][j] * (dp[i][j] - Ds[c]);
        }
      __syncwarp();
      tile_acc<DPT>(acc_k, Ps, Qs, qn, D, rg, cl);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int ki = k0 + rg * RPT + i;
    if (ki >= Sk) continue;
    T* krow = dk + ((size_t)(b * Sk + ki) * Kh + kh) * D;
    T* vrow = dv + ((size_t)(b * Sk + ki) * Kh + kh) * Dv;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int col = cl + 16 * jj;
      if (col < D) store(krow + col, acc_k[i][jj] * scale);
    }
#pragma unroll
    for (int jj = 0; jj < VPT; ++jj) {
      const int col = cl + 16 * jj;
      if (col < Dv) store(vrow + col, acc_v[i][jj]);
    }
  }
}

// DPT: head-dim columns per thread (stride 16), 8 for D <= 128, else 16
template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* delta, int B, int Sq, int Sk, int H,
                   int Kh, int D, int Dv, float scale, int causal,
                   cudaStream_t stream) {
  const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k),
          *v_ = static_cast<const T*>(v), *o_ = static_cast<const T*>(o),
          *do_ = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0,
                              stream>>>(o_, do_, delta, B, Sq, H, Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // both kernels stage two 64-row tiles of width D and two of width Dv,
  // one 64 x PS tile and two 64-float rows
  const size_t smem = sizeof(float) * ((size_t)2 * 64 * (D + 1) +
                                       (size_t)2 * 64 * (Dv + 1) +
                                       (size_t)64 * PS + 2 * 64);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DPT><<<dim3((Sq + BQ - 1) / BQ, H, B), NT, smem,
                           stream>>>(q_, k_, v_, do_, lse, delta,
                                     static_cast<T*>(dq), Sq, Sk, H, Kh, D,
                                     Dv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, DPT><<<dim3((Sk + BK - 1) / BK, Kh, B), NT, smem,
                            stream>>>(q_, k_, v_, do_, lse, delta,
                                      static_cast<T*>(dk),
                                      static_cast<T*>(dv), Sq, Sk, H, Kh, D,
                                      Dv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o, do, dq, dk, dv in one dtype (bf16 when is_bf16, else
// float32), lse [B, H, Sq] float32 from the forward, delta [B, H, Sq]
// float32 scratch; contiguous, layouts as above.  Launches the three
// kernels on `stream`; returns a cudaError_t (cudaErrorInvalidValue for a
// shape it does not take).
int attn_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                   const void* lse, const void* dout, void* dq, void* dk,
                   void* dv, void* delta, int B, int Sq, int Sk, int H,
                   int Kh, int D, int Dv, float scale, int causal,
                   int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh ||
      D <= 0 || Dv <= 0 || D > D_MAX || Dv > DV_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const auto run = [&](auto launcher) {
    return (int)launcher(q, k, v, o, l, dout, dq, dk, dv, dl, B, Sq, Sk, H,
                         Kh, D, Dv, scale, causal, s);
  };
  if (is_bf16)
    return D <= 128 ? run(launch<__nv_bfloat16, 8>)
                    : run(launch<__nv_bfloat16, 16>);
  return D <= 128 ? run(launch<float, 8>) : run(launch<float, 16>);
}

}  // extern "C"
