// Flash-attention forward for Hopper (sm_90a): causal or non-causal GQA
// softmax attention with an online (max, sum) softmax, float32 or bfloat16
// in, float32 accumulation.
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (_flash_fwd_kernel), and computes the function of the model's chunked
// jnp attention repro/models/layers.py:flash_attention (_flash_fwd_impl),
// whose cast points it keeps: scores q.k in float32 times the float32
// scale, masked to NEG_INF = -1e30 where key > query (causal), the
// probabilities p kept in float32 for P.V (the Pallas kernel casts p to
// v's dtype; the model does not, and this kernel follows the model), the
// row sum floored at 1e-30, and one cast of acc / l to the output dtype.
//
//   q [B, Sq, H, D], k [B, Sk, Kh, D], v [B, Sk, Kh, Dv] -> o [B, Sq, H, Dv]
//   query head h reads kv head h / G, G = H / Kh (group-major heads);
//   with a non-null lse [B, H, Sq] float32, also each row's log-sum-exp
//   m + log(max(l, 1e-30)) in natural-log units (the reference's
//   _flash_fwd_impl), which the backward (flash_attention_bwd.cu) reads.
//
// What bounds it on this card.  At the serving path's shapes (yi-9b:
// H = 32, Kh = 4, D = 128; stablelm-3b: H = Kh = 32, D = 80; S = 2048)
// the function is 2 S^2 H (D + Dv) / 2 flops (causal) against a few MB of
// q, k, v and o: over 1000 flops a byte, far above the card's ridge
// point, so the bound is operations (989 TFLOP/s on bf16 tensor cores).
// This kernel does its products with float32 FMAs on the CUDA cores
// (67 TFLOP/s peak), fed from shared memory, so it is bound by CUDA-core
// issue and shared-memory bandwidth, an order of magnitude above that
// bound.  It serves float32 (at float32 precision, which the tensor cores
// would not keep) and shapes the tensor-core kernel does not take; bf16
// with head dims of multiples of 16 up to 128 goes to
// flash_attention_tc.cu (wgmma fed by TMA; kernel.py's _flash_route).
//
// Design.  One CTA of 256 threads per (64-row query tile, head, batch).
// The query tile and each 64-key K/V tile are staged in shared memory as
// float32 (rows padded to an odd stride, so the 16 lanes that read 16
// different keys hit 16 different banks).  Each thread owns a 4 x 4 block
// of the 64 x 64 score tile (rows 4*(t/16) + i, keys t%16 + 16*j): the 16
// threads of one row group are one half-warp, so the row max and row sum
// reduce with four xor-shuffles.  Each thread keeps (m, l) for its 4 rows
// and the float32 accumulator for 4 rows x 8 output columns
// (t%16 + 16*jj, Dv <= 128).  Causal tiles wholly above the diagonal are
// skipped: exact, since every row has seen key 0 in the first tile, after
// which a masked score's exp(-1e30 - m) is exactly 0.  Keys past Sk (a
// ragged last tile) score -inf and add exactly 0.  Shared memory is
// 4 (2*64*(D+1) + 64*Dv + 64*65) bytes: 115 KB at D = Dv = 128, above the
// default 48 KB, so the launch raises the kernel's dynamic limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per K/V tile
constexpr int NT = 256;          // threads per CTA
constexpr int RPT = 4;           // score rows per thread
constexpr int CPT = BK / 16;     // score columns per thread (stride 16)
constexpr int DV_MAX = 128;
constexpr int VPT = DV_MAX / 16; // output columns per thread (stride 16)
constexpr int PS = BK + 1;       // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Kh,
                 int D, int Dv, float scale, int causal) {
  extern __shared__ float smem[];
  const int ds = D + 1;
  float* Qs = smem;              // [BQ][ds]
  float* Ks = Qs + BQ * ds;      // [BK][ds]
  float* Vs = Ks + BK * ds;      // [BK][Dv]
  float* Ps = Vs + BK * Dv;      // [BQ][PS]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, rg = tid / 16, cl = tid % 16;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e - r * D, qi = q0 + r;
    Qs[r * ds + d] =
        qi < Sq ? to_f32(q[((size_t)(b * Sq + qi) * H + h) * D + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][VPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < VPT; ++jj) acc[i][jj] = 0.f;
  }

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done (and Q is in)
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e - r * D, ki = k0 + r;
      Ks[r * ds + d] =
          ki < Sk ? to_f32(k[((size_t)(b * Sk + ki) * Kh + kh) * D + d]) : 0.f;
    }
    for (int e = tid; e < BK * Dv; e += NT) {
      const int r = e / Dv, d = e - r * Dv, ki = k0 + r;
      Vs[r * Dv + d] =
          ki < Sk ? to_f32(v[((size_t)(b * Sk + ki) * Kh + kh) * Dv + d])
                  : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg * RPT + i) * ds + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(cl + 16 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i, qi = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int ki = k0 + cl + 16 * j;
        float x = s[i][j] * scale;
        if (ki >= Sk) x = -INFINITY;
        else if (causal && ki > qi) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * PS + cl + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < VPT; ++jj) acc[i][jj] *= corr;
    }
    __syncwarp();  // a row group's P row is written and read by one half-warp

    const int kn = min(BK, Sk - k0);
    for (int c = 0; c < kn; ++c) {
      float vv[VPT];
#pragma unroll
      for (int jj = 0; jj < VPT; ++jj) {
        const int dv = cl + 16 * jj;
        vv[jj] = dv < Dv ? Vs[c * Dv + dv] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(rg * RPT + i) * PS + c];
#pragma unroll
        for (int jj = 0; jj < VPT; ++jj) acc[i][jj] += p * vv[jj];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && cl == 0)
      lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(li);
    T* orow = o + ((size_t)(b * Sq + qi) * H + h) * Dv;
#pragma unroll
    for (int jj = 0; jj < VPT; ++jj) {
      const int dv = cl + 16 * jj;
      if (dv < Dv) store(orow + dv, acc[i][jj] / li);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int Kh, int D,
                   int Dv, float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * BQ * (D + 1) + (size_t)BK * Dv +
                       (size_t)BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, Kh, D,
      Dv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int attn_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int H, int Kh, int D,
                   int Dv, float scale, int causal, int is_bf16,
                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh ||
      D <= 0 || Dv <= 0 || Dv > DV_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, H,
                                               Kh, D, Dv, scale, causal, s)
                       : launch<float>(q, k, v, o, l, B, Sq, Sk, H, Kh, D,
                                       Dv, scale, causal, s));
}

// The message of a cudaError_t returned by any entry point of the
// attention library (this file and decode_attention.cu).
const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
