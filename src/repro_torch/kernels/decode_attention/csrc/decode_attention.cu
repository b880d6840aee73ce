// Flash-decoding for Hopper (sm_90a): one query token per sequence against
// a KV cache masked by the sequence's position, float32 or bfloat16 in,
// float32 accumulation.
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/decode_attention/kernel.py:decode_attention_fwd
// (_decode_kernel), and computes the function of the model's
// repro/models/layers.py:attention_decode: scores q.k in float32 times
// the float32 scale, positions > pos[b] masked, softmax and P.V in
// float32, one cast to the output dtype.
//
//   q [B, H, D], k [B, Sk, Kh, D], v [B, Sk, Kh, Dv], pos [B] int32
//   -> o [B, H, Dv];  query head h reads kv head h / G (group-major).
//
// What bounds it on this card.  It reads each valid cache row once and
// does 2 (D + Dv) flops per row and query head: G = H / Kh flops per
// byte of cache at most (8 for yi-9b, 1 for stablelm-3b), far below the
// ridge point, so the bound is bytes: (pos + 1) Kh (D + Dv) elements per
// sequence over 3.35 TB/s.  At batch 1 the grid of the Pallas kernel,
// (B, Kh), would be 4 CTAs for yi-9b: 4 of 132 SMs, a few percent of the
// memory rate.
//
// Design: flash-decoding in two kernels.  decode_split_kernel runs one
// 128-thread CTA per (split, kv head, batch); split s covers the KC
// positions [s KC, (s + 1) KC) cut at pos[b] + 1, so the grid has about
// four CTAs per SM whatever B and Kh are, and positions > pos are never
// read (exact: position 0 is always valid, so a skipped position's
// weight would be exp(-1e30 - m) = 0).  Its G query heads sit in shared
// memory; each thread scores whole cache rows (one k row read, G dot
// products), the scores go to shared memory, one warp per head takes the
// split's max and exp-sum, and each thread accumulates P.V for one output
// column and all G heads (v rows read coalesced across threads).  The
// partial (m, l, acc) of every (b, h, split) goes to a float32 scratch;
// decode_combine_kernel rescales the partials by exp(m_s - M) and divides
// by max(sum, 1e-30).  An empty split writes m = -inf, l = 0 and
// contributes exactly 0.  pos < 0 masks every position to -1e30, as the
// reference's mask does, which gives the mean of v over all Sk rows.
// The error strings of this library live in flash_attention.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per CTA
constexpr int G_MAX = 64;        // query heads per kv head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// GM: a compile-time bound on G (the register arrays' size); g < G guards.
template <typename T, int GM>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int Sk, int H, int Kh,
                    int D, int Dv, int KC, int n_split, float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh, tid = threadIdx.x;
  float* Qs = smem;              // [G][D]
  float* Ss = Qs + G * D;        // [G][KC]

  const int p = pos[b];
  const bool all_masked = p < 0;
  const int n_valid = all_masked ? Sk : min(p + 1, Sk);
  const int start = split * KC, end = min(start + KC, n_valid);
  // partial (b, h, split) for h = kh * G + g sits at part + g * n_split
  const size_t part = ((size_t)b * H + (size_t)kh * G) * n_split + split;

  if (start >= end) {
    for (int g = tid; g < G; g += NT) {
      part_m[part + (size_t)g * n_split] = -INFINITY;
      part_l[part + (size_t)g * n_split] = 0.f;
    }
    for (int e = tid; e < G * Dv; e += NT) {
      const int g = e / Dv, d = e - g * Dv;
      part_acc[(part + (size_t)g * n_split) * Dv + d] = 0.f;
    }
    return;
  }

  for (int e = tid; e < G * D; e += NT)
    Qs[e] = to_f32(q[((size_t)b * H + (size_t)kh * G) * D + e]);
  __syncthreads();

  const int n = end - start;
  for (int i = tid; i < n; i += NT) {
    const T* kr = k + ((size_t)(b * Sk + start + i) * Kh + kh) * D;
    float sc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) sc[g] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = to_f32(kr[d]);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) sc[g] += Qs[g * D + d] * kd;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) Ss[g * KC + i] = all_masked ? NEG_INF : sc[g] * scale;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += NT / 32) {
    float* row = Ss + g * KC;
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, row[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(row[i] - mx);
      row[i] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      part_m[part + (size_t)g * n_split] = mx;
      part_l[part + (size_t)g * n_split] = sum;
    }
  }
  __syncthreads();

  for (int dv = tid; dv < Dv; dv += NT) {
    float acc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) acc[g] = 0.f;
    const T* vc = v + ((size_t)(b * Sk + start) * Kh + kh) * Dv + dv;
    const size_t vstride = (size_t)Kh * Dv;
    for (int i = 0; i < n; ++i) {
      const float vv = to_f32(vc[i * vstride]);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) acc[g] += Ss[g * KC + i] * vv;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) part_acc[(part + (size_t)g * n_split) * Dv + dv] = acc[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ o,
                      int H, int Dv, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * H + h) * n_split;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_m[base + s]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s)
    L += part_l[base + s] * expf(part_m[base + s] - M);
  L = fmaxf(L, 1e-30f);
  for (int dv = threadIdx.x; dv < Dv; dv += NT) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s)
      acc += part_acc[(base + s) * Dv + dv] * expf(part_m[base + s] - M);
    store(o + ((size_t)b * H + h) * Dv + dv, acc / L);
  }
}

template <typename T, int GM>
cudaError_t launch_gm(const void* q, const void* k, const void* v,
                      const int* pos, float* pm, float* pl, float* pa,
                      void* o, int B, int Sk, int H, int Kh, int D, int Dv,
                      int KC, int n_split, float scale, cudaStream_t stream) {
  const int G = H / Kh;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * KC);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, GM><<<dim3(n_split, Kh, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, pm, pl, pa, Sk, H, Kh, D, Dv, KC,
      n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(H, B), NT, 0, stream>>>(
      pm, pl, pa, static_cast<T*>(o), H, Dv, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, float* pm, float* pl, float* pa, void* o,
                   int B, int Sk, int H, int Kh, int D, int Dv, int KC,
                   int n_split, float scale, cudaStream_t s) {
  const int G = H / Kh;
#define DECODE_GM(N)                                                      \
  if (G <= N)                                                             \
    return launch_gm<T, N>(q, k, v, pos, pm, pl, pa, o, B, Sk, H, Kh, D,  \
                           Dv, KC, n_split, scale, s);
  DECODE_GM(1)
  DECODE_GM(2)
  DECODE_GM(4)
  DECODE_GM(8)
  DECODE_GM(16)
  DECODE_GM(32)
  DECODE_GM(64)
#undef DECODE_GM
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int attn_decode_fwd(const void* q, const void* k, const void* v,
                    const void* pos, void* part_m, void* part_l,
                    void* part_acc, void* o, int B, int Sk, int H, int Kh,
                    int D, int Dv, int KC, int n_split, float scale,
                    int is_bf16, void* stream) {
  if (B <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh || H / Kh > G_MAX ||
      D <= 0 || Dv <= 0 || KC <= 0 || n_split <= 0 ||
      (long long)KC * n_split < Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(q, k, v, p, pm, pl, pa, o, B,
                                               Sk, H, Kh, D, Dv, KC, n_split,
                                               scale, s)
                       : launch<float>(q, k, v, p, pm, pl, pa, o, B, Sk, H,
                                       Kh, D, Dv, KC, n_split, scale, s));
}

}  // extern "C"
