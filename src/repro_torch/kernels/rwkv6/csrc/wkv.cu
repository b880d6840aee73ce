// Chunked RWKV6 ("Finch") WKV recurrence for Hopper (sm_90a): float32 or
// bfloat16 r / k / v, float32 log decay, bonus and state, float32 arithmetic
// throughout and one rounding of y to r's dtype.
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/rwkv6/kernel.py:wkv_fwd (_wkv_kernel) and computes its
// function, with the state carried in and out:
//
//   r, k, v [B, S, H, N] (float32 or bfloat16), logw [B, S, H, N] float32,
//   u [H, N] float32, s0 [B, H, N, N] float32 (NULL: zeros)
//   -> y [B, S, H, N] in r's dtype, s_T [B, H, N, N] float32.
//
// Per head the state S is an [N, N] matrix and, step by step,
//   y_t = r_t (S + diag(u) k_tᵀ v_t),   S <- diag(e^{w_t}) S + k_tᵀ v_t.
// The kernel takes the reference's chunk-parallel form: per chunk of T
// steps, with c the inclusive cumulative sum of logw down the chunk and
// c_prev = the sum before the step,
//   y  = (r e^{c_prev}) S + tril_strict((r e^{c_prev})(k e^{-c})ᵀ) v
//        + diag(r · u · k) v
//   S <- e^{c_T} S + (k e^{c_T - c})ᵀ v.
// Chunks start at multiples of `chunk` (<= 64); the last may be shorter.
// The form overflows float32 once e^{-c} does (a per-step log decay below
// about -1.39 over 64 steps), as the reference's does; the kernel keeps it.
//
// What bounds it on this card.  At rwkv6-7b's prefill (B 1, S 2048, H 64,
// N 64, chunk 64) the function reads r / k / v (50.3 MB in bf16), logw
// (33.6 MB) and s0, and writes y (16.8 MB) and s_T: ~103 MB, 0.031 ms at
// 3.35 TB/s.  Its four products per chunk and head (r_dec S and the
// state update, T N^2 multiply-adds each; the causal scores and their
// product with v, T (T + 1) N / 2 each) are ~3.2 GFLOP, 0.048 ms on the
// float32 CUDA cores at 67 TFLOP/s: float32 operations bound it.  This
// first kernel does all its products with float32 FMAs on the CUDA cores
// from shared memory (it computes the full [T, T] score tile and masks
// it, and each column block recomputes the scores), so it runs well above
// that bound; mma.sync / wgmma for the products is later work.
//
// Design.  The Pallas grid (B, H, chunks) runs in order on one core with
// S in VMEM scratch.  Here a block of 256 threads owns one (b, h) and a
// slice of MV = 16 columns of v, and so of S and y (columns of v are
// independent: y[:, m] and S[:, m] need only v[:, m]), and loops over the
// chunks itself, keeping its [N, 16] slice of S in shared memory for the
// whole sweep.  At B 1, H 64, N 64 that is 256 blocks for the 132 SMs
// without any reduction across blocks; the price is that every column
// block computes the chunk's [T, T] scores again.  Per chunk the block
// stages r and k transposed ([n][t], rows padded to 68 floats so that a
// row is 16-byte aligned and a column read touches distinct banks for 8
// rows), logw ([t][n]) and its v columns in shared memory as float32;
// takes c down each column (one thread per n), decays r and k in place,
// forms the scores transposed (each thread a 4 x 4 tile, float4 reads of
// both operands), and then each thread computes 4 columns of one row of y
// and of one row of the new S in registers; the new S is stored after a
// barrier, since y reads the old one.  Rows past the chunk and heads
// narrower than 64 are zero-filled, so they add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int NM = 64;      // largest head size N
constexpr int TM = 64;      // largest chunk
constexpr int MV = 16;      // columns of v / S / y per block
constexpr int P = TM + 4;   // row stride (floats) of the [n][t] / [t][*] tiles

struct Smem {
  float rT[NM * P];    // r, then r e^{c_prev}, as [n][t]
  float kT[NM * P];    // k, then k e^{-c}, as [n][t]
  float A[TM * P];     // logw then c as [t][n]; then the scores as [j][i]
  float v[TM * MV];    // the block's columns of v, [t][m]
  float S[NM * MV];    // the block's columns of the state, [n][m]
  float ecT[NM];       // e^{c_T}
  float diag[TM];      // r_t · u · k_t
  float u[NM];
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ s_T, int S, int H,
               int N, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * MV;  // this block's first column
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t step = (size_t)H * N;                  // one time step
  const size_t base = (size_t)b * S * step + (size_t)h * N;
  const size_t sbase = ((size_t)b * H + h) * N * N;   // (b, h) of s0 / s_T

  for (int n = tid; n < NM; n += NT) sm.u[n] = n < N ? u[h * N + n] : 0.f;
  for (int i = tid; i < NM * MV; i += NT) {
    const int n = i / MV, m = m0 + i % MV;
    sm.S[i] = (s0 != nullptr && n < N && m < N) ? s0[sbase + n * N + m] : 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // scores: rows 4ty.., cols 4tx..
  const int p = tid / 4, q = tid % 4;      // y / S: row p, columns 4q..4q+3
  const int warp = tid / 32, lane = tid % 32;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int Tc = min(chunk, S - c0);
    // 1. stage the chunk; rows past Tc and heads past N read as zero
    for (int i = tid; i < TM * NM; i += NT) {
      const int t = i / NM, n = i % NM;
      float rv = 0.f, kv = 0.f, wv = 0.f;
      if (t < Tc && n < N) {
        const size_t g = base + (size_t)(c0 + t) * step + n;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        wv = logw[g];
      }
      sm.rT[n * P + t] = rv;
      sm.kT[n * P + t] = kv;
      sm.A[t * P + n] = wv;
    }
    for (int i = tid; i < TM * MV; i += NT) {
      const int t = i / MV, m = m0 + i % MV;
      sm.v[i] = (t < Tc && m < N)
                    ? to_f32(v[base + (size_t)(c0 + t) * step + m])
                    : 0.f;
    }
    __syncthreads();

    // 2. the bonus term r_t · u · k_t (a warp per row), and c = cumsum(logw)
    //    down each column, in place
    for (int t = warp; t < TM; t += NT / 32) {
      float d = 0.f;
      for (int n = lane; n < NM; n += 32)
        d += sm.rT[n * P + t] * sm.u[n] * sm.kT[n * P + t];
#pragma unroll
      for (int o = 16; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) sm.diag[t] = d;
    }
    if (tid < NM) {
      float c = 0.f;
      for (int t = 0; t < Tc; ++t) {
        c += sm.A[t * P + tid];
        sm.A[t * P + tid] = c;
      }
      sm.ecT[tid] = expf(c);
    }
    __syncthreads();

    // 3. r e^{c_prev} and k e^{-c}, in place
    for (int i = tid; i < TM * NM; i += NT) {
      const int t = i / NM, n = i % NM;
      if (t < Tc && n < N) {
        const float c_prev = t ? sm.A[(t - 1) * P + n] : 0.f;
        sm.rT[n * P + t] *= expf(c_prev);
        sm.kT[n * P + t] *= expf(-sm.A[t * P + n]);
      }
    }
    __syncthreads();

    // 4. the scores, transposed: A[j][i] = r_dec_i · k_dec_j for j < i,
    //    the bonus term for j == i, zero above (c is no longer read)
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      if (tx <= ty) {  // tiles wholly above the diagonal stay zero
        for (int n = 0; n < N; ++n) {
          const float4 ra = *reinterpret_cast<const float4*>(
              &sm.rT[n * P + 4 * ty]);
          const float4 kb = *reinterpret_cast<const float4*>(
              &sm.kT[n * P + 4 * tx]);
          const float ai[4] = {ra.x, ra.y, ra.z, ra.w};
          const float bj[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] += ai[a] * bj[e];
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * ty + a, j = 4 * tx + e;
          sm.A[j * P + i] = j < i ? acc[a][e] : (j == i ? sm.diag[i] : 0.f);
        }
    }
    __syncthreads();

    // 5. row p of y and of the new state, columns 4q..4q+3 of the block's
    {
      float ya[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < N; ++n) {
        const float rd = sm.rT[n * P + p];
        const float4 s =
            *reinterpret_cast<const float4*>(&sm.S[n * MV + 4 * q]);
        ya[0] += rd * s.x;
        ya[1] += rd * s.y;
        ya[2] += rd * s.z;
        ya[3] += rd * s.w;
      }
      for (int j = 0; j <= p && j < Tc; ++j) {  // A[j][p] is 0 for j > p
        const float a = sm.A[j * P + p];
        const float4 vv =
            *reinterpret_cast<const float4*>(&sm.v[j * MV + 4 * q]);
        ya[0] += a * vv.x;
        ya[1] += a * vv.y;
        ya[2] += a * vv.z;
        ya[3] += a * vv.w;
      }
      if (p < Tc) {
        T* yrow = y + base + (size_t)(c0 + p) * step;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 4 * q + e;
          if (m < N) yrow[m] = from_f32<T>(ya[e]);
        }
      }

      const float ec = sm.ecT[p];
      float sa[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Tc; ++j) {
        const float kd = sm.kT[p * P + j] * ec;  // k_j e^{c_T - c_j}
        const float4 vv =
            *reinterpret_cast<const float4*>(&sm.v[j * MV + 4 * q]);
        sa[0] += kd * vv.x;
        sa[1] += kd * vv.y;
        sa[2] += kd * vv.z;
        sa[3] += kd * vv.w;
      }
      float4 s = *reinterpret_cast<const float4*>(&sm.S[p * MV + 4 * q]);
      s.x = ec * s.x + sa[0];
      s.y = ec * s.y + sa[1];
      s.z = ec * s.z + sa[2];
      s.w = ec * s.w + sa[3];
      __syncthreads();  // every thread is done reading the old state
      *reinterpret_cast<float4*>(&sm.S[p * MV + 4 * q]) = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < NM * MV; i += NT) {
    const int n = i / MV, m = m0 + i % MV;
    if (n < N && m < N) s_T[sbase + n * N + m] = sm.S[i];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   void* y, float* s_T, int B, int S, int H, int N,
                   int chunk, cudaStream_t stream) {
  const dim3 grid((N + MV - 1) / MV, H, B);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  wkv_kernel<T><<<grid, NT, sizeof(Smem), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(y), s_T, S, H,
      N, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v [B, S, H, N] (one dtype: is_bf16), logw [B, S, H, N] float32,
// u [H, N] float32, s0 [B, H, N, N] float32 or NULL (zeros), y [B, S, H, N]
// in r's dtype, s_T [B, H, N, N] float32; all contiguous.  1 <= N <= 64,
// 1 <= chunk <= 64.  Returns a cudaError_t.
int wkv_fwd(const void* r, const void* k, const void* v, const void* logw,
            const void* u, const void* s0, void* y, void* s_T, int B, int S,
            int H, int N, int chunk, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > NM || chunk <= 0 ||
      chunk > TM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s = static_cast<const float*>(s0);
  float* sT = static_cast<float*>(s_T);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(r, k, v, w, uu, s, y, sT, B,
                                               S, H, N, chunk, st)
                       : launch<float>(r, k, v, w, uu, s, y, sT, B, S, H, N,
                                       chunk, st));
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
