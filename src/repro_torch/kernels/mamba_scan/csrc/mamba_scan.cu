// Mamba-1 selective scan for Hopper (sm_90a): float32 arithmetic and state
// throughout, one rounding of y to the output dtype.
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/mamba_scan/kernel.py:mamba_scan_fwd (_scan_kernel).  Two
// entries share one device recurrence (`recur`): per channel d and state n,
//
//   h_t = a_t h_{t-1} + b_t,        y_t[d] = sum_n h_t[d, n] C_t[n].
//
// * mamba_scan_fwd: the reference kernel's function.  a, b [B, S, d_in, N]
//   (float32 or bfloat16, pre-discretised), c [B, S, N] (float32 or
//   bfloat16) -> y [B, S, d_in] in a's dtype, from h = 0.
// * mamba_scan_fused: what the model calls.  dt [B, S, d_in] float32,
//   A [d_in, N] float32 (already -exp(A_log)), Bm and C [B, S, N] float32,
//   u [B, S, d_in] (float32 or bfloat16), h0 [B, d_in, N] float32 (NULL:
//   zeros) -> y [B, S, d_in] float32 and h_T [B, d_in, N] float32.  It
//   discretises inside the kernel, a = exp(dt A) and b = (dt Bm) u in the
//   order of the reference's repro/models/mamba.py:mamba_apply, so the
//   [B, S, d_in, N] tensors a and b never exist in device memory.
//
// What bounds it on this card.  At jamba-1.5-large's layer (B 1, S 2048,
// d_in 16384, N 16) the fused entry reads dt (134 MB), u (67 MB in bf16),
// A, Bm, C, h0 and writes y (134 MB) and h_T: ~337 MB, 0.10 ms at
// 3.35 TB/s.  It computes S d_in N = 537 M exponentials and ~8 float32
// operations beside each (4.3 G, 0.064 ms at 67 TFLOP/s); the
// exponentials run on the SFUs (16 per clock per SM, ~0.13 ms at
// 1.98 GHz: an estimate, not a published peak).  The reference entry
// moves a and b (2.15 GB each in float32): 4.4 GB, 1.32 ms, bytes.
//
// Design.  The Pallas grid (B, d_in blocks, chunks) runs in order on one
// core, with the [block_d, N] state in VMEM scratch and a sequential loop
// inside each chunk.  Here d_in is the parallel axis: one thread per
// channel, its N <= 16 states in registers, walking t itself in order;
// blocks of 128 channels, grid (d_in / 128, B): 128 blocks at jamba's
// shape, no reduction across threads or blocks.  The fused entry stages
// TC = 32 steps at a time in shared memory (the block's dt and u columns,
// and Bm / C, which every thread of the block reads), loading the next
// chunk into registers while it computes the current one, so a step waits
// on shared memory, not on device memory.  The reference entry reads each
// step's a and b rows (N contiguous values per thread, 16-byte vectors
// where N and the alignment allow) straight from device memory, with c
// staged per chunk like Bm and C.  States past N get a = 1 (or 0), b = 0,
// C = 0 and stay zero.  expf, not __expf: the function is held to the
// plain version at 1e-4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;    // channels (threads) per block
constexpr int NMAX = 16;   // largest state size N
constexpr int TC = 32;     // steps staged per chunk
constexpr int PER = TC * NMAX / NT;  // Bm / C values each thread stages

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
  return __float2bfloat16(v);
}

// The recurrence both entries share: one step of one state.
__device__ __forceinline__ void recur(float& h, float a, float b, float c,
                                      float& y) {
  h = a * h + b;
  y += h * c;
}

// One step's N values of one channel (a or b row), zero past N.  VEC: N
// values fill whole 16-byte vectors and the row is 16-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int N,
                                         float (&v)[NMAX]) {
  if constexpr (VEC) {
    constexpr int W = 16 / sizeof(T);
#pragma unroll
    for (int n = 0; n < NMAX; n += W) {
      if (n < N) {
        const uint4 q = *reinterpret_cast<const uint4*>(p + n);
        const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int j = 0; j < W; ++j) v[n + j] = to_f32<T>(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) v[n + j] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) v[n] = n < N ? to_f32<T>(p[n]) : 0.f;
  }
}

// This thread's share of a [TC, NMAX] tile of a [B, S, N] tensor (Bm, C or
// c) for the chunk at t0, zero past S and past N.
template <typename T>
__device__ __forceinline__ void fetch_tile(const T* __restrict__ x,
                                           size_t base, int t0, int S,
                                           int N, float (&r)[PER]) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * NT, t = i / NMAX, n = i % NMAX;
    r[k] = (t0 + t < S && n < N)
               ? to_f32<T>(x[base + (size_t)(t0 + t) * N + n]) : 0.f;
  }
}

__device__ __forceinline__ void stash_tile(float (*s)[NMAX],
                                           const float (&r)[PER]) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * NT;
    s[i / NMAX][i % NMAX] = r[k];
  }
}

template <typename T, typename TCc, bool VEC>
__global__ void __launch_bounds__(NT)
    scan_ab_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const TCc* __restrict__ c, T* __restrict__ y, int S,
                   int d_in, int N) {
  __shared__ __align__(16) float sc[TC][NMAX];
  const int bi = blockIdx.y;
  const int d = blockIdx.x * NT + threadIdx.x;
  const bool live = d < d_in;
  const size_t row = (size_t)d_in * N;          // a / b elements per step
  const size_t ab0 = (size_t)bi * S * row + (size_t)(live ? d : 0) * N;
  const size_t c0 = (size_t)bi * S * N;
  const size_t y0 = (size_t)bi * S * d_in + d;
  float h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) h[n] = 0.f;
  float pc[PER];
  fetch_tile(c, c0, 0, S, N, pc);
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                 // the previous chunk's readers are done
    stash_tile(sc, pc);
    __syncthreads();
    if (t0 + TC < S) fetch_tile(c, c0, t0 + TC, S, N, pc);
    if (!live) continue;
#pragma unroll 2
    for (int t = 0; t < tc; ++t) {
      float av[NMAX], bv[NMAX];
      const size_t off = ab0 + (size_t)(t0 + t) * row;
      load_row<T, VEC>(a + off, N, av);
      load_row<T, VEC>(b + off, N, bv);
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) recur(h[n], av[n], bv[n], sc[t][n], yv);
      y[y0 + (size_t)(t0 + t) * d_in] = from_f32<T>(yv);
    }
  }
}

template <typename U>
__global__ void __launch_bounds__(NT)
    scan_fused_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const U* __restrict__ u,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_T, int S, int d_in, int N) {
  __shared__ float s_dt[TC][NT];
  __shared__ float s_u[TC][NT];
  __shared__ __align__(16) float s_B[TC][NMAX];
  __shared__ __align__(16) float s_C[TC][NMAX];
  const int tid = threadIdx.x, bi = blockIdx.y;
  const int d = blockIdx.x * NT + tid;
  const bool live = d < d_in;
  const size_t x0 = (size_t)bi * S * d_in + d;  // [bi, 0, d] of dt / u / y
  const size_t n0 = (size_t)bi * S * N;         // [bi, 0, 0] of Bm / C
  const size_t h_base = ((size_t)bi * d_in + d) * N;

  float Ad[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool on = live && n < N;
    Ad[n] = on ? A[(size_t)d * N + n] : 0.f;
    h[n] = (on && h0 != nullptr) ? h0[h_base + n] : 0.f;
  }

  float p_dt[TC], p_u[TC], p_B[PER], p_C[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const bool on = live && t0 + j < S;
      const size_t i = x0 + (size_t)(t0 + j) * d_in;
      p_dt[j] = on ? dt[i] : 0.f;
      p_u[j] = on ? to_f32<U>(u[i]) : 0.f;
    }
    fetch_tile(Bm, n0, t0, S, N, p_B);
    fetch_tile(Cm, n0, t0, S, N, p_C);
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                 // the previous chunk's readers are done
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      s_dt[j][tid] = p_dt[j];
      s_u[j][tid] = p_u[j];
    }
    stash_tile(s_B, p_B);
    stash_tile(s_C, p_C);
    __syncthreads();
    if (t0 + TC < S) fetch(t0 + TC);   // in flight while this chunk runs
    if (!live) continue;
    for (int t = 0; t < tc; ++t) {
      const float dtv = s_dt[t][tid], uv = s_u[t][tid];
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
        recur(h[n], expf(dtv * Ad[n]), (dtv * s_B[t][n]) * uv, s_C[t][n],
              yv);
      y[x0 + (size_t)(t0 + t) * d_in] = yv;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) h_T[h_base + n] = h[n];
  }
}


template <typename T, typename TCc, bool VEC>
cudaError_t launch_ab(const void* a, const void* b, const void* c, void* y,
                      int B, int S, int d_in, int N, cudaStream_t stream) {
  const dim3 grid((d_in + NT - 1) / NT, B);
  scan_ab_kernel<T, TCc, VEC><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const TCc*>(c), static_cast<T*>(y), S, d_in, N);
  return cudaGetLastError();
}

template <typename T, typename TCc>
cudaError_t launch_ab_vec(const void* a, const void* b, const void* c,
                          void* y, int B, int S, int d_in, int N,
                          cudaStream_t stream) {
  const bool vec = (N * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return vec ? launch_ab<T, TCc, true>(a, b, c, y, B, S, d_in, N, stream)
             : launch_ab<T, TCc, false>(a, b, c, y, B, S, d_in, N, stream);
}

template <typename U>
cudaError_t launch_fused(const void* dt, const void* A, const void* Bm,
                         const void* u, const void* C, const void* h0,
                         void* y, void* h_T, int B, int S, int d_in, int N,
                         cudaStream_t stream) {
  const dim3 grid((d_in + NT - 1) / NT, B);
  scan_fused_kernel<U><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const U*>(u),
      static_cast<const float*>(C), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_T), S, d_in, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b [B, S, d_in, N] (one dtype: ab_bf16), c [B, S, N] (c_bf16), y
// [B, S, d_in] in a's dtype; all contiguous.  1 <= N <= 16.  Returns a
// cudaError_t.
int mamba_scan_fwd(const void* a, const void* b, const void* c, void* y,
                   int B, int S, int d_in, int N, int ab_bf16, int c_bf16,
                   void* stream) {
  if (B <= 0 || S <= 0 || d_in <= 0 || N <= 0 || N > NMAX ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (ab_bf16)
    return (int)(c_bf16 ? launch_ab_vec<bf, bf>(a, b, c, y, B, S, d_in, N, st)
                        : launch_ab_vec<bf, float>(a, b, c, y, B, S, d_in, N,
                                                   st));
  return (int)(c_bf16 ? launch_ab_vec<float, bf>(a, b, c, y, B, S, d_in, N,
                                                 st)
                      : launch_ab_vec<float, float>(a, b, c, y, B, S, d_in,
                                                    N, st));
}

// dt [B, S, d_in] float32, A [d_in, N] float32, Bm / C [B, S, N] float32,
// u [B, S, d_in] (u_bf16), h0 [B, d_in, N] float32 or NULL (zeros); y
// [B, S, d_in] float32, h_T [B, d_in, N] float32; all contiguous.
// 1 <= N <= 16.  Returns a cudaError_t.
int mamba_scan_fused(const void* dt, const void* A, const void* Bm,
                     const void* u, const void* C, const void* h0, void* y,
                     void* h_T, int B, int S, int d_in, int N, int u_bf16,
                     void* stream) {
  if (B <= 0 || S <= 0 || d_in <= 0 || N <= 0 || N > NMAX ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(u_bf16 ? launch_fused<__nv_bfloat16>(dt, A, Bm, u, C, h0, y,
                                                    h_T, B, S, d_in, N, st)
                      : launch_fused<float>(dt, A, Bm, u, C, h0, y, h_T, B,
                                            S, d_in, N, st));
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
