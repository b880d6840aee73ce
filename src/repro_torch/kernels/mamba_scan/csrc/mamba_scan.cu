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
// operations beside each (4.3 G, 0.064 ms at 67 TFLOP/s).  Counted as
// issued instructions the floor is higher: expf (kept, not __expf: the
// function is held to the plain version at 1e-4) is six float32
// instructions, an integer shift and one MUFU.EX2, and with dt A, (dt Bm) u,
// a h + b and h C + y a (t, d, n) issues ~13 instructions, ~0.21 ms at
// four warp instructions a clock on 132 SMs at 1.98 GHz (an estimate from
// the instruction count, not a published peak).  The reference entry
// moves a and b (2.15 GB each in float32): 4.4 GB, 1.32 ms, bytes.
//
// Design.  The Pallas grid (B, d_in blocks, chunks) runs in order on one
// core, with the [block_d, N] state in VMEM scratch and a sequential loop
// inside each chunk.  Here d_in is the parallel axis and each lane walks
// t itself in order.
// * The fused entry gives a channel L = 4 lanes of NS = 4 states each,
//   so jamba's layer runs 2048 warps (~16 an SM) and a step's four
//   exponentials per lane overlap with the other warps'.  A lane keeps its
//   partial y of four steps; three __shfl_xor_sync then leave lane q the
//   whole y of the group's step q, which it stores: no lane idles at a
//   store and no branch splits the steps, so the compiler interleaves
//   them.  Blocks of 128 threads hold 32 channels; dt, u, Bm and C of the
//   next FTC = 64 steps are copied into a second shared-memory buffer
//   with cp.async while the block steps through the current one (16-byte
//   pieces where d_in is a multiple of 8 and N of 4, else 4-byte pieces
//   and plain loads for u), so no register holds a value in flight and a
//   bf16 u is converted only when a step reads it.  A chunk always runs
//   its FTC steps: past S, dt = 0 gives a = 1, b = 0, h unchanged.
// * The reference entry keeps one thread per channel, its N <= 16 states
//   in registers, blocks of 128 channels, grid (d_in / 128, B): it reads
//   each step's a and b rows (N contiguous values per thread, 16-byte
//   vectors where N and the alignment allow) straight from device memory,
//   with c staged per chunk of TC steps in shared memory.
// States past N get a = 1 (or 0), b = 0, C = 0 and stay zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;    // threads per block
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

// The fused entry: L lanes per channel, NS = NMAX / L states each, chunks
// of FTC steps.
constexpr int L = 4;               // lanes per channel
constexpr int NS = NMAX / L;       // states per lane
constexpr int DB = NT / L;         // channels per block
constexpr int FTC = 64;            // steps staged per chunk

// One chunk of FTC steps of the block's channels, staged in shared memory.
template <typename U>
struct FusedTiles {
  float dt[FTC][DB];
  U u[FTC][DB];
  float B[FTC][NMAX];
  float C[FTC][NMAX];
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool on, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(on ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(on ? 4 : 0));
}

// Issue the copies of chunk t0 into `tl`, zero past S, d_in and N (a step
// past S then has dt = 0, so a = 1 and b = 0: h passes through it
// unchanged).  VEC: 16-byte pieces (d_in a multiple of 8, N of 4, the
// tensors 16-byte aligned); else 4-byte pieces for dt, Bm and C and plain
// loads for u.
template <typename U, bool VEC>
__device__ __forceinline__ void stage(FusedTiles<U>& tl,
                                      const float* __restrict__ dt,
                                      const U* __restrict__ u,
                                      const float* __restrict__ Bm,
                                      const float* __restrict__ Cm, int bi,
                                      int t0, int S, int d_in, int d0,
                                      int N) {
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)bi * S + t0;
  if constexpr (VEC) {
    constexpr int PD = DB / 4, EU = 16 / sizeof(U), PU = DB / EU;
    constexpr int PN = NMAX / 4;
    for (int i = tid; i < FTC * PD; i += NT) {
      const int t = i / PD, d = d0 + (i % PD) * 4;
      const bool on = t0 + t < S && d < d_in;
      cp_async(&tl.dt[t][(i % PD) * 4],
               on ? dt + (row0 + t) * d_in + d : dt, on, 16);
    }
    for (int i = tid; i < FTC * PU; i += NT) {
      const int t = i / PU, d = d0 + (i % PU) * EU;
      const bool on = t0 + t < S && d < d_in;
      cp_async(&tl.u[t][(i % PU) * EU], on ? u + (row0 + t) * d_in + d : u,
               on, 16);
    }
    for (int i = tid; i < FTC * PN; i += NT) {
      const int t = i / PN, n = (i % PN) * 4;
      const bool on = t0 + t < S && n < N;
      const size_t g = (row0 + t) * N + n;
      cp_async(&tl.B[t][n], on ? Bm + g : Bm, on, 16);
      cp_async(&tl.C[t][n], on ? Cm + g : Cm, on, 16);
    }
  } else {
    for (int i = tid; i < FTC * DB; i += NT) {
      const int t = i / DB, d = d0 + i % DB;
      const bool on = t0 + t < S && d < d_in;
      cp_async(&tl.dt[t][i % DB], on ? dt + (row0 + t) * d_in + d : dt, on,
               4);
      tl.u[t][i % DB] = on ? u[(row0 + t) * d_in + d] : from_f32<U>(0.f);
    }
    for (int i = tid; i < FTC * NMAX; i += NT) {
      const int t = i / NMAX, n = i % NMAX;
      const bool on = t0 + t < S && n < N;
      const size_t g = (row0 + t) * N + n;
      cp_async(&tl.B[t][n], on ? Bm + g : Bm, on, 4);
      cp_async(&tl.C[t][n], on ? Cm + g : Cm, on, 4);
    }
  }
}

template <typename U, bool VEC>
__global__ void __launch_bounds__(NT)
    scan_fused_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const U* __restrict__ u,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_T, int S, int d_in, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FusedTiles<U>* tiles = reinterpret_cast<FusedTiles<U>*>(smem_raw);
  const int tid = threadIdx.x, bi = blockIdx.y;
  const int ch = tid / L, q = tid % L;      // channel in the block, lane
  const int d0 = blockIdx.x * DB, d = d0 + ch;
  const bool live = d < d_in;
  const size_t h_base = ((size_t)bi * d_in + d) * N;

  // this lane's states q NS .. q NS + NS - 1; states past N (and channels
  // past d_in) keep A = 0, B = C = 0, h = 0: they stay zero and add nothing
  float Ad[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = q * NS + j;
    const bool on = live && n < N;
    Ad[j] = on ? A[(size_t)d * N + n] : 0.f;
    h[j] = (on && h0 != nullptr) ? h0[h_base + n] : 0.f;
  }
  // lane q writes y of step q of each group of L steps
  float* yp = y + ((size_t)bi * S + q) * d_in + d;

  stage<U, VEC>(tiles[0], dt, u, Bm, Cm, bi, 0, S, d_in, d0, N);
  asm volatile("cp.async.commit_group;\n" ::);
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += FTC) {
    if (t0 + FTC < S)
      stage<U, VEC>(tiles[buf ^ 1], dt, u, Bm, Cm, bi, t0 + FTC, S, d_in,
                    d0, N);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    // chunk t0's tiles are in
    const FusedTiles<U>& tl = tiles[buf];
#pragma unroll 2
    for (int g = 0; g < FTC; g += L) {
      // each lane's partial y of the group's L steps (its NS states)
      float p[L];
#pragma unroll
      for (int s = 0; s < L; ++s) {
        const int t = g + s;
        const float dtv = tl.dt[t][ch], uv = to_f32<U>(tl.u[t][ch]);
        const float* bv = &tl.B[t][q * NS];
        const float* cv = &tl.C[t][q * NS];
        p[s] = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          recur(h[j], expf(dtv * Ad[j]), (dtv * bv[j]) * uv, cv[j], p[s]);
      }
      // the L lanes' partial sums, scattered: lane q keeps the half of the
      // steps its bit w picks and adds its partner's half of them, until
      // p[0] is y of step q
#pragma unroll
      for (int w = L / 2; w >= 1; w >>= 1) {
        const bool upper = q & w;
#pragma unroll
        for (int i = 0; i < w; ++i) {
          const float send = upper ? p[i] : p[i + w];
          const float keep = upper ? p[i + w] : p[i];
          p[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      if (live && t0 + g + q < S) *yp = p[0];
      yp += (size_t)L * d_in;
    }
    __syncthreads();   // every lane is done with buf
    buf ^= 1;
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (q * NS + j < N) h_T[h_base + q * NS + j] = h[j];
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

template <typename U, bool VEC>
cudaError_t launch_fused(const void* dt, const void* A, const void* Bm,
                         const void* u, const void* C, const void* h0,
                         void* y, void* h_T, int B, int S, int d_in, int N,
                         cudaStream_t stream) {
  const dim3 grid((d_in + DB - 1) / DB, B);
  constexpr int smem = 2 * sizeof(FusedTiles<U>);
  const cudaError_t err = cudaFuncSetAttribute(
      scan_fused_kernel<U, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  scan_fused_kernel<U, VEC><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const U*>(u),
      static_cast<const float*>(C), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_T), S, d_in, N);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_fused_vec(const void* dt, const void* A, const void* Bm,
                             const void* u, const void* C, const void* h0,
                             void* y, void* h_T, int B, int S, int d_in,
                             int N, cudaStream_t stream) {
  const bool vec = d_in % 8 == 0 && N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(C) % 16 == 0;
  return vec ? launch_fused<U, true>(dt, A, Bm, u, C, h0, y, h_T, B, S, d_in,
                                     N, stream)
             : launch_fused<U, false>(dt, A, Bm, u, C, h0, y, h_T, B, S,
                                      d_in, N, stream);
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
  return (int)(u_bf16 ? launch_fused_vec<__nv_bfloat16>(
                             dt, A, Bm, u, C, h0, y, h_T, B, S, d_in, N, st)
                      : launch_fused_vec<float>(dt, A, Bm, u, C, h0, y, h_T,
                                                B, S, d_in, N, st));
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
