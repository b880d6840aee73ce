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
// The kernels take the reference's chunk-parallel form: per chunk of T
// steps, with c the inclusive cumulative sum of logw down the chunk and
// c_prev = c - logw,
//   y  = (r e^{c_prev}) S + tril_strict((r e^{c_prev})(k e^{-c})ᵀ) v
//        + diag(r · u · k) v
//   S <- e^{c_T} S + (k e^{-c} e^{c_T})ᵀ v.
// Chunks start at multiples of `chunk` (<= 64); the last may be shorter.
// The form overflows float32 once e^{-c} does (a per-step log decay below
// about -1.39 over 64 steps), as the reference's does; the kernels keep it.
//
// What bounds it on this card.  At rwkv6-7b's prefill (B 1, S 2048, H 64,
// N 64, chunk 64) the function reads r / k / v (50.3 MB in bf16), logw
// (33.6 MB) and s0, and writes y (16.8 MB) and s_T: ~103 MB, 0.031 ms at
// 3.35 TB/s.  Its four products per chunk and head (r_dec S and the
// state update, T N^2 multiply-adds each; the causal scores and their
// product with v, T (T + 1) N / 2 each) are ~3.2 GFLOP, 0.048 ms on the
// float32 CUDA cores at 67 TFLOP/s: float32 operations bound it.  All
// products stay float32 FMAs on the CUDA cores (tensor-core float32
// accumulation misses the limits the function is held to).
//
// Design.  The Pallas grid (B, H, chunks) walks the chunks of a head in
// order on one core with S in VMEM.  Walking them in order here leaves
// each block a chain of 32 dependent chunk steps and the card a few
// hundred blocks.  Only the state carries from one chunk to the next, and
// the state's recurrence is elementwise, so the work splits into three
// kernels, each parallel across every (b, chunk, h) tile:
//
//   1. wkv_state_kernel: each chunk's state increment
//      dS_c = (k e^{-c} e^{c_T})ᵀ v and e^{c_T}, into scratch;
//   2. wkv_walk_kernel, one thread per (b, h, n, m) entry of the state:
//      S_{c+1} = e^{c_T} S_c + dS_c over the chunks in order, writing S_c
//      (the state before chunk c) over dS_c, and s_T;
//   3. wkv_out_kernel: y of each chunk from its own r / k / v / logw and
//      S_c, the score tile computed once.
//
// Scratch (the wrapper's): dS / S_c [B, H, C, N, N] and e^{c_T}
// [B, H, C, N] float32, C = the number of chunks: 34.1 MB at rwkv6-7b's
// 2048-token prefill.  The state kernel reads k / v / logw, the output
// kernel r / k / v / logw again: ~301 MB moved in all against the
// function's ~103 MB, which the card's 3.35 TB/s covers in ~0.09 ms, about
// what the products take.
//
// The two chunk kernels are persistent: as many blocks of 256 threads as
// fit on the card, each taking tiles (heads fastest, so that the tiles in
// flight read whole rows) one after another, with the next tile's inputs
// copied into shared memory by cp.async while the current one computes
// (the state kernel double-buffers its k / v / logw; the output kernel
// stages r / k / logw, which it has consumed once the decays are formed,
// and then v and S_c, which it has consumed once y is stored).  Thread
// (n, segment) takes the running sum of the 16 logw of column n in its
// segment of rows and adds the sums of the segments above from shared
// memory: the cumulative sum is one barrier, not a 64-step chain.  The
// decayed r and k go to shared memory transposed as float4 runs of four
// rows, rows padded to 68 floats so that the eight lanes of a 16-byte
// store phase hit distinct banks.  The scores' lower triangle is computed
// once, as the 136 4 x 4 tiles on or below the diagonal (one thread each),
// while every thread forms its 4 x 4 tile of r_dec S; after one barrier
// each adds the causal scores times v and stores its tile of y.  Rows past
// a short chunk and heads narrower than 64 are zero-filled and add
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per chunk block
constexpr int NM = 64;           // largest head size N
constexpr int TM = 64;           // largest chunk
constexpr int SEGS = NT / NM;    // row segments of a column: 4
constexpr int SEG = TM / SEGS;   // rows of a segment: 16
constexpr int P = TM + 4;        // row stride (floats) of the [n][t] tiles
constexpr int TRI = 16 * 17 / 2; // 4 x 4 score tiles on or below the diagonal
constexpr int WALK_NT = 256;     // threads per walk block
constexpr int WALK_AHEAD = 32;   // chunks the walk loads at once

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(on ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// Four consecutive values of a staged tile as float32.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}

// Chunk ci of head h, batch b: tile `tile` of the B C H tiles, heads
// fastest, so that the tiles in flight on the card are neighbouring heads
// of one chunk and read whole rows of r / k / v / logw, not 128-byte
// pieces of rows 8 KB apart.
struct Tile {
  int h, Tc;
  size_t row0;  // element offset of (b, first row, h, 0) in r / k / v / logw
  size_t bhc;   // (b, h, ci) of the scratch arrays

  __device__ Tile(int tile, int S, int H, int N, int chunk, int C) {
    h = tile % H;
    const int ci = (tile / H) % C, b = tile / (H * C);
    Tc = min(chunk, S - ci * chunk);
    row0 = ((size_t)b * S + (size_t)ci * chunk) * H * N + (size_t)h * N;
    bhc = ((size_t)b * H + h) * C + ci;
  }
};

// Copy `rows` rows of N values, `step` apart from src + off, into the
// [TM][NM] tile dst, zero past `rows` and N.  VEC: 16-byte cp.async
// pieces (N a multiple of 8, the tensors 16-byte aligned); else plain
// loads and stores.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           size_t off, size_t step, int rows,
                                           int N) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T), PR = NM / E;
    for (int i = threadIdx.x; i < TM * PR; i += NT) {
      const int t = i / PR, e = (i % PR) * E;
      const bool on = t < rows && e < N;
      cp_async16(dst + t * NM + e, on ? src + off + t * step + e : src, on);
    }
  } else {
    for (int i = threadIdx.x; i < TM * NM; i += NT) {
      const int t = i / NM, e = i % NM;
      dst[i] = (t < rows && e < N) ? src[off + t * step + e]
                                   : from_f32<T>(0.f);
    }
  }
}

// Thread (n, segment) of a chunk block: column n of rows t0 .. t0 + 15.
// Its running sum of the 16 logw down the column, from the staged tile.
__device__ __forceinline__ void column_scan(const float* w_tile, int n,
                                            int t0, float (&w)[SEG]) {
#pragma unroll
  for (int i = 0; i < SEG; ++i) w[i] = w_tile[(t0 + i) * NM + n];
#pragma unroll
  for (int i = 1; i < SEG; ++i) w[i] += w[i - 1];
}

// After the barrier that publishes each thread's running sum of its 16
// logw: the sum of the segments above this one (c = off + w[i] is the
// cumulative log decay of row t0 + i) and of all of them (tot = c_T).
__device__ __forceinline__ void segment_sums(const float (&sums)[SEGS][NM],
                                             int n, int seg, float* off,
                                             float* tot) {
  float o = 0.f, t = 0.f;
#pragma unroll
  for (int s = 0; s < SEGS; ++s) {
    if (s == seg) o = t;
    t += sums[s][n];
  }
  *off = o;
  *tot = t;
}

// ---------------------------------------------------------------------------
// 1. The state increments, one chunk tile after another

template <typename T>
struct StateSmem {
  T k[2][TM * NM];        // the staged tiles, double buffered
  T v[2][TM * NM];
  float w[2][TM * NM];
  float kd[TM * NM];      // k e^{-c} e^{c_T}, [t][n]
  float sums[SEGS][NM];   // logw summed per segment
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ logw, float* __restrict__ dS,
                     float* __restrict__ ecT, int S, int H, int N, int chunk,
                     int C, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem<T>& sm = *reinterpret_cast<StateSmem<T>*>(smem_raw);
  const int tid = threadIdx.x;
  const int n = tid % NM, seg = tid / NM, t0 = seg * SEG;
  const size_t step = (size_t)H * N;
  auto stage = [&](int tile, int buf) {
    const Tile tl(tile, S, H, N, chunk, C);
    stage_rows<T, VEC>(sm.k[buf], k, tl.row0, step, tl.Tc, N);
    stage_rows<T, VEC>(sm.v[buf], v, tl.row0, step, tl.Tc, N);
    stage_rows<float, VEC>(sm.w[buf], logw, tl.row0, step, tl.Tc, N);
  };

  int tile = blockIdx.x;
  if (tile < tiles) stage(tile, 0);
  cp_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + (int)gridDim.x < tiles) stage(tile + gridDim.x, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const Tile tl(tile, S, H, N, chunk, C);
    float w[SEG];
    column_scan(sm.w[buf], n, t0, w);
    sm.sums[seg][n] = w[SEG - 1];
    __syncthreads();

    {
      // kd = k e^{-c} e^{c_T}, after every segment's sum is in
      float off, tot;
      segment_sums(sm.sums, n, seg, &off, &tot);
      const float e_T = expf(tot);
#pragma unroll
      for (int i = 0; i < SEG; ++i)
        sm.kd[(t0 + i) * NM + n] =
            to_f32<T>(sm.k[buf][(t0 + i) * NM + n]) * expf(-(off + w[i])) *
            e_T;
      if (seg == 0 && n < N) ecT[tl.bhc * N + n] = e_T;
    }
    __syncthreads();

    // dS[n][m] = sum_t kd[t][n] v[t][m]: rows 4 ty.., columns 4 tx..
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][4] = {};
#pragma unroll 4
    for (int t = 0; t < tl.Tc; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.kd[t * NM + 4 * ty]);
      const float4 b = load4<T>(&sm.v[buf][t * NM + 4 * tx]);
      const float ai[4] = {a.x, a.y, a.z, a.w};
      const float bj[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] += ai[r] * bj[e];
    }
    // the increment of this chunk
    float* out = dS + tl.bhc * N * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ty + r;
      if (row >= N) continue;
      if (N % 4 == 0) {
        if (4 * tx < N)
          *reinterpret_cast<float4*>(&out[row * N + 4 * tx]) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * tx + e < N) out[row * N + 4 * tx + e] = acc[r][e];
      }
    }
    __syncthreads();   // buf is free for the tile after next
  }
}

// ---------------------------------------------------------------------------
// 2. The walk over the chunks: S_c over dS_c, then S_{c+1}

__global__ void __launch_bounds__(WALK_NT)
    wkv_walk_kernel(float* __restrict__ dS, const float* __restrict__ ecT,
                    const float* __restrict__ s0, float* __restrict__ s_T,
                    int N, int C, int entries) {
  const int e = blockIdx.x * WALK_NT + threadIdx.x;  // (b, h, n, m)
  if (e >= entries) return;
  const int nn = N * N, bh = e / nn, nm = e % nn, n = nm / N;
  float* d = dS + (size_t)bh * C * nn + nm;
  const float* g = ecT + (size_t)bh * C * N + n;
  float st = s0 != nullptr ? s0[e] : 0.f;
  for (int c0 = 0; c0 < C; c0 += WALK_AHEAD) {
    float inc[WALK_AHEAD], dec[WALK_AHEAD];
#pragma unroll
    for (int j = 0; j < WALK_AHEAD; ++j) {
      const bool on = c0 + j < C;
      inc[j] = on ? d[(size_t)(c0 + j) * nn] : 0.f;
      dec[j] = on ? g[(size_t)(c0 + j) * N] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < WALK_AHEAD; ++j) {
      if (c0 + j < C) {
        d[(size_t)(c0 + j) * nn] = st;
        st = dec[j] * st + inc[j];
      }
    }
  }
  s_T[e] = st;
}

// ---------------------------------------------------------------------------
// 3. y, one chunk tile after another, from the tile's inputs and the state
//    before it

template <typename T>
struct OutSmem {
  T r[TM * NM];       // staged first: r, k, logw of the tile
  T k[TM * NM];
  float w[TM * NM];
  T v[TM * NM];       // staged second: v of the tile and the state S_c
  float S[NM * NM];
  float rT[NM * P];   // r e^{c_prev}, [n][t]
  float kT[NM * P];   // k e^{-c}, [n][t]
  float A[TM * TM];   // r·u·k terms [t][n ^ (t & 31)]; then the scores [j][i]
  float sums[SEGS][NM];
  float diag[TM];     // r_t · u · k_t
};

// The score tile of thread `task` (< TRI): row block bi, column block
// bj <= bi of the 16 x 16 grid of 4 x 4 tiles.
__device__ __forceinline__ void tri_tile(int task, int* bi, int* bj) {
  int i = (int)((sqrtf(8.f * task + 1.f) - 1.f) * 0.5f);
  if ((i + 1) * (i + 2) / 2 <= task) ++i;
  if (i * (i + 1) / 2 > task) --i;
  *bi = i;
  *bj = task - i * (i + 1) / 2;
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&a)[4],
                                          int m0, int N) {
  if (N % 4 == 0) {
    if (m0 >= N) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + m0) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
      uint2 q;
      q.x = *reinterpret_cast<uint32_t*>(&lo);
      q.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p + m0) = q;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (m0 + e < N) p[m0 + e] = from_f32<T>(a[e]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    wkv_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u,
                   const float* __restrict__ Sc, T* __restrict__ y, int S,
                   int H, int N, int chunk, int C, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem<T>& sm = *reinterpret_cast<OutSmem<T>*>(smem_raw);
  const int tid = threadIdx.x;
  const int n = tid % NM, seg = tid / NM, t0 = seg * SEG;
  const int ty = tid / 16, tx = tid % 16;
  const size_t step = (size_t)H * N;
  auto stage_first = [&](int tile) {
    const Tile tl(tile, S, H, N, chunk, C);
    stage_rows<T, VEC>(sm.r, r, tl.row0, step, tl.Tc, N);
    stage_rows<T, VEC>(sm.k, k, tl.row0, step, tl.Tc, N);
    stage_rows<float, VEC>(sm.w, logw, tl.row0, step, tl.Tc, N);
  };
  auto stage_second = [&](int tile) {
    const Tile tl(tile, S, H, N, chunk, C);
    stage_rows<T, VEC>(sm.v, v, tl.row0, step, tl.Tc, N);
    stage_rows<float, VEC>(sm.S, Sc, tl.bhc * N * N, N, N, N);
  };

  int tile = blockIdx.x;
  if (tile < tiles) {
    stage_first(tile);
    cp_commit();
    stage_second(tile);
    cp_commit();
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const Tile tl(tile, S, H, N, chunk, C);
    cp_wait<1>();
    __syncthreads();
    // the tile's r, k and logw are in; its v and state may be in flight
    const float un = n < N ? u[tl.h * N + n] : 0.f;
    float w[SEG];
    column_scan(sm.w, n, t0, w);
    sm.sums[seg][n] = w[SEG - 1];
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const int t = t0 + i;   // columns swizzled by the row: see below
      sm.A[t * TM + (n ^ (t & 31))] =
          to_f32<T>(sm.r[t * NM + n]) * un * to_f32<T>(sm.k[t * NM + n]);
    }
    __syncthreads();

    {
      // r e^{c_prev} and k e^{-c}, transposed
      float off, tot;
      segment_sums(sm.sums, n, seg, &off, &tot);
#pragma unroll
      for (int i = 0; i < SEG; i += 4) {
        float4 rd, kd;
        float* rp = &rd.x;
        float* kp = &kd.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + i + e;
          const float c = off + w[i + e];
          const float c_prev = c - sm.w[t * NM + n];   // as the reference
          rp[e] = to_f32<T>(sm.r[t * NM + n]) * expf(c_prev);
          kp[e] = to_f32<T>(sm.k[t * NM + n]) * expf(-c);
        }
        *reinterpret_cast<float4*>(&sm.rT[n * P + t0 + i]) = rd;
        *reinterpret_cast<float4*>(&sm.kT[n * P + t0 + i]) = kd;
      }
      // the bonus r_t · u · k_t: four threads a row, 16 columns each (the
      // columns were stored swizzled by the row, so that the eight rows a
      // warp reads fall on distinct banks)
      const int t = tid / 4, q = tid % 4;
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < NM / 4; ++j)
        d += sm.A[t * TM + ((q * (NM / 4) + j) ^ (t & 31))];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (q == 0) sm.diag[t] = d;
    }
    cp_wait<0>();
    __syncthreads();
    // the first staging buffer is free: the next tile's r, k, logw load
    // while this one computes
    if (next < tiles) {
      stage_first(next);
      cp_commit();
    }

    // the scores' lower triangle, A[j][i] = r_dec_i · k_dec_j for j < i,
    // the bonus for j == i, zero above: each 4 x 4 tile on or below the
    // diagonal once (rows past the chunk are never read)
    if (tid < TRI) {
      int bi, bj;
      tri_tile(tid, &bi, &bj);
      if (4 * bi < tl.Tc) {
        float acc[4][4] = {};
#pragma unroll 8
        for (int m = 0; m < NM; ++m) {
          const float4 ra =
              *reinterpret_cast<const float4*>(&sm.rT[m * P + 4 * bi]);
          const float4 kb =
              *reinterpret_cast<const float4*>(&sm.kT[m * P + 4 * bj]);
          const float ai[4] = {ra.x, ra.y, ra.z, ra.w};
          const float bj4[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] += ai[a] * bj4[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * bj + e;
          float col[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = 4 * bi + a;
            col[a] = j < i ? acc[a][e] : (j == i ? sm.diag[i] : 0.f);
          }
          *reinterpret_cast<float4*>(&sm.A[j * TM + 4 * bi]) =
              make_float4(col[0], col[1], col[2], col[3]);
        }
      }
    }
    // r_dec S: every thread's rows 4 ty.., columns 4 tx.. of y
    float ya[4][4] = {};
#pragma unroll 8
    for (int m = 0; m < NM; ++m) {
      const float4 ra =
          *reinterpret_cast<const float4*>(&sm.rT[m * P + 4 * ty]);
      const float4 s = *reinterpret_cast<const float4*>(&sm.S[m * NM + 4 * tx]);
      const float ai[4] = {ra.x, ra.y, ra.z, ra.w};
      const float sj[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[a][e] += ai[a] * sj[e];
    }
    __syncthreads();

    // the causal scores times v: A[j][i] is zero for j > i
    const int jend = min(4 * ty + 4, tl.Tc);
    for (int j = 0; j < jend; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.A[j * TM + 4 * ty]);
      const float4 vv4 = load4<T>(&sm.v[j * NM + 4 * tx]);
      const float ai[4] = {a.x, a.y, a.z, a.w};
      const float vj[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
#pragma unroll
      for (int a2 = 0; a2 < 4; ++a2)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[a2][e] += ai[a2] * vj[e];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {   // rows past the chunk are not stored
      const int i = 4 * ty + a;
      if (i < tl.Tc) store_row<T>(y + tl.row0 + i * step, ya[a], 4 * tx, N);
    }
    __syncthreads();
    // y of the tile is out; the next tile's v and state load behind its
    // first phases
    if (next < tiles) {
      stage_second(next);
      cp_commit();
    }
  }
}

// Blocks of a persistent chunk kernel: as many as fit on the card at once,
// at most one per tile.
template <typename K>
cudaError_t persistent_grid(K kernel, int smem, int tiles, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NT, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   void* y, float* s_T, float* scratch, int B, int S, int H,
                   int N, int chunk, cudaStream_t stream) {
  const int C = (S + chunk - 1) / chunk;
  const long long tiles = (long long)B * C * H;
  const size_t entries = (size_t)B * H * N * N;
  if (tiles > 0x7fffffff || entries > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  float* dS = scratch;                          // [B, H, C, N, N]
  float* ecT = scratch + entries * C;           // [B, H, C, N]
  int grid = 0;
  cudaError_t err = persistent_grid(wkv_state_kernel<T, VEC>,
                                    (int)sizeof(StateSmem<T>), (int)tiles,
                                    &grid);
  if (err != cudaSuccess) return err;
  wkv_state_kernel<T, VEC><<<grid, NT, sizeof(StateSmem<T>), stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), logw, dS, ecT, S,
      H, N, chunk, C, (int)tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv_walk_kernel<<<(unsigned)((entries + WALK_NT - 1) / WALK_NT), WALK_NT,
                    0, stream>>>(dS, ecT, s0, s_T, N, C, (int)entries);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = persistent_grid(wkv_out_kernel<T, VEC>, (int)sizeof(OutSmem<T>),
                        (int)tiles, &grid);
  if (err != cudaSuccess) return err;
  wkv_out_kernel<T, VEC><<<grid, NT, sizeof(OutSmem<T>), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, dS, static_cast<T*>(y), S, H, N,
      chunk, C, (int)tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* s0,
                       void* y, float* s_T, float* scratch, int B, int S,
                       int H, int N, int chunk, cudaStream_t stream) {
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(logw) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  return vec ? launch<T, true>(r, k, v, logw, u, s0, y, s_T, scratch, B, S,
                               H, N, chunk, stream)
             : launch<T, false>(r, k, v, logw, u, s0, y, s_T, scratch, B, S,
                                H, N, chunk, stream);
}

}  // namespace

extern "C" {

// r, k, v [B, S, H, N] (one dtype: is_bf16), logw [B, S, H, N] float32,
// u [H, N] float32, s0 [B, H, N, N] float32 or NULL (zeros), y [B, S, H, N]
// in r's dtype, s_T [B, H, N, N] float32, scratch B H C N (N + 1) float32
// with C = ceil(S / chunk); all contiguous.
// 1 <= N <= 64, 1 <= chunk <= 64.  Returns a cudaError_t.
int wkv_fwd(const void* r, const void* k, const void* v, const void* logw,
            const void* u, const void* s0, void* y, void* s_T, void* scratch,
            int B, int S, int H, int N, int chunk, int is_bf16,
            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > NM || chunk <= 0 ||
      chunk > TM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s = static_cast<const float*>(s0);
  float* sT = static_cast<float*>(s_T);
  float* sc = static_cast<float*>(scratch);
  return (int)(is_bf16 ? launch_vec<__nv_bfloat16>(r, k, v, w, uu, s, y, sT,
                                                   sc, B, S, H, N, chunk, st)
                       : launch_vec<float>(r, k, v, w, uu, s, y, sT, sc, B,
                                           S, H, N, chunk, st));
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
