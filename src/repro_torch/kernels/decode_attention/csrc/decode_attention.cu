// Flash-decoding for Hopper (sm_90a): one query token per sequence against
// a KV cache masked by the sequence's position, float32 or bfloat16 in,
// float32 accumulation.
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/decode_attention/kernel.py:decode_attention_fwd
// (_decode_kernel), and computes the function of the model's
// repro/models/layers.py:attention_decode: scores q.k in float32 times
// the float32 scale, positions > pos[b] masked, softmax and P.V in
// float32 (p stays float32 and multiplies v read as float32, as
// attention_decode does; the Pallas kernel casts p to v's dtype first,
// kernel.py:58), one cast to the output dtype.
//
//   q [B, H, D], k [B, Sk, Kh, D], v [B, Sk, Kh, Dv], pos [B] int32
//   -> o [B, H, Dv];  query head h reads kv head h / G (group-major).
//
// What bounds it on this card.  It reads each kept cache row once and does
// 2 (D + Dv) flops per row and query head: 2G flops per 2-byte element of
// a bf16 cache, 16 at G = H / Kh = 8 (yi-9b, jamba), which at the bytes
// bound (3.35 TB/s) is 26.8 TFLOP/s of float32 FMAs, 40 % of the CUDA
// cores' 67, and 5 % at G = 1 (stablelm-3b, moonshot).  So bytes bound it:
// (pos + 1) Kh (D + Dv) elements per sequence.  What holds a kernel back
// from that bound is the bytes in flight (~25 KB an SM at ~1 us of
// latency), at batch 1 the serial steps of a short launch, and at G = 8
// instruction issue: with each bf16 element's conversion and the shared
// loads, the scores take ~2 instructions per FMA.
//
// The scores stay on the CUDA cores: each is one float32 FMA chain over
// d = 0 .. D-1 in order from 0, then times the scale, as in the flash
// kernels and the plain version's float32 GEMM, which agree with it to
// the bit (the dense decode-vs-forward check rests on that; a tensor-core
// sum aligns and truncates its terms).
//
// Design: flash-decoding in two launches.  decode_split_kernel runs one
// CTA per (split, kv head): the grid is nx CTAs per kv head, one wave of
// two CTAs per SM in all (kernel.py: decode_plan), and the CTAs share out
// the sequences' kept positions on the card (pos lives there): sequence
// b, with n_b = min(pos[b] + 1, Sk) kept positions (Sk when pos < 0) of R
// in all, takes ns_b = 1 + floor((nx - B) n_b / R) CTAs in order of b,
// split s holding positions [s c_b, min((s + 1) c_b, n_b)) with c_b =
// max(ceil(n_b / ns_b) in whole tiles, cmin); the first ceil(n_b / c_b)
// splits have work.  So every kept position lies in exactly one split, no
// position > pos is read, and the splits of a long and a short sequence
// hold about as many rows (no tail of long CTAs).  The CTA streams its
// split's K rows and then its V rows for the one kv head through a ring
// of STAGES = 4 shared-memory tiles of KT rows (64 bf16 or 32 float32
// rows, ~17 KB): three tiles (~52 KB) are in flight while one is used,
// and the V tiles' loads start while the last K tiles are scored.  At G <=
// 2, with rows of whole 16-byte chunks, the full tiles come by TMA (a 2-D
// tensor map over [B Sk, Kh D], completion on the stage's mbarrier): in
// [KT, 128-byte] boxes with the 128-byte swizzle where rows are whole
// boxes (SWIZZLED), else one box of whole, unpadded rows (DENSE:
// stablelm-3b's 160-byte rows); the last, partial tile of a split comes by
// 16-byte cp.async into the same layout, so no row past the split's end
// is read (a fixed TMA box would read past pos).  TMA lifted those
// memory-bound cases over per-thread cp.async, which held a CTA to a
// fixed rate whatever it computed.  At G = 8
// the scores' FMAs bind, and the swizzle's address arithmetic in the
// score loop cost more than TMA gained, so there every tile comes by
// cp.async into rows padded to an odd number of 16-byte units: 16-byte
// shared loads of 8 rows in a quarter-warp then hit 8 different bank
// groups (a 256-byte stride puts them all on the same banks).  (Tried
// and slower: one bulk copy per 256-byte row instead of cp.async; one
// pass per tile with an online softmax, K and V tiles together and the K
// tile converted to float32 once, at three barriers a tile.)  Threads:
// 128 at G >= 8 (four FMA chains a thread), 256 below.
//  * Scores: thread (2 heads, rows) holds the heads' q in registers (32
//    elements at a time) and runs the FMA chains of its rows of the tile
//    interleaved, one bf16 -> float32 conversion of k serving both heads,
//    times the scale, into the split's G x KC score buffer.  (With q read
//    from shared memory for every row, and 4 warps a CTA, a 64-row tile
//    took several times its bytes' time at G = 8.)
//  * Softmax: after the last K tile one warp per head takes the split's
//    max m and writes e = exp(s - m) and their sum l.
//  * P.V: thread owns (4 heads in bf16 / 8 in float32, 16-byte chunk of
//    Dv) units: per row one 16-byte load of v, its conversion to float32
//    shared by the heads, and p[g][i] times v[i] added for each head;
//    row groups split the rows and their sums are added in row-group
//    order.
// The partial (m, l, acc) of every (split, h) goes to one float32 scratch.
// decode_combine_kernel, one CTA per (h, b), adds the sequence's splits in
// split order: M = max m_s, L = sum_s l_s exp(m_s - M), o = sum_s acc_s
// exp(m_s - M) / max(L, 1e-30), one rounding to the output dtype.  (The
// first version let the last CTA of each (b, kv head) combine behind a
// counter: one CTA reading every split's G x Dv partial made a tail
// longer than the split kernel's work at batch 1.)  The combine is launched with programmatic dependent
// launch: its CTAs start while the split kernel runs, plan, and wait
// (griddepcontrol.wait) for the partials.  pos < 0 masks every position
// to -1e30, as the reference's mask does, which gives the mean of v over
// all Sk rows.  No float atomics: the sums' order is fixed.
// The error strings of this library live in flash_attention.cu.

#include <math.h>
#include <string.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int NT_MAX = 256;      // threads per split CTA, at most
constexpr int NTC = 128;         // threads per combine CTA
constexpr int CMB_FLOATS = 11264;  // a combine CTA's shared memory (44 KB)
constexpr int STAGES = 4;        // ring tiles
constexpr int PV_REGS = 32;      // float32 P.V accumulators per thread
constexpr int QD = 32;           // q elements a scoring thread holds at once
constexpr int OUT_MAX = 4096;    // Dv at most (the combine's outputs)
constexpr int G_MAX = 64;        // query heads per kv head
constexpr float NEG_INF = -1e30f;

// How a split CTA's tiles come in: PADDED, 16-byte cp.async into rows
// padded to an odd number of 16-byte units; SWIZZLED, full tiles by TMA in
// 128-byte boxes with the 128-byte swizzle (rows of whole boxes); DENSE,
// full tiles by TMA as one box of whole rows, unpadded (other rows of
// whole 16-byte chunks).  A split's last, partial tile always comes by
// cp.async into the same layout.
constexpr int PADDED = 0, SWIZZLED = 1, DENSE = 2;

// Threads per split CTA: 128 at G >= 8 (four FMA chains a thread in the
// score phase), 256 below (more rows in flight for one or two heads).
__host__ __device__ constexpr int nt_of(int GM) {
  return GM >= 8 ? 128 : 256;
}

// rows per ring tile: ~17 KB of a 128-element row either way
template <typename T>
__host__ __device__ constexpr int kt_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  float* part;       // [nx H][Dv] acc, then [nx H][2] (m, l); nx = gridDim.x
  void* o;
  int B, Sk, H, Kh, D, Dv, KC, cmin, nx, kt;
  int ks, vs;        // padded layout: staged row strides, in elements
  int vec;           // rows of whole 16-byte chunks, 16-byte aligned
  float scale;
};

// The ring's bytes (a multiple of 1024); it also holds the P.V row-group
// sums, so at least NT_MAX x PV_REGS floats.  SWIZZLED tiles are rows of
// D (Dv) elements in 128-byte boxes, else rows of ks (vs) elements.
template <typename T, int MODE>
__host__ __device__ size_t ring_bytes(const Params& p) {
  const int kw = MODE == SWIZZLED ? p.D : p.ks;
  const int vw = MODE == SWIZZLED ? p.Dv : p.vs;
  size_t r = (size_t)STAGES * kt_rows<T>() * (kw > vw ? kw : vw) * sizeof(T);
  const size_t need = (size_t)NT_MAX * PV_REGS * sizeof(float);
  r = r > need ? r : need;
  return (r + 1023) / 1024 * 1024;
}

// The element offset, in a staged tile, of 16-byte chunk c of row r.  SW:
// box c / 8 of KT rows of 128 bytes, chunk c % 8 stored at (c % 8) ^ (r %
// 8) (TMA's 128-byte swizzle; the tile 1024-byte aligned); else rows of
// `stride` elements.
template <typename T, bool SW>
__device__ __forceinline__ int chunk_off(int r, int c, int stride) {
  constexpr int V = 16 / sizeof(T), BW = 128 / sizeof(T);
  if constexpr (SW)
    return (c >> 3) * (kt_rows<T>() * BW) + r * BW + (((c & 7) ^ (r & 7)) * V);
  else
    return r * stride + c * V;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A 16-byte chunk as float32 (bfloat16 is float32's top half).
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The positions a sequence keeps: min(pos + 1, Sk), or Sk when pos < 0.
__device__ __forceinline__ int n_kept(int pos, int Sk) {
  return pos < 0 ? Sk : min(pos + 1, Sk);
}

// The splits of the nx CTAs of a kv head (kernel.py: split_ranges): sequence
// b, with n_b kept positions of R in all, takes ns_b = 1 + floor(E n_b / R)
// CTAs in order of b (E = nx - B), split s holding c_b = max(ceil(n_b /
// ns_b) rounded up to whole tiles of kt rows, cmin) positions; the first
// u_b = ceil(n_b / c_b) have work.  For
// CTA x (or, with x < 0, for sequence want): r = {b (-1: no work), start,
// end, x0 (b's first CTA), u_b}.
__device__ void split_of(const Params& p, int x, int want, int (&r)[5]) {
  long long R = 0;
  for (int i = 0; i < p.B; ++i) R += n_kept(p.pos[i], p.Sk);
  const long long E = p.nx - p.B;
  int x0 = 0;
  r[0] = -1;
  for (int i = 0; i < p.B; ++i) {
    const int n = n_kept(p.pos[i], p.Sk);
    const int ns = 1 + (int)(E * n / R);
    if (x < 0 ? i == want : x < x0 + ns) {
      const int c = max(((n + ns - 1) / ns + p.kt - 1) / p.kt * p.kt, p.cmin);
      const int u = (n + c - 1) / c;
      const int s = x < 0 ? 0 : x - x0;
      if (s < u) {
        r[0] = i;
        r[1] = s * c;
        r[2] = min(r[1] + c, n);
        r[3] = x0;
        r[4] = u;
      }
      return;
    }
    x0 += ns;
  }
}

// QD elements of each of HS heads' q from shared memory (rows QS apart; n
// of them valid: the rest repeat the last four, never used).
template <int HS>
__device__ __forceinline__ void load_q(float (&qv)[HS][QD], const float* q,
                                       int QS, int n) {
#pragma unroll
  for (int h = 0; h < HS; ++h)
#pragma unroll
    for (int c = 0; c < QD / 4; ++c) {
      const float4 t4 = *reinterpret_cast<const float4*>(
          q + h * QS + min(4 * c, n - 4));
      qv[h][4 * c] = t4.x;
      qv[h][4 * c + 1] = t4.y;
      qv[h][4 * c + 2] = t4.z;
      qv[h][4 * c + 3] = t4.w;
    }
}

// 16-byte chunk c of the HS x RPT FMA chains: sc[h][i] += q_h[e] k_i[e]
// for e in order, row i = r0 + i SRG of the tile; one conversion of k
// serves the HS heads, and the chains interleave.
template <typename T, bool SW, int HS, int RPT, int SRG, int C>
__device__ __forceinline__ void score_chunk(float (&sc)[HS][RPT],
                                            const float (&qv)[HS][QD],
                                            const T* tile, int r0, int c0,
                                            int ks) {
  constexpr int V = 16 / sizeof(T);
  float kf[RPT][V];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    unpack(*reinterpret_cast<const uint4*>(
               tile + chunk_off<T, SW>(r0 + i * SRG, c0 + C, ks)),
           kf[i]);
#pragma unroll
  for (int e = 0; e < V; ++e)
#pragma unroll
    for (int h = 0; h < HS; ++h)
#pragma unroll
      for (int i = 0; i < RPT; ++i) sc[h][i] += qv[h][C * V + e] * kf[i][e];
}

// score_chunk for chunks c0 .. c0 + QD / V - 1: all of them (FULL, no
// branch between chunks), or those below n elements.
template <typename T, bool SW, int HS, int RPT, int SRG, bool FULL,
          int C = 0>
__device__ __forceinline__ void score_block(float (&sc)[HS][RPT],
                                            const float (&qv)[HS][QD],
                                            const T* tile, int r0, int c0,
                                            int ks, int n) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (C < QD / V) {
    if (FULL || C * V < n) {
      score_chunk<T, SW, HS, RPT, SRG, C>(sc, qv, tile, r0, c0, ks);
      score_block<T, SW, HS, RPT, SRG, FULL, C + 1>(sc, qv, tile, r0, c0, ks,
                                                   n);
    }
  }
}

// GM: G rounded up to a power of two (the register arrays' sizes).
// MODE: PADDED, SWIZZLED or DENSE (TMA modes are chosen at G <= 2; at
// G = 8 the scores' FMAs bind (PERF.md), and the padded cp.async layout,
// whose addresses cost no arithmetic in the score loop, measured faster).
template <typename T, int GM, int MODE>
__global__ void __launch_bounds__(nt_of(GM), 2)
decode_split_kernel(const Params p, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  constexpr bool SW = MODE == SWIZZLED;
  constexpr int NT = nt_of(GM);
  constexpr int KT = kt_rows<T>();
  constexpr int V = 16 / sizeof(T);       // elements per 16-byte chunk
  constexpr int HS = GM < 2 ? GM : 2;     // score heads per thread
  constexpr int SRG = NT / (GM / HS);     // score row groups (>= 8)
  constexpr int RPT = KT > SRG ? KT / SRG : 1;   // score rows per thread
  constexpr int GH = GM < PV_REGS / V ? GM : PV_REGS / V;  // P.V heads
  constexpr int BW = 128 / sizeof(T);     // elements of a 128-byte row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];   // TMA tiles' barriers
  __shared__ int plan[5];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int x = blockIdx.x, kh = blockIdx.y;
  const int H = p.H, Kh = p.Kh, D = p.D, Dv = p.Dv, KCP = p.KC | 1;
  const int G = H / Kh, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stage = KT * max(SW ? D : p.ks, SW ? Dv : p.vs);
  T* ring = reinterpret_cast<T*>(smem);               // [STAGES][KT][ks|vs]
  const int QS = D + 4;        // q row stride: 8 heads' rows on 8 bank groups
  float* Qs = reinterpret_cast<float*>(smem + ring_bytes<T, MODE>(p));
  float* Ps = Qs + G * QS;     // [GM][KC | 1] scores, then e

  // the combine kernel may launch now: it plans, then waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    split_of(p, x, 0, plan);
    if (MODE != PADDED) {
      for (int s = 0; s < STAGES; ++s) hopper::mbar_init(full + s, 1);
      hopper::fence_barrier_init();
    }
  }
  __syncthreads();
  const int b = plan[0];
  if (b < 0) return;
  const int start = plan[1], end = plan[2], n = end - start;
  const bool all_masked = p.pos[b] < 0;
  const int nt = (n + KT - 1) / KT;       // tiles of K, then as many of V

  // partial (split x, h = kh G + g): acc at pacc[(x H + h) Dv], (m, l) at
  // ml[2 (x H + h)]
  float* pacc = p.part;
  float* ml = p.part + (size_t)p.nx * H * Dv;
  const size_t row = (size_t)x * H + (size_t)kh * G;

  const T* kb = static_cast<const T*>(p.k) + ((size_t)b * p.Sk * Kh + kh) * D;
  const T* vb = static_cast<const T*>(p.v) + ((size_t)b * p.Sk * Kh + kh) * Dv;
  // tile j of the stream K_0 .. K_{nt-1}, V_0 .. V_{nt-1} into its stage:
  // in a TMA mode a whole tile of KT rows by TMA (thread 0; one box per 128
  // bytes of the row, or one of the whole row, completing on the stage's
  // barrier); else in 16-byte cp.async
  // chunks (or, for rows that are not whole chunks, plain loads that the
  // next __syncthreads publishes).  Every row lies below the split's end.
  auto is_tma = [&](int j) {
    const int t = j < nt ? j : j - nt;
    return MODE != PADDED && n - t * KT >= KT;
  };
  auto issue = [&](int j) {
    if (j >= 2 * nt) return;
    const bool isk = j < nt;
    const int t = isk ? j : j - nt, w = isk ? D : Dv;
    const int stride = isk ? p.ks : p.vs;
    const int r0 = start + t * KT, rows = min(KT, end - r0);
    T* dst = ring + (j % STAGES) * stage;
    if (is_tma(j)) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        hopper::mbar_expect_tx(full + j % STAGES, KT * w * sizeof(T));
        if (SW)
          for (int a = 0; a < w / BW; ++a)
            hopper::tma_load_2d(dst + a * KT * BW, isk ? &tk : &tv,
                                full + j % STAGES, kh * w + a * BW,
                                b * p.Sk + r0);
        else
          hopper::tma_load_2d(dst, isk ? &tk : &tv, full + j % STAGES,
                              kh * w, b * p.Sk + r0);
      }
      return;
    }
    const T* src = (isk ? kb : vb) + (size_t)r0 * Kh * w;
    if (p.vec) {
      const int cpr = w / V;
      for (int c = tid; c < rows * cpr; c += NT) {
        const int r = c / cpr, cc = c - r * cpr;
        cp_async16(dst + chunk_off<T, SW>(r, cc, stride),
                   src + (size_t)r * Kh * w + cc * V);
      }
    } else {
      for (int e = tid; e < rows * w; e += NT) {
        const int r = e / w, d = e - r * w;
        dst[r * stride + d] = src[(size_t)r * Kh * w + d];
      }
    }
  };
  uint32_t phase = 0;           // bit s: parity of stage s's next TMA tile

  // scores: thread (heads sg .. sg + HS - 1, row group srg) scores rows
  // srg + i SRG of each K tile, q in registers, the HS x RPT FMA chains
  // interleaved
  const int sg = (tid % (GM / HS)) * HS, srg = tid / (GM / HS);
  const bool scorer = sg < G && srg < min(KT, SRG);
  // P.V: a unit is (GH heads from hg GH, 16-byte chunk c of Dv); RG row
  // groups split the rows
  const int NC = (Dv + V - 1) / V, U = (GM / GH) * NC;
  const int RG = NT / U, un = tid % U, prg = tid / U;
  const int hg = un / NC, pc = un - hg * NC;
  const bool pv = prg < RG;
  float acc[GH][V];
#pragma unroll
  for (int h = 0; h < GH; ++h)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[h][e] = 0.f;

  for (int j = 0; j < STAGES - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  const T* qb =
      static_cast<const T*>(p.q) + ((size_t)b * H + (size_t)kh * G) * D;
  for (int e = tid; e < G * D; e += NT) Qs[e / D * QS + e % D] = to_f32(qb[e]);

  for (int j = 0; j < 2 * nt; ++j) {
    cp_async_wait<STAGES - 2>();
    if (is_tma(j)) {
      hopper::mbar_wait(full + j % STAGES, (phase >> (j % STAGES)) & 1);
      phase ^= 1u << (j % STAGES);
    }
    __syncthreads();            // tile j is in; tile j - 1's stage is free
    issue(j + STAGES - 1);
    cp_async_commit();
    const T* tile = ring + (j % STAGES) * stage;
    if (j < nt) {               // scores of K tile j
      const int rows = min(KT, n - j * KT);
      if (scorer) {
        // every thread runs all its chains (rows past the tile hold stale
        // data, heads past G read other shared memory; neither is
        // stored), so the chains interleave freely
        float sc[HS][RPT];
#pragma unroll
        for (int h = 0; h < HS; ++h)
#pragma unroll
          for (int i = 0; i < RPT; ++i) sc[h][i] = 0.f;
        const float* qg = Qs + sg * QS;
        if (p.vec) {
          // q in registers QD elements at a time: whole blocks with no
          // branch between chunks (so the next chunk's loads are hoisted
          // over this one's FMAs), then the tail block
          int d0 = 0;
          for (; d0 + QD <= D; d0 += QD) {
            float qv[HS][QD];
            load_q<HS>(qv, qg + d0, QS, QD);
            score_block<T, SW, HS, RPT, SRG, true>(sc, qv, tile, srg,
                                                   d0 / V, p.ks, QD);
          }
          if (d0 < D) {
            float qv[HS][QD];
            load_q<HS>(qv, qg + d0, QS, D - d0);
            score_block<T, SW, HS, RPT, SRG, false>(sc, qv, tile, srg,
                                                    d0 / V, p.ks, D - d0);
          }
        } else {
          for (int d = 0; d < D; ++d)
#pragma unroll
            for (int h = 0; h < HS; ++h)
#pragma unroll
              for (int i = 0; i < RPT; ++i)
                sc[h][i] += qg[h * QS + d] *
                            to_f32(tile[(srg + i * SRG) * p.ks + d]);
        }
#pragma unroll
        for (int h = 0; h < HS; ++h)
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = srg + i * SRG;
            if (sg + h < G && r < rows)
              Ps[(sg + h) * KCP + j * KT + r] =
                  all_masked ? NEG_INF : sc[h][i] * p.scale;
          }
      }
      continue;
    }
    const int t = j - nt;
    if (t == 0) {               // every score is in: the split's softmax
      for (int g = warp; g < G; g += NT / 32) {
        float* sr = Ps + g * KCP;
        float mx = -INFINITY;
        for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sr[i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
        for (int i = lane; i < n; i += 32) {
          const float e = expf(sr[i] - mx);
          sr[i] = e;
          sum += e;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          ml[2 * (row + g)] = mx;
          ml[2 * (row + g) + 1] = sum;
        }
      }
      __syncthreads();
    }
    const int rows = min(KT, n - t * KT);       // P.V of V tile t
    if (pv) {
      const float* pr = Ps + hg * GH * KCP + t * KT;

#pragma unroll 2
      for (int r = prg; r < rows; r += RG) {
        float vf[V];
        if (p.vec) {
          unpack(*reinterpret_cast<const uint4*>(
                     tile + chunk_off<T, SW>(r, pc, p.vs)), vf);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            vf[e] = pc * V + e < Dv ? to_f32(tile[r * p.vs + pc * V + e])
                                    : 0.f;
        }
#pragma unroll
        for (int h = 0; h < GH; ++h) {   // heads past G: junk, not stored
          const float pw = pr[h * KCP + r];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[h][e] += pw * vf[e];
        }
      }
    }
  }

  cp_async_wait<0>();

  // the split's acc: row groups added in order (through the ring, free
  // now), then to the scratch
  if (RG > 1) {
    // red[(h V + e) NT + tid]: each thread's sums, element-major, so the
    // stores and the row-group reads are free of bank conflicts
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (pv)
#pragma unroll
      for (int h = 0; h < GH; ++h)
#pragma unroll
        for (int e = 0; e < V; ++e) red[(h * V + e) * NT + tid] = acc[h][e];
    __syncthreads();
    for (int i = tid; i < U * GH * V; i += NT) {
      const int uu = i % U, he = i / U, h = he / V, e = he % V;
      const int g = (uu / NC) * GH + h, dv = (uu % NC) * V + e;
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < RG; ++r) s += red[he * NT + r * U + uu];
      if (g < G && dv < Dv) pacc[(row + g) * Dv + dv] = s;
    }
  } else if (pv) {
#pragma unroll
    for (int h = 0; h < GH; ++h) {
      const int g = hg * GH + h;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (g < G && pc * V + e < Dv)
          pacc[(row + g) * Dv + pc * V + e] = acc[h][e];
    }
  }
}

// One CTA per (query head h, sequence b): the sequence's u splits x0 ..
// x0 + u - 1 in split order; the splits' acc are staged in shared memory
// with cp.async, many splits at a time, then added in order.
template <typename T>
__global__ void __launch_bounds__(NTC)
decode_combine_kernel(const Params p) {
  extern __shared__ __align__(16) float wsm[];  // [nx] w, [nx] l w, [SB][Dv]
  __shared__ int plan[5];
  __shared__ float ML[2];                       // M, then L
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = p.H, Dv = p.Dv;
  if (tid == 0) split_of(p, -1, b, plan);
  __syncthreads();
  const int x0 = plan[3], u = plan[4];
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* pacc = p.part + ((size_t)x0 * H + h) * Dv;  // + s H Dv
  const float* ml = p.part + (size_t)p.nx * H * Dv + 2 * ((size_t)x0 * H + h);
  float* W = wsm;
  float* LW = wsm + p.nx;
  float* A = wsm + ((2 * p.nx + 3) & ~3);
  const int SB = max(1, (CMB_FLOATS - ((2 * p.nx + 3) & ~3)) / Dv);
  // splits s0 .. s0 + SB - 1 of acc into A (cp.async, all in flight)
  auto stage = [&](int s0) {
    const int nb = min(SB, u - s0);
    if (Dv % 4 == 0) {
      for (int c = tid; c < nb * Dv / 4; c += NTC) {
        const int sb = c / (Dv / 4), cc = c - sb * (Dv / 4);
        cp_async16(A + sb * Dv + 4 * cc,
                   pacc + (size_t)(s0 + sb) * H * Dv + 4 * cc);
      }
    } else {
      for (int c = tid; c < nb * Dv; c += NTC) {
        const int sb = c / Dv, cc = c - sb * Dv;
        A[c] = pacc[(size_t)(s0 + sb) * H * Dv + cc];
      }
    }
    cp_async_commit();
  };
  stage(0);                     // in flight while the weights are made
  for (int s = tid; s < u; s += NTC) {
    W[s] = ml[2 * (size_t)s * H];
    LW[s] = ml[2 * (size_t)s * H + 1];
  }
  __syncthreads();
  if (tid < 32) {
    float M = -INFINITY;
    for (int s = tid; s < u; s += 32) M = fmaxf(M, W[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    if (tid == 0) ML[0] = M;
  }
  __syncthreads();
  for (int s = tid; s < u; s += NTC) {
    W[s] = expf(W[s] - ML[0]);
    LW[s] *= W[s];
  }
  __syncthreads();
  if (tid == 0) {
    float L = 0.f;
#pragma unroll 8
    for (int s = 0; s < u; ++s) L += LW[s];
    ML[1] = fmaxf(L, 1e-30f);
  }
  float o[OUT_MAX / NTC];
#pragma unroll
  for (int i = 0; i < OUT_MAX / NTC; ++i) o[i] = 0.f;
  for (int s0 = 0; s0 < u; s0 += SB) {
    const int nb = min(SB, u - s0);
    if (s0 > 0) {
      __syncthreads();          // every thread is done with the last round
      stage(s0);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < OUT_MAX / NTC; ++i) {
      const int dv = tid + i * NTC;
      if (dv < Dv) {
        float a = o[i];
#pragma unroll 8
        for (int sb = 0; sb < nb; ++sb) a += A[sb * Dv + dv] * W[s0 + sb];
        o[i] = a;
      }
    }
  }
  T* ob = static_cast<T*>(p.o) + ((size_t)b * H + h) * Dv;
#pragma unroll
  for (int i = 0; i < OUT_MAX / NTC; ++i) {
    const int dv = tid + i * NTC;
    if (dv < Dv) store(ob + dv, o[i] / ML[1]);
  }
}

// Shared memory of one split CTA, in bytes (kernel.py's plan mirrors it).
template <typename T, int MODE>
size_t smem_bytes(const Params& p) {
  const int G = p.H / p.Kh;
  int GM = 1;
  while (GM < G) GM *= 2;
  return 1024 + ring_bytes<T, MODE>(p) +
         sizeof(float) * ((size_t)G * (p.D + 4) + (size_t)GM * (p.KC | 1));
}

template <typename T, int GM, int MODE>
cudaError_t launch_gm(const Params& p, const CUtensorMap& tk,
                      const CUtensorMap& tv, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int GH = GM < PV_REGS / V ? GM : PV_REGS / V;
  // the P.V units over NT threads; the combine's outputs and staging
  constexpr int NT = nt_of(GM);
  if ((GM / GH) * ((p.Dv + V - 1) / V) > NT || p.Dv > OUT_MAX ||
      ((2 * p.nx + 3) & ~3) + p.Dv > CMB_FLOATS)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, MODE>(p);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, GM, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, GM, MODE><<<dim3(p.nx, p.Kh), NT, smem, stream>>>(
      p, tk, tv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.H, p.B);
  cfg.blockDim = dim3(NTC);
  cfg.dynamicSmemBytes = CMB_FLOATS * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, p)) !=
      cudaSuccess)
    return err;
  return cudaGetLastError();
}

template <typename T, int GM>
cudaError_t launch_mode(const Params& p, int mode, const CUtensorMap& tk,
                        const CUtensorMap& tv, cudaStream_t s) {
  if constexpr (GM <= 2) {
    if (mode == SWIZZLED) return launch_gm<T, GM, SWIZZLED>(p, tk, tv, s);
    if (mode == DENSE) return launch_gm<T, GM, DENSE>(p, tk, tv, s);
  }
  return launch_gm<T, GM, PADDED>(p, tk, tv, s);
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), KT = kt_rows<T>(), BW = 128 / sizeof(T);
  const int G = p.H / p.Kh;
  // padded layout: rows of whole 16-byte units, an odd number of them
  p.ks = ((p.D + V - 1) / V | 1) * V;
  p.vs = ((p.Dv + V - 1) / V | 1) * V;
  p.vec = p.D % V == 0 && p.Dv % V == 0 &&
          ((uintptr_t)p.k | (uintptr_t)p.v) % 16 == 0;
  // TMA tiles at G <= 2: SWIZZLED where rows are whole 128-byte boxes,
  // else DENSE (one box of whole rows, at most 256 elements)
  CUtensorMap tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  const CUtensorMapDataType dt = sizeof(T) == 2
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int mode = PADDED;
  if (G <= 2 && p.vec)
    mode = p.D % BW == 0 && p.Dv % BW == 0 ? SWIZZLED
           : p.D <= 256 && p.Dv <= 256     ? DENSE
                                           : PADDED;
  if (mode != PADDED) {
    const bool sw = mode == SWIZZLED;
    const CUtensorMapSwizzle z =
        sw ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
    const uint64_t rows = (uint64_t)p.B * p.Sk, E = sizeof(T);
    const uint64_t dk[2] = {(uint64_t)p.Kh * p.D, rows}, sk[1] = {dk[0] * E};
    const uint64_t dvv[2] = {(uint64_t)p.Kh * p.Dv, rows};
    const uint64_t sv[1] = {dvv[0] * E};
    const uint32_t bk[2] = {sw ? (uint32_t)BW : (uint32_t)p.D, (uint32_t)KT};
    const uint32_t bv[2] = {sw ? (uint32_t)BW : (uint32_t)p.Dv, (uint32_t)KT};
    if (!hopper_host::encode(&tk, dt, p.k, 2, dk, sk, bk, z) ||
        !hopper_host::encode(&tv, dt, p.v, 2, dvv, sv, bv, z))
      mode = PADDED;
    else if (mode == DENSE) {   // unpadded rows, as the box writes them
      p.ks = p.D;
      p.vs = p.Dv;
    }
  }
#define DECODE_GM(N) \
  if (G <= N) return launch_mode<T, N>(p, mode, tk, tv, s);
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

// q [B, H, D], k [B, Sk, Kh, D], v [B, Sk, Kh, Dv] (one dtype, is_bf16),
// pos [B] int32, part float32 [nx H (Dv + 2)], o [B, H, Dv].  nx split
// CTAs per kv head (nx > B); a split holds at most KC positions, which
// kernel.py's plan makes at least ceil(B Sk / (nx - B)) and cmin (and at
// most Sk); kt / stages the kernel's own tile rows and ring depth, which
// the plan states.  Two launches (split, combine).  Returns a cudaError_t.
int attn_decode_fwd(const void* q, const void* k, const void* v,
                    const void* pos, void* part, void* o, int B, int Sk,
                    int H, int Kh, int D, int Dv, int KC, int cmin, int nx,
                    int kt, int stages, float scale, int is_bf16,
                    void* stream) {
  if (B <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh || H / Kh > G_MAX ||
      D <= 0 || Dv <= 0 || cmin <= 0 || KC < min(cmin, Sk) || nx <= B ||
      Kh > 65535 || B > 65535 ||
      ((long long)KC * (nx - B) < (long long)B * Sk && KC < Sk) ||
      stages != STAGES ||
      kt != (is_bf16 ? kt_rows<__nv_bfloat16>() : kt_rows<float>()))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int*>(pos), static_cast<float*>(part),
           o, B, Sk, H, Kh, D, Dv, KC, cmin, nx, kt, 0, 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

}  // extern "C"
