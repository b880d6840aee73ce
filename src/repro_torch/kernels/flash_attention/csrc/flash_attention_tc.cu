// Flash-attention forward for Hopper (sm_90a) with P.V on the tensor
// cores: the bf16 route of the port's flash_attention (kernel.py picks it
// with _flash_route; float32 and other shapes keep flash_attention.cu).
//
// Replaces the Pallas kernel of the JAX reference package
// repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (_flash_fwd_kernel), and computes the function of the model's chunked
// jnp attention repro/models/layers.py:flash_attention (_flash_fwd_impl),
// whose cast points it keeps, as flash_attention.cu does: scores q.k in
// float32 times the float32 scale, masked to NEG_INF = -1e30 where
// key > query (causal) and to -inf past Sk, the probabilities p kept in
// float32 for P.V, the row sum floored at 1e-30, one rounding of
// acc / l to bf16.
//
//   q [B, Sq, H, D], k [B, Sk, Kh, D], v [B, Sk, Kh, Dv] (bf16)
//   -> o [B, Sq, H, Dv] (bf16); query head h reads kv head h / (H / Kh);
//   D and Dv multiples of 16, at most 128; with a non-null lse [B, H, Sq]
//   float32, also each row's m + log(max(l, 1e-30)) (natural log, as
//   flash_attention.cu writes it) for the backward.
//
// Why the scores stay on the CUDA cores.  At the reference's init the
// served models' scores are large (|s| in the hundreds at stablelm-3b and
// yi-9b) and many rows are near-ties between two keys whose v differ by
// tens, so an output near zero moves by ~|v| |ds| when a score moves by
// ds.  A score that differs from the float32 sum q.k by one unit in its
// last place then misses the bf16 limit (1e-5 + 2^-6 |ref|) there.  The
// plain version's scores (a float32 GEMM), flash_attention.cu's and the
// decode kernel's all sum q.k with one FMA per head-dim element in order,
// so their scores agree to the bit; this kernel sums them the same way.
// The tensor cores cannot: their float32 accumulation aligns the terms of
// a k16 step and truncates, and a wgmma Q K^T missed the limit on the
// served models' layers by up to 16 times (PERF.md, §6).
//
// Design.  One CTA per (tile of 64 NWG query rows, head, batch), the
// longest causal tiles launched first (blockIdx.x counts down).  Warps
// 0 .. 4 NWG - 1 are NWG consumer warpgroups of 64 query rows each (one
// when Sq < 128); the last warpgroup is the producer.  Each consumer
// warpgroup loads its query rows once into shared memory.  The producer
// keeps K and V tiles of BK = 64 keys in a three-stage ring: its 128
// threads load each K tile from global memory into shared memory (keys
// past Sk as zeros), and one thread loads V by TMA (a 4-D tensor map over
// [B, S, heads, dim]: a box never crosses a head or a batch, and rows past
// Sk read as zero).  Q and K sit in shared memory as [D/4][rows][4] bf16,
// so a 64-bit load brings 4 head-dim elements of one row.  Per tile a
// consumer warpgroup
//   * computes its 64 x 64 scores with float32 FMAs, each score summed
//     over the head dim in order: thread (rg, kg) = (t / 16, t % 16) owns
//     rows rg + 8 i (i < 8) and keys kg + 16 j (j < 4), so 12 loads feed
//     128 FMAs, and a half-warp's loads hit one row (broadcast) or 16
//     consecutive keys (all banks);
//   * scales and masks them (only tiles that cross the diagonal or Sk are
//     masked; tiles wholly above the diagonal are never loaded: exact,
//     since every row has seen key 0 in the first tile) and runs the
//     online softmax as flash_attention.cu does, with its tile, its key
//     to thread map and its order of sums (4 keys, then xor-shuffles over
//     the row's 16 threads), so m, l and p are its to the bit;
//   * hands p to P V through shared memory (rows padded to 72 floats: the
//     writes conflict at most two ways, the reads not at all), where each
//     thread reads it in the layout of a wgmma register A operand (rows
//     16 w + lane/4 and + 8, keys 2 (lane%4) + {0, 1, 8, 9} of each 16);
//   * computes P V with wgmma m64n64k16, A = p from registers and B = V
//     from shared memory, MN-major (v is [Sk, Dv], Dv contiguous: the
//     transpose bit is set).  p is not rounded to bf16: it goes in as three
//     bf16 parts, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid),
//     which hold all 24 bits of a float32 p, in three wgmmas into one
//     float32 accumulator; v in bf16 is exact, so each product is.  Two
//     parts (16 bits) miss the limit on the served models' layers.  The
//     tile's P V, 64 columns of Dv at a time, is added to O in float32 on
//     the CUDA cores (O = O corr + P V), so the tensor cores never sum
//     more than one tile.
// The epilogue divides O by max(l, 1e-30), rounds once to bf16 and
// stores.  Registers: a consumer thread holds 32 scores, 64 O and 32 P V
// accumulators and 48 words of p parts at Dv = 128; the producer gives
// registers back (setmaxnreg: 56 a thread) and the consumers take 224.
// Shared memory at D = Dv = 128, NWG = 2: V 3 x 16 KB + K 3 x 16 KB +
// Q 32 KB + p 36 KB.  A head dim Dv of 80 is staged at 128 columns (the
// TMA box past the head dim reads zeros): P V runs an N of 128 whose last
// 48 columns are not stored.

#include <math.h>

#include "../../csrc/hopper.cuh"

namespace {

using namespace hopper;

constexpr int BK = 64;         // keys per K / V tile
constexpr int STAGES = 3;      // K / V ring depth
constexpr int ROW = 128;       // bytes per swizzled V tile row (64 bf16)
constexpr int PS = 72;         // floats per row of the p buffer (64 + 8)
constexpr float NEG_INF = -1e30f;

// Shared-memory layout in bytes, from a 1024-byte aligned base (V first:
// its swizzled tiles need the alignment); `corr` holds each row's
// correction per tile and its row sum at the end.  DVA: 64-column tiles
// across the (padded) Dv.
template <int DVA, int NWG>
struct Layout {
  static constexpr int BQ = 64 * NWG;
  static constexpr int V_STAGE = DVA * BK * ROW;
  int k, k_stage, q, p, corr, bar, bytes;
  __host__ __device__ explicit Layout(int D)
      : k(STAGES * V_STAGE), k_stage(BK * D * 2), q(k + STAGES * k_stage),
        p(q + BQ * D * 2), corr(p + NWG * 64 * PS * 4),
        bar(corr + NWG * 64 * 4), bytes(bar + 8 * 3 * STAGES) {}
};

// 4 bf16 (a 64-bit word) to float32, in order.
__device__ __forceinline__ float4 widen(const uint2 w) {
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// Stores 8 bf16 of row `r` (a 16-byte word of the head dim, chunk c8) in
// the [D/4][rows][4] layout.
__device__ __forceinline__ void put8(uint2* dst, int rows, int r, int c8,
                                     const uint4 w) {
  dst[(2 * c8) * rows + r] = make_uint2(w.x, w.y);
  dst[(2 * c8 + 1) * rows + r] = make_uint2(w.z, w.w);
}

// A pair p0, p1 (float32) as three bf16 parts, each packed as one word
// of a wgmma register operand (the lower column in the low half).
__device__ __forceinline__ void split3(float p0, float p1,
                                       uint32_t (&out)[3]) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    out[part] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    p0 -= f.x;   // exact: the rest of p below this part
    p1 -= f.y;
  }
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int DVA, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Sq, int Sk, int H, int Kh, int D, int Dv, float scale,
                int causal) {
  using L = Layout<DVA, NWG>;
  constexpr int BQ = L::BQ;
  constexpr int NO = 32 * DVA;     // O accumulators per thread (N = 64 DVA)
  const L lay(D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  uint64_t* k_full = bar;
  uint64_t* v_full = bar + STAGES;
  uint64_t* free_ = bar + 2 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / Kh);
  const int D8 = D / 8;
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 128);      // every producer thread
      mbar_init(v_full + s, 1);
      mbar_init(free_ + s, 4 * NWG);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * NWG) {  // the producer warpgroup
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pt = threadIdx.x - 128 * NWG;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES, k0 = kt * BK;
      mbar_wait(free_ + s, ((kt / STAGES) & 1) ^ 1);
      if (pt == 0) {
        mbar_expect_tx(v_full + s, L::V_STAGE);
        for (int a = 0; a < DVA; ++a)
          tma_load_4d(smem + s * L::V_STAGE + a * BK * ROW, &tv, v_full + s,
                      64 * a, kh, k0, b);
      }
      // a warp loads the same 8 columns of 32 keys
      uint2* k16 = reinterpret_cast<uint2*>(smem + lay.k + s * lay.k_stage);
#pragma unroll 4
      for (int i = pt; i < BK * D8; i += 128) {
        const int key = i % BK, c8 = i / BK;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (k0 + key < Sk)
          w = __ldg(reinterpret_cast<const uint4*>(
              k + ((size_t)(b * Sk + k0 + key) * Kh + kh) * D + 8 * c8));
        put8(k16, BK, key, c8, w);
      }
      mbar_arrive(k_full + s);
    }
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg + [0, 64)
  if constexpr (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = warp / 4, t = threadIdx.x % 128;
  uint2* q16 = reinterpret_cast<uint2*>(smem + lay.q);
  for (int i = t; i < 64 * D8; i += 128) {   // its query rows, once
    const int r = 64 * wg + i % 64, c8 = i / 64;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      w = __ldg(reinterpret_cast<const uint4*>(
          q + ((size_t)(b * Sq + q0 + r) * H + h) * D + 8 * c8));
    put8(q16, BQ, r, c8, w);
  }
  wg_sync(wg);
  float* pbuf = reinterpret_cast<float*>(smem + lay.p) + wg * 64 * PS;
  float* cbuf = reinterpret_cast<float*>(smem + lay.corr) + wg * 64;

  // score layout: rows 64 wg + rg + 8 i (i < 8), keys kg + 16 j (j < 4)
  const int rg = t / 16, kg = t % 16;
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = NEG_INF, l[i] = 0.f;
  // P V layout: rows fr and fr + 8, key pairs 2 c (+ 8) of each 16
  const int fr = 16 * (warp % 4) + lane / 4, c = lane % 4;
  float o_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES, k0 = kt * BK;
    const uint32_t ph = (kt / STAGES) & 1;
    if (causal && k0 > q0 + 64 * wg + 63) {  // above this warpgroup's rows
      __syncwarp();
      if (lane == 0) mbar_arrive(free_ + s);
      continue;
    }

    // S = Q K^T: one FMA per head-dim element, in order
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    const uint2* k16 =
        reinterpret_cast<const uint2*>(smem + lay.k + s * lay.k_stage);
    mbar_wait(k_full + s, ph);
    const uint2* qrow = q16 + 64 * wg + rg;
    uint2 kw[4], qw[8];   // the words of head-dim step dc, loaded ahead
#pragma unroll
    for (int j = 0; j < 4; ++j) kw[j] = k16[kg + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) qw[i] = qrow[8 * i];
#pragma unroll 2
    for (int dc = 0; dc < D / 4; ++dc) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = widen(kw[j]);
      const int dn = min(dc + 1, D / 4 - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) kw[j] = k16[dn * BK + kg + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = widen(qw[i]);
        qw[i] = qrow[dn * BQ + 8 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[i][j];
          x = fmaf(qv.x, kv[j].x, x);
          x = fmaf(qv.y, kv[j].y, x);
          x = fmaf(qv.z, kv[j].z, x);
          sc[i][j] = fmaf(qv.w, kv[j].w, x);
        }
      }
    }

    // scale, mask, online softmax over the 16 threads of a row (the
    // CUDA-core kernel's tile, order of sums and rounding of m, l and p)
    const bool mask = (causal && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > Sk;
    wg_sync(wg);   // the last tile's reads of the p buffer are done
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + 64 * wg + rg + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * scale;
        if (mask) {
          const int ki = k0 + kg + 16 * j;
          if (ki >= Sk)
            x = -INFINITY;
          else if (causal && ki > qi)
            x = NEG_INF;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        pbuf[(rg + 8 * i) * PS + kg + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
      if (kg == 0) cbuf[rg + 8 * i] = corr;
    }
    wg_sync(wg);

    // p in three bf16 parts, read as P V's k16 register A operands
    const float cr[2] = {cbuf[fr], cbuf[fr + 8]};
    uint32_t pp[3][BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // rows fr, fr + 8; keys +0, +8
        const float2 x = *reinterpret_cast<const float2*>(
            pbuf + (fr + 8 * (r & 1)) * PS + 16 * kk + 8 * (r >> 1) + 2 * c);
        uint32_t w[3];
        split3(x.x, x.y, w);
#pragma unroll
        for (int part = 0; part < 3; ++part) pp[part][kk][r] = w[part];
      }

    // this tile's P V on the tensor cores, 64 columns of Dv at a time,
    // then O = O corr + P V in float32
    const uint8_t* vs = smem + s * L::V_STAGE;
    mbar_wait(v_full + s, ph);
#pragma unroll
    for (int hh = 0; hh < DVA; ++hh) {
      float pv[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            desc_sw128(vs + hh * BK * ROW + kk * 16 * ROW, BK * ROW, 1024);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          wgmma_rs_n64<1>(pv, pp[part][kk], dv, kk > 0 || part > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o_acc[32 * hh + i] = o_acc[32 * hh + i] * cr[(i >> 1) & 1] + pv[i];
    }
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pp[part][kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(free_ + s);   // this warp is done with stage s
  }

  // the row sums to the P V layout, then O / max(l, 1e-30) rounded once
  wg_sync(wg);
  if (kg == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cbuf[rg + 8 * i] = l[i];
      const int qi = q0 + 64 * wg + rg + 8 * i;
      if (lse != nullptr && qi < Sq)
        lse[((size_t)b * H + h) * Sq + qi] =
            m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  wg_sync(wg);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 64 * wg + fr + 8 * i;
    if (qi >= Sq) continue;
    const float li = fmaxf(cbuf[fr + 8 * i], 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)(b * Sq + qi) * H + h) * Dv;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < Dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o_acc[4 * j + 2 * i] / li, o_acc[4 * j + 2 * i + 1] / li);
    }
  }
}

template <int DVA, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int Kh, int D,
                   int Dv, float scale, int causal, cudaStream_t stream) {
  const Layout<DVA, NWG> lay(D);
  CUtensorMap mv;
  const uint64_t E = sizeof(__nv_bfloat16);
  const uint64_t dv[4] = {(uint64_t)Dv, (uint64_t)Kh, (uint64_t)Sk,
                          (uint64_t)B};
  const uint64_t sv[3] = {Dv * E, (uint64_t)Kh * Dv * E,
                          (uint64_t)Sk * Kh * Dv * E};
  const uint32_t bv[4] = {64, 1, BK, 1};
  if (!hopper_host::encode_bf16(&mv, v, 4, dv, sv, bv))
    return cudaErrorInvalidValue;
  const int smem = lay.bytes + 1024;   // + the base's alignment to 1024
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DVA, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 64 * NWG - 1) / (64 * NWG), H, B);
  flash_tc_kernel<DVA, NWG><<<grid, (NWG + 1) * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), mv, static_cast<__nv_bfloat16*>(o),
      lse, Sq, Sk, H, Kh, D, Dv, scale, causal);
  return cudaGetLastError();
}

template <int DVA>
cudaError_t by_rows(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int Sq, int Sk, int H, int Kh, int D,
                    int Dv, float scale, int causal, cudaStream_t s) {
  return Sq >= 128 ? launch<DVA, 2>(q, k, v, o, lse, B, Sq, Sk, H, Kh, D,
                                    Dv, scale, causal, s)
                   : launch<DVA, 1>(q, k, v, o, lse, B, Sq, Sk, H, Kh, D,
                                    Dv, scale, causal, s);
}

}  // namespace

extern "C" {

// bf16 q, k, v, o (and lse, or null) as in flash_attention.cu's
// attn_flash_fwd; D and Dv multiples of 16 up to 128, every pointer
// 16-byte aligned.  Returns a
// cudaError_t (cudaErrorInvalidValue for a shape or pointer it does not
// take, or a tensor map that cannot be encoded).
int attn_flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Sq, int Sk, int H, int Kh,
                      int D, int Dv, float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh ||
      D <= 0 || Dv <= 0 || D % 16 || Dv % 16 || D > 128 || Dv > 128 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return (int)(Dv > 64 ? by_rows<2>(q, k, v, o, l, B, Sq, Sk, H, Kh, D, Dv,
                                    scale, causal, s)
                       : by_rows<1>(q, k, v, o, l, B, Sq, Sk, H, Kh, D, Dv,
                                    scale, causal, s));
}

}  // extern "C"
