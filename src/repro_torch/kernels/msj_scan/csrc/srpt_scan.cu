// Preemptive SRPT-family event scan for Hopper (sm_90a): ServerFilling-SRPT
// and FirstFit-SRPT, one thread block per replication, plus the block-wide
// stable bitonic sort it is built on.
//
// Replaces the Pallas kernels of the JAX reference package:
//   srpt_scan    <- repro/kernels/msj_scan/srpt.py  srpt_scan_fwd (_srpt_kernel)
//   stable_sort  <- repro/kernels/msj_scan/sort.py  bitonic_sort (in-kernel
//                   primitive of srpt_scan_fwd; here a device function with a
//                   standalone entry so it can be held and timed on its own)
// and computes, bit for bit, the 2J event steps of
// repro/core/sim_jax.py _srpt_make_step and of its plain PyTorch version
// repro_torch/core/sim_torch.py _srpt_step.
//
// What bounds this kernel.  Each replication is a chain of 2J dependent
// events; every event re-ranks the in-system jobs (a stable sort), picks
// the running set (SF: the rank prefix M reaching k, re-sorted by
// descending need; FF: a first-fit walk) and preempts or starts jobs.  The
// bytes the function must move (the [R, J] inputs and [R, 2J] outputs once)
// take microseconds at 3.35 TB/s, so the kernel is latency-bound by the
// event chain and, inside an event, by the block barriers of the sort
// (one per bitonic stage) and of the scans.  The design keeps the whole
// slot table on chip and sorts only the occupied slots: empty slots carry
// +inf keys in the reference, sort after every occupied one and never
// run, so the positions that reach the outputs are the occupied prefix.
//
// Shared-memory layout (Q slots; Q = 4096 at k = 1024 takes 164 KiB, so
// the block opts in above 48 KiB; Q = 8192 does not fit and the launch is
// refused with cudaErrorInvalidValue):
//   job  int32[Q]   job id, -1 = empty         need int32[Q]
//   rem  double[Q]  remaining work             rs   double[Q] run start
//   rk   double[Q]  this event's rank          flg  uint8[Q]  bit0 running,
//   lst  int32[Q]   sort-1 order (slot ids)                   bit1 started,
//   aux  int32[Q]   sort-2 order (SF only)                    bit2 desired
// The first-start column lives in a global scratch [R, Q] (read only at a
// departure, so it stays in L2), and a slot's arrival time is read from the
// trace by job id (needed only to break rank ties).
//
// Where bit-identity with the reference breaks if one is careless:
//   * FMA: built with --fmad=false; comp = rs + rem, cur_rem =
//     max(0, rem - (t - rs)) for running jobs, rank = cur_rem * need (SF).
//   * Sort 1 orders by (rank, arrival, slot): a total order, so any
//     correct sort gives the reference's permutation.  Sort 2 (SF) orders
//     the prefix M by (-need, rank, sort-1 position); rank is nondecreasing
//     along sort-1 positions, so that is (-need, position), also total.
//     Only M is sorted: positions outside M never run.
//   * First fit.  SF walks M in descending-need groups, and the sequential
//     walk "take iff need <= free" takes the first min(count, free / n)
//     jobs of a group of need n; FF runs the reference's rounds (u = the
//     largest need value <= free; take the eligible prefix while
//     free - (prefix sum before) >= u) with block prefix sums.
//   * Ties: argmin of completion times and the first free slot take the
//     lowest index; an arrival wins a tie with a departure (Ta <= Tc).
//   * Overflow: an arrival that finds no free slot is dropped, sets ovf and
//     still advances the cursor and counts in the peak.
//   * Records: the departure record is read before the slot is cleared; a
//     non-departure step writes (-1, 0, 0); the first start is set once.
// The arrival cursor is clamped to the trace, and a need outside the NU
// table maps to a neighbouring entry; the host checks that every need is in
// NU, so valid input never reaches that case.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kBig = 1e30;
constexpr double kGuard = 0.5 * kBig;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxNU = 64;
constexpr int kIntMax = 0x7fffffff;

enum : uint8_t { kRun = 1, kStarted = 2, kDesired = 4 };

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Block-wide stable bitonic sort of the ids in ids[0..P) (P a power of two)
// under the strict total order less(a, b).  One barrier per stage; the
// caller must have synchronised after writing ids.
template <class Less>
__device__ void bitonic_sort_ids(int* ids, int P, Less less) {
  const int half = P >> 1;
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int i = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int j = i + stride;
        const int a = ids[i], b = ids[j];
        const bool asc = (i & size) == 0;
        if (asc ? less(b, a) : less(a, b)) {
          ids[i] = b;
          ids[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Exclusive block scan of one int per thread; *total gets the block sum.
// Two barriers.  scratch holds 33 ints and must not be reused by another
// call before the next block barrier.
__device__ int block_scan_excl(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nw ? scratch[lane] : 0;
    int s = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    if (lane < nw) scratch[lane] = s - w;
    if (lane == 31) scratch[32] = s;
  }
  __syncthreads();
  *total = scratch[32];
  return scratch[warp] + x - v;
}

// Stable lexicographic order on slot ids: (rank, arrival, slot).  Ids >= Q
// are padding and sort last.
struct RankLess {
  const double* rk;
  const int* job;
  const double* arrival;
  int Q;
  __device__ bool operator()(int a, int b) const {
    if (a >= Q || b >= Q) return (a >= Q) == (b >= Q) ? a < b : b >= Q;
    const double ka = rk[a], kb = rk[b];
    if (ka != kb) return ka < kb;
    const double aa = arrival[job[a]], ab = arrival[job[b]];
    if (aa != ab) return aa < ab;
    return a < b;
  }
};

// Order of the SF prefix M: (-need, sort-1 position).  Ids >= Q are padding.
struct NeedDescLess {
  const int* need;
  const int* lst;
  int Q;
  __device__ bool operator()(int a, int b) const {
    if (a >= Q || b >= Q) return (a >= Q) == (b >= Q) ? a < b : b >= Q;
    const int na = need[lst[a]], nb = need[lst[b]];
    if (na != nb) return na > nb;
    return a < b;
  }
};

// (key1, key2, index) over one row of the standalone sort; ids >= W are
// the +inf padding.
struct KeyLess {
  const double* k1;
  const double* k2;  // nullptr with one key
  int W;
  __device__ bool operator()(int a, int b) const {
    const double a1 = a < W ? k1[a] : INFINITY, b1 = b < W ? k1[b] : INFINITY;
    if (a1 != b1) return a1 < b1;
    if (k2 != nullptr) {
      const double a2 = a < W ? k2[a] : INFINITY, b2 = b < W ? k2[b] : INFINITY;
      if (a2 != b2) return a2 < b2;
    }
    return a < b;
  }
};

__device__ __forceinline__ int nu_index(const int* nu, int nnu, int n) {
  int lo = 0, hi = nnu - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (nu[mid] < n) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Shared {
  int red_i[32], red_f[32], red_n[32];
  double red_v[32];
  int scan1[33], scan2[33], scan3[33];
  int nu[kMaxNU], gstart[kMaxNU], gend[kMaxNU], glim[kMaxNU];
  int idx_m, ptr[2], dsum[2];
};

__device__ __forceinline__ double cur_rem_of(uint8_t f, double rem, double rs,
                                             double t) {
  if (!(f & kRun)) return rem;
  const double x = __dsub_rn(rem, __dsub_rn(t, rs));
  return x > 0.0 ? x : 0.0;
}

template <bool SF>
__global__ void srpt_scan_kernel(const double* __restrict__ arrival,
                                 const double* __restrict__ need_in,
                                 const double* __restrict__ service,
                                 const double* __restrict__ kk_in,
                                 const int* __restrict__ nu_in, int nnu,
                                 double* __restrict__ job_ev,
                                 double* __restrict__ t_ev,
                                 double* __restrict__ fs_ev,
                                 bool* __restrict__ ovf_out,
                                 int* __restrict__ npre_out,
                                 int* __restrict__ ne_out,
                                 int* __restrict__ peak_out,
                                 double* __restrict__ fstart_scratch, int J,
                                 int Q) {
  extern __shared__ double smem[];
  __shared__ Shared sh;
  double* rem = smem;
  double* rs = rem + Q;
  double* rk = rs + Q;
  int* job = reinterpret_cast<int*>(rk + Q);
  int* need = job + Q;
  int* lst = need + Q;
  int* aux = lst + Q;
  uint8_t* flg = reinterpret_cast<uint8_t*>(aux + Q);

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const double* nd_in = need_in + off;
  const double* sv = service + off;
  double* jo = job_ev + 2 * off;
  double* to = t_ev + 2 * off;
  double* fo = fs_ev + 2 * off;
  double* fstart = fstart_scratch + (size_t)blockIdx.x * Q;
  const double kk = kk_in[blockIdx.x];

  for (int i = tid; i < Q; i += T) {
    job[i] = -1;
    need[i] = 0;
    rem[i] = 0.0;
    rs[i] = 0.0;
    flg[i] = 0;
  }
  for (int c = tid; c < nnu; c += T) sh.nu[c] = nu_in[c];
  int ai = 0, ne = 0, peak = 0, npre = 0;
  bool ovf = false;
  __syncthreads();

  for (int e = 0; e < 2 * J; ++e) {
    // -- earliest departure (first index), first free slot, occupancy
    double bv = INFINITY;
    int bi = kIntMax, bf = kIntMax, cnt = 0;
    for (int i = tid; i < Q; i += T) {
      const double c = (flg[i] & kRun) ? __dadd_rn(rs[i], rem[i]) : kBig;
      if (c < bv) { bv = c; bi = i; }
      if (job[i] < 0) bf = min(bf, i); else ++cnt;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      bf = min(bf, __shfl_xor_sync(kFull, bf, o));
      cnt += __shfl_xor_sync(kFull, cnt, o);
    }
    if (lane == 0) {
      sh.red_v[warp] = bv; sh.red_i[warp] = bi;
      sh.red_f[warp] = bf; sh.red_n[warp] = cnt;
    }
    __syncthreads();
    double Tc = INFINITY;
    int qd = kIntMax, fs = kIntMax, n_occ = 0;
    for (int w = 0; w < nw; ++w) {
      const double v = sh.red_v[w];
      const int vi = sh.red_i[w];
      if (v < Tc || (v == Tc && vi < qd)) { Tc = v; qd = vi; }
      fs = min(fs, sh.red_f[w]);
      n_occ += sh.red_n[w];
    }

    // -- the event: next arrival against the earliest departure
    const int j_arr = min(ai, J - 1);
    const double Ta = ai < J ? a[j_arr] : INFINITY;
    const bool is_arr = ai < J && Ta <= Tc;
    const bool is_dep = !is_arr && Tc < kGuard;
    const bool active = is_arr || is_dep;
    ne += active ? 1 : 0;
    const double t = is_arr ? Ta : Tc;
    const bool has_free = fs < Q;
    const bool do_ins = is_arr && has_free;
    ovf = ovf || (is_arr && !has_free);
    peak = max(peak, n_occ + (do_ins ? 1 : 0) - (is_dep ? 1 : 0)
                         + ((is_arr && !has_free) ? 1 : 0));
    ai += is_arr ? 1 : 0;

    if (tid == 0) {
      // departure record, read before the slot is cleared
      jo[e] = is_dep ? (double)job[qd] : -1.0;
      to[e] = is_dep ? Tc : 0.0;
      fo[e] = is_dep ? fstart[qd] : 0.0;
      const int s = do_ins ? fs : (is_dep ? qd : -1);
      if (s >= 0) {
        job[s] = is_arr ? j_arr : -1;
        need[s] = is_arr ? (int)nd_in[j_arr] : 0;
        rem[s] = is_arr ? sv[j_arr] : 0.0;
        rs[s] = 0.0;
        flg[s] = 0;
        fstart[s] = 0.0;
      }
      sh.idx_m = kIntMax;
    }
    for (int c = tid; c < nnu; c += T) { sh.gstart[c] = 0; sh.gend[c] = 0; }
    __syncthreads();

    // -- ranks, and the occupied slots compacted in slot order
    const int E = (Q + T - 1) / T;
    const int i0 = min(Q, tid * E), i1 = min(Q, i0 + E);
    int mine = 0;
    for (int i = i0; i < i1; ++i) {
      const bool occ = job[i] >= 0;
      flg[i] &= (uint8_t)~kDesired;
      if (occ) {
        const double cr = cur_rem_of(flg[i], rem[i], rs[i], t);
        rk[i] = SF ? __dmul_rn(cr, (double)need[i]) : cr;
        ++mine;
      } else {
        rk[i] = INFINITY;
      }
    }
    int n;
    int p = block_scan_excl(mine, sh.scan1, &n);
    for (int i = i0; i < i1; ++i)
      if (job[i] >= 0) lst[p++] = i;
    const int P = pow2_ceil(max(n, 1));
    for (int q = n + tid; q < P; q += T) lst[q] = Q + q;
    __syncthreads();

    // -- sort 1: occupied slots by (rank, arrival, slot)
    bitonic_sort_ids(lst, P, RankLess{rk, job, a, Q});

    if (SF) {
      // prefix M: the shortest rank prefix whose cumulative need reaches k
      const int Ep = (n + T - 1) / T;
      const int p0 = min(n, tid * Ep), p1 = min(n, p0 + Ep);
      int s = 0;
      for (int q = p0; q < p1; ++q)
        if (rk[lst[q]] < kGuard) s += need[lst[q]];
      int total;
      int cum = block_scan_excl(s, sh.scan2, &total);
      for (int q = p0; q < p1; ++q) {
        if (rk[lst[q]] < kGuard) cum += need[lst[q]];
        if ((double)cum >= kk) { atomicMin(&sh.idx_m, q); break; }
      }
      __syncthreads();
      const bool has_m = (double)total >= kk;
      if (has_m) {
        // sort 2: M by (-need, position); then the first-fit walk over
        // the descending-need groups, in closed form per group
        const int m = sh.idx_m + 1;
        const int P2 = pow2_ceil(m);
        for (int q = tid; q < P2; q += T) aux[q] = q < m ? q : Q + q;
        __syncthreads();
        bitonic_sort_ids(aux, P2, NeedDescLess{need, lst, Q});
        for (int q = tid; q < m; q += T) {
          const int c = nu_index(sh.nu, nnu, need[lst[aux[q]]]);
          if (q == 0 || nu_index(sh.nu, nnu, need[lst[aux[q - 1]]]) != c)
            sh.gstart[c] = q;
          if (q == m - 1 || nu_index(sh.nu, nnu, need[lst[aux[q + 1]]]) != c)
            sh.gend[c] = q + 1;
        }
        __syncthreads();
        if (tid == 0) {
          double F = kk;
          for (int c = nnu - 1; c >= 0; --c) {
            const int cntc = sh.gend[c] - sh.gstart[c];
            const double v = (double)sh.nu[c];
            int lim = 0;
            if (cntc > 0 && v <= F) {
              lim = (int)floor(F / v);
              while ((double)(lim + 1) * v <= F) ++lim;
              while (lim > 0 && (double)lim * v > F) --lim;
              lim = min(lim, cntc);
              F = __dsub_rn(F, (double)lim * v);
            }
            sh.glim[c] = sh.gstart[c] + lim;
          }
        }
        __syncthreads();
        for (int q = tid; q < m; q += T) {
          const int slot = lst[aux[q]];
          if (q < sh.glim[nu_index(sh.nu, nnu, need[slot])])
            flg[slot] |= kDesired;
        }
      } else {
        for (int q = tid; q < n; q += T) flg[lst[q]] |= kDesired;
      }
      __syncthreads();
    } else {
      // first fit over the rank order, in the reference's rounds
      double F = kk;
      int ptr = 0;
      const int Ep = (n + T - 1) / T;
      const int p0 = min(n, tid * Ep), p1 = min(n, p0 + Ep);
      for (int r = 0; r < nnu; ++r) {
        double u = 0.0;
        for (int c = 0; c < nnu; ++c)
          if ((double)sh.nu[c] <= F) u = (double)sh.nu[c];
        if (u == 0.0) break;
        int s = 0;
        for (int q = p0; q < p1; ++q) {
          const int slot = lst[q];
          const int nq = need[slot];
          const bool el = !(flg[slot] & kDesired) && rk[slot] < kGuard &&
                          nq >= 1 && (double)nq <= u && q >= ptr;
          s += el ? nq : 0;
        }
        if (tid == 0) { sh.ptr[r & 1] = Q; sh.dsum[r & 1] = 0; }
        int total;
        int ex = block_scan_excl(s, sh.scan3, &total);
        int d = 0, miss = kIntMax;
        for (int q = p0; q < p1; ++q) {
          const int slot = lst[q];
          const int nq = need[slot];
          const bool el = !(flg[slot] & kDesired) && rk[slot] < kGuard &&
                          nq >= 1 && (double)nq <= u && q >= ptr;
          if (!el) continue;
          if (__dsub_rn(F, (double)ex) >= u) {
            flg[slot] |= kDesired;
            d += nq;
          } else if (miss == kIntMax) {
            miss = q;
          }
          ex += nq;
        }
        if (d) atomicAdd(&sh.dsum[r & 1], d);
        if (miss != kIntMax) atomicMin(&sh.ptr[r & 1], miss);
        __syncthreads();
        F = __dsub_rn(F, (double)sh.dsum[r & 1]);
        ptr = sh.ptr[r & 1];
        if (ptr >= Q) break;
      }
      __syncthreads();
    }

    // -- preempt / start
    if (active) {
      for (int i = tid; i < Q; i += T) {
        if (job[i] < 0) continue;
        const uint8_t f = flg[i];
        const bool run = f & kRun, des = f & kDesired;
        if (run && !des) {
          rem[i] = cur_rem_of(f, rem[i], rs[i], t);
          ++npre;
          flg[i] = f & (uint8_t)~kRun;
        } else if (des && !run) {
          rs[i] = t;
          if (!(f & kStarted)) fstart[i] = t;
          flg[i] = f | kRun | kStarted;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) npre += __shfl_xor_sync(kFull, npre, o);
  if (lane == 0) sh.red_n[warp] = npre;
  __syncthreads();
  if (tid == 0) {
    int tot = 0;
    for (int w = 0; w < nw; ++w) tot += sh.red_n[w];
    npre_out[blockIdx.x] = tot;
    ne_out[blockIdx.x] = ne;
    peak_out[blockIdx.x] = peak;
    ovf_out[blockIdx.x] = ovf;
  }
}

// Standalone entry to the sort: one block per row of [R, W], W <= 4096.
__global__ void stable_sort_kernel(const double* __restrict__ key1,
                                   const double* __restrict__ key2,
                                   const int* __restrict__ payload,
                                   double* __restrict__ key1_out,
                                   double* __restrict__ key2_out,
                                   int* __restrict__ payload_out, int W,
                                   int P) {
  extern __shared__ double smem[];
  double* k1 = smem;
  double* k2 = k1 + W;
  int* ids = reinterpret_cast<int*>(k2 + (key2 ? W : 0));
  const size_t off = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    k1[i] = key1[off + i];
    if (key2) k2[i] = key2[off + i];
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) ids[i] = i;
  __syncthreads();
  bitonic_sort_ids(ids, P, KeyLess{k1, key2 ? k2 : nullptr, W});
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int s = ids[i];
    key1_out[off + i] = k1[s];
    if (key2) key2_out[off + i] = k2[s];
    payload_out[off + i] = payload[off + s];
  }
}

template <typename K>
cudaError_t prepare_smem(K kernel, size_t bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (bytes + attr.sharedSizeBytes > (size_t)optin) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int srpt_threads(int Q) {
  int t = Q / 4;
  if (t < 32) t = 32;
  if (t > 512) t = 512;
  return t;
}

// Dynamic shared memory of srpt_scan_kernel: rem, rs, rk; job, need, lst,
// aux; flg.
size_t srpt_smem(int Q) {
  return (size_t)Q * (3 * sizeof(double) + 4 * sizeof(int) + 1);
}

}  // namespace

extern "C" {

int msj_srpt_scan(const double* arrival, const double* need,
                  const double* service, const double* kk, const int* nu,
                  int nnu, double* job_ev, double* t_ev, double* fs_ev,
                  bool* ovf, int* npre, int* ne, int* peak,
                  double* fstart_scratch, int R, int J, int Q, int sf,
                  void* stream) {
  if (nnu < 1 || nnu > kMaxNU || Q < 1 || (Q & (Q - 1))) return (int)cudaErrorInvalidValue;
  const size_t smem = srpt_smem(Q);
  const int threads = srpt_threads(Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sf) {
    err = prepare_smem(srpt_scan_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    srpt_scan_kernel<true><<<R, threads, smem, s>>>(
        arrival, need, service, kk, nu, nnu, job_ev, t_ev, fs_ev, ovf, npre,
        ne, peak, fstart_scratch, J, Q);
  } else {
    err = prepare_smem(srpt_scan_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    srpt_scan_kernel<false><<<R, threads, smem, s>>>(
        arrival, need, service, kk, nu, nnu, job_ev, t_ev, fs_ev, ovf, npre,
        ne, peak, fstart_scratch, J, Q);
  }
  return (int)cudaGetLastError();
}

int msj_stable_sort(const double* key1, const double* key2, const int* payload,
                    double* key1_out, double* key2_out, int* payload_out,
                    int R, int W, void* stream) {
  if (W < 1 || W > 4096) return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < W) P <<= 1;
  const size_t smem = (size_t)W * sizeof(double) * (key2 ? 2 : 1) + (size_t)P * sizeof(int);
  cudaError_t err = prepare_smem(stable_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = P / 2;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  stable_sort_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      key1, key2, payload, key1_out, key2_out, payload_out, W, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
