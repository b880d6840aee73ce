// Preemptive SRPT-family event scan for Hopper (sm_90a): ServerFilling-SRPT
// and FirstFit-SRPT, one warp per replication, plus a block-wide stable
// bitonic sort with a standalone entry.
//
// Replaces the Pallas kernels of the JAX reference package:
//   srpt_scan    <- repro/kernels/msj_scan/srpt.py  srpt_scan_fwd (_srpt_kernel)
//   stable_sort  <- repro/kernels/msj_scan/sort.py  bitonic_sort (the Pallas
//                   kernel's in-kernel sort primitive; here a standalone entry
//                   so it can be held and timed on its own.  srpt_scan sorts
//                   with the warp-level sorts below, under the same order)
// and computes, bit for bit, the 2J event steps of
// repro/core/sim_jax.py _srpt_make_step and of its plain PyTorch version
// repro_torch/core/sim_torch.py _srpt_step.
//
// What bounds this kernel.  Each replication is a chain of 2J dependent
// events; every event re-ranks the n jobs in the system, picks the running
// set and preempts or starts jobs.  The bytes the function must move (the
// [R, J] inputs and [R, 2J] outputs once) take microseconds at 3.35 TB/s,
// so the kernel is latency-bound by the event chain.  In the regime the
// paper studies nearly every job in the system runs and n is small (mean
// ~70 of Q = 4096 slots on the Fig. 3 path's SDSC-SP2 cells), so one warp
// drives an event over a compact list of the n occupied slots with warp
// shuffles, ballots and __syncwarp: no block barrier, and no per-event
// pass over the Q-slot table.  A warp loops over the list in chunks of 32,
// so a burst with n in the thousands stays correct and costs work in
// proportion to n.  An event:
//   1. decide: the next arrival against the earliest completion (found by
//      the previous event); the record; admission into the lowest free
//      slot of a Q-bit bitmap, or the departed slot cleared;
//   2. rank: ranks at t, and the list split stably into the waiting jobs
//      (ranks unchanged, so still in the previous event's order) and the
//      running ones;
//   3. sort: the running part, in the previous event's order, is nearly
//      sorted: odd-even transposition passes (kMaxPasses at most), else a
//      merge sort (32-entry runs by a register bitonic network across the
//      lanes, then merge-path merges: each lane writes a contiguous range
//      of the output after one binary search); the arrival goes in by one
//      pass of compares, and the waiting part is merged in;
//   4. select: when the needs of all jobs fit in k every job runs;
//      otherwise SF takes the rank prefix M reaching k with a warp prefix
//      sum and, in the same pass, each job's index among M's jobs of its
//      need class (__match_any_sync), and FF runs the reference's rounds;
//   5. update: preempt / start, and the next event's earliest completion.
// What an event costs is the chain of dependent shared-memory loads,
// shuffles and ballots of these passes (repro_torch/bench/srpt_bench.py
// --phases builds a copy of this file with clock64 stamps between the
// passes and prints each one's SM cycles per event).
//
// Slot-table layout (Q slots: 54 bytes and a bit per slot).  In shared
// memory while it fits the block's opt-in limit (216.5 KiB at Q = 4096, so
// the block opts in above 48 KiB); a larger table (Q = 8192: 433 KiB)
// lives in the caller's global scratch, one table per replication
// (msj_srpt_table_bytes), reached through the same Table pointers:
//   rem, rs, arr, fst, rk  double[Q]  remaining work, run start, arrival,
//                                     first start, rank at the last event
//   job  int32[Q]  job id           ord  int32[Q]  the list (slot ids) in
//   tmp  int32[Q]  merge buffer;                   sort-1 order
//                  SF: index within need class
//   occ  uint32[Q/32]  occupied-slot bitmap (bits >= Q preset)
//   cls  uint8[Q]  NU index of the need   flg uint8[Q] bit0 running,
//                                                      bit1 started, bit2 desired
// A slot's fields stay at the slot's index; only the list moves.
//
// Where bit-identity with the reference breaks if one is careless:
//   * FMA: built with --fmad=false; comp = rs + rem, cur_rem =
//     max(0, rem - (t - rs)) for running jobs, rank = cur_rem * need (SF).
//     A waiting job's rank is the one stored when it was admitted or
//     preempted: rem * need, the same product the reference forms.
//   * Sort 1 orders by (rank, arrival, slot): a total order, so any correct
//     sort gives the reference's permutation.  Running jobs do not keep
//     their relative order (SF ranks fall at the rate of the need, and
//     rounding in rem - (t - rs) makes and breaks ties), so their part is
//     sorted again every event, from the previous order.  Sort 2 of the reference (SF: M by (-need, rank,
//     position)) is not needed: within a need class it is the sort-1 order,
//     and the first-fit walk over descending-need classes takes the first
//     min(count, floor(F / nu)) jobs of each class.
//   * FF runs the reference's rounds (u = the largest need value <= free;
//     take the eligible prefix while free - (prefix sum before) >= u); a
//     round ends at its first miss, after which nothing more fits.  The
//     rounds are the sequential first-fit walk, so when the needs of all
//     jobs fit every job is taken (SF: no prefix M, every job runs).
//   * Ties: the argmin of completion times and the first free slot take the
//     lowest slot; an arrival wins a tie with a departure (Ta <= Tc).
//   * Overflow: an arrival that finds no free slot is dropped, sets ovf and
//     still advances the cursor and counts in the peak.
//   * Records: the departure record is read before the slot is cleared; a
//     non-departure step writes (-1, 0, 0); the first start is set once.
// The arrival cursor is clamped to the trace.  The host checks that every
// need is in NU (a need outside it would map to a neighbouring entry).

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

// Bytes of one slot table: five double, three int32 and two uint8 columns,
// and the occupancy bitmap.
__host__ __device__ inline size_t srpt_smem(int Q) {
  return (size_t)Q * (5 * sizeof(double) + 3 * sizeof(int) + 2) +
         (size_t)((Q + 31) / 32) * sizeof(unsigned);
}

// One table in global scratch, in doubles (rounded up to 256 bytes).
__host__ __device__ inline size_t srpt_table_words(int Q) {
  return (srpt_smem(Q) + 255) / 256 * 32;
}

// Odd-even transposition passes tried on the running part before the full
// merge sort.
constexpr int kMaxPasses = 4;

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

__device__ __forceinline__ double cur_rem_of(double rem, double rs, double t) {
  const double x = __dsub_rn(rem, __dsub_rn(t, rs));
  return x > 0.0 ? x : 0.0;
}

// The slot table in shared memory (see the header for the layout).
struct Table {
  double *rem, *rs, *arr, *fst, *rk;
  int *job, *ord, *tmp;
  unsigned* occ;
  uint8_t *cls, *flg;

  // Sort-1 order of two occupied slots: (rank, arrival, slot).
  __device__ __forceinline__ bool less(int a, int b) const {
    const double ka = rk[a], kb = rk[b];
    if (ka != kb) return ka < kb;
    const double aa = arr[a], ab = arr[b];
    if (aa != ab) return aa < ab;
    return a < b;
  }
};

struct Key {
  double r, a;
  int s;
};

__device__ __forceinline__ bool key_less(const Key& x, const Key& y) {
  if (x.r != y.r) return x.r < y.r;
  if (x.a != y.a) return x.a < y.a;
  return x.s < y.s;
}

// Ascending bitonic network over the 32 lanes, on G independent keys per
// lane (G runs sorted at once, so their shuffles overlap).  Keys must be
// distinct: padding carries +inf ranks and distinct ids above every slot.
template <int G>
__device__ __forceinline__ void warp_bitonic32(Key (&k)[G], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        Key o;
        o.r = __shfl_xor_sync(kFull, k[g].r, stride);
        o.a = __shfl_xor_sync(kFull, k[g].a, stride);
        o.s = __shfl_xor_sync(kFull, k[g].s, stride);
        if (key_less(o, k[g]) == keep_min) k[g] = o;
      }
    }
  }
}

// Sorts the 32-entry runs r0 .. r0 + G - 1 of src[0..nr) into dst (the same
// positions; src == dst is allowed).
template <int G>
__device__ void sort_runs(const Table& T, const int* src, int* dst, int r0,
                          int nr, int lane) {
  Key k[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int p = (r0 + g) * 32 + lane;
    if (p < nr) {
      const int id = src[p];
      k[g] = Key{T.rk[id], T.arr[id], id};
    } else {
      k[g] = Key{INFINITY, INFINITY, 0x40000000 + lane};
    }
  }
  __syncwarp();
  warp_bitonic32<G>(k, lane);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int p = (r0 + g) * 32 + lane;
    if (p < nr) dst[p] = k[g].s;
  }
  __syncwarp();
}

// Merges the sorted lists A[0..na) and B[0..nb) into out[0..na+nb) (out
// aliases neither).  Lane l writes the l-th of 32 contiguous output ranges
// after a merge-path binary search for its start.
__device__ void warp_merge(const Table& T, const int* A, int na, const int* B,
                           int nb, int* out, int lane) {
  const int n = na + nb;
  const int L = (n + 31) >> 5;
  const int d0 = min(n, lane * L), d1 = min(n, d0 + L);
  if (d0 < d1) {
    int lo = max(0, d0 - nb), hi = min(d0, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (T.less(A[mid], B[d0 - 1 - mid])) lo = mid + 1; else hi = mid;
    }
    int ia = lo, ib = d0 - lo;
    for (int o = d0; o < d1; ++o) {
      const bool take_a = ib >= nb || (ia < na && T.less(A[ia], B[ib]));
      out[o] = take_a ? A[ia++] : B[ib++];
    }
  }
  __syncwarp();
}

// Sorts the nr ids of T.ord[0..nr) by sort-1 order into dst, which is
// T.ord itself or the free buffer tmp[off..off+nr); the other of the two is
// the ping-pong buffer of the merge levels.
__device__ void sort_list(const Table& T, int nr, int* dst, int off,
                          int lane) {
  if (nr == 0) return;
  const int nruns = (nr + 31) >> 5;
  const int levels = nruns <= 1 ? 0 : 32 - __clz(nruns - 1);
  int* other = dst == T.ord ? T.tmp + off : T.ord;
  int* src = (levels & 1) ? other : dst;
  for (int r = 0; r < nruns; r += 2) {
    if (r + 1 < nruns) sort_runs<2>(T, T.ord, src, r, nr, lane);
    else sort_runs<1>(T, T.ord, src, r, nr, lane);
  }
  int* out = src == dst ? other : dst;
  for (int w = 32; w < nr; w <<= 1) {
    for (int s = 0; s < nr; s += 2 * w) {
      const int na = min(w, nr - s), nb = max(0, min(w, nr - s - w));
      warp_merge(T, src + s, na, src + s + na, nb, out + s, lane);
    }
    int* x = src;
    src = out;
    out = x;
  }
}

// Odd-even transposition passes over ids[0..n) in place; true once a pass
// (an even and an odd phase) swaps nothing, false if the list is still out
// of order after max_passes.  Cheap when the list is nearly sorted.
__device__ bool oddeven_sort(const Table& T, int* ids, int n, int max_passes,
                             int lane) {
  for (int pass = 0; pass < max_passes; ++pass) {
    unsigned any = 0;
    for (int phase = 0; phase < 2; ++phase) {
      for (int b = phase; b + 1 < n; b += 64) {
        const int i = b + 2 * lane;
        bool sw = false;
        if (i + 1 < n) {
          const int x = ids[i], y = ids[i + 1];
          if (T.less(y, x)) {
            ids[i] = y;
            ids[i + 1] = x;
            sw = true;
          }
        }
        any |= __ballot_sync(kFull, sw);
      }
      __syncwarp();
    }
    if (!any) return true;
  }
  return false;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Lowest free slot (bit clear in occ), or -1.
__device__ __forceinline__ int first_free(const unsigned* occ, int nwords,
                                          int lane) {
  for (int w0 = 0; w0 < nwords; w0 += 32) {
    const unsigned x = w0 + lane < nwords ? occ[w0 + lane] : kFull;
    const unsigned b = __ballot_sync(kFull, x != kFull);
    if (b) {
      const int l = __ffs(b) - 1;
      const unsigned xl = __shfl_sync(kFull, x, l);
      return (w0 + l) * 32 + __ffs(~xl) - 1;
    }
  }
  return -1;
}

template <bool SF, bool kGlobal>
__global__ void __launch_bounds__(32)
    srpt_scan_kernel(const double* __restrict__ arrival,
                     const double* __restrict__ need_in,
                     const double* __restrict__ service,
                     const double* __restrict__ kk_in,
                     const int* __restrict__ j_live,
                     const int* __restrict__ nu_in, int nnu,
                     double* __restrict__ job_ev, double* __restrict__ t_ev,
                     double* __restrict__ fs_ev, bool* __restrict__ ovf_out,
                     int* __restrict__ npre_out, int* __restrict__ ne_out,
                     int* __restrict__ peak_out, double* table, int J,
                     int Q) {
  extern __shared__ double smem[];
  __shared__ int nu[kMaxNU], cnt[kMaxNU], glim[kMaxNU];
  Table T;
  // the table: shared memory, or this replication's global scratch (a
  // template choice, so the shared instantiation keeps shared loads)
  T.rem = kGlobal ? table + (size_t)blockIdx.x * srpt_table_words(Q) : smem;
  T.rs = T.rem + Q;
  T.arr = T.rs + Q;
  T.fst = T.arr + Q;
  T.rk = T.fst + Q;
  T.job = reinterpret_cast<int*>(T.rk + Q);
  T.ord = T.job + Q;
  T.tmp = T.ord + Q;
  T.occ = reinterpret_cast<unsigned*>(T.tmp + Q);
  const int nwords = (Q + 31) >> 5;
  T.cls = reinterpret_cast<uint8_t*>(T.occ + nwords);
  T.flg = T.cls + Q;

  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const double* nd_in = need_in + off;
  const double* sv = service + off;
  double* jo = job_ev + 2 * off;
  double* to = t_ev + 2 * off;
  double* fo = fs_ev + 2 * off;
  const double kk = kk_in[blockIdx.x];
  // the lane's jobs: the rest of its row is a grid's padding, never admitted
  const int jl = min(max(j_live[blockIdx.x], 0), J);

  for (int w = lane; w < nwords; w += 32) {
    const int b0 = w * 32;   // bits of slots >= Q are preset (never free)
    T.occ[w] = Q - b0 >= 32 ? 0u : ~((1u << (Q - b0)) - 1u);
  }
  for (int c = lane; c < nnu; c += 32) nu[c] = nu_in[c];
  // each lane keeps NU[lane] and NU[lane + 32] for FF's u
  const double nu_l0 = lane < nnu ? (double)nu_in[lane] : INFINITY;
  const double nu_l1 = lane + 32 < nnu ? (double)nu_in[lane + 32] : INFINITY;
  __syncwarp();

  int ai = 0, ne = 0, peak = 0, npre = 0, n = 0;
  bool ovf = false;
  double Tc = kBig;      // earliest completion among running jobs
  int qd = kIntMax;      // its slot
  double na_t = 0.0, na_need = 0.0, na_svc = 0.0;  // the next arrival
  if (J > 0) { na_t = a[0]; na_need = nd_in[0]; na_svc = sv[0]; }
  int na_cls = nu_index(nu, nnu, (int)na_need);   // its NU index
  long long need_sum = 0;  // the needs of the jobs in the system

  for (int e = 0; e < 2 * J; ++e) {
    // -- the event: next arrival against the earliest departure
    const int j_arr = min(ai, J - 1);
    const double Ta = ai < jl ? na_t : INFINITY;
    const bool is_arr = ai < jl && Ta <= Tc;
    const bool is_dep = !is_arr && Tc < kGuard;
    if (!is_arr && !is_dep) {
      // nothing changes from here on: every later step is a non-event
      for (int x = e + lane; x < 2 * J; x += 32) {
        jo[x] = -1.0;
        to[x] = 0.0;
        fo[x] = 0.0;
      }
      break;
    }
    ++ne;
    const double t = is_arr ? Ta : Tc;
    const bool has_free = n < Q;
    const bool do_ins = is_arr && has_free;
    ovf = ovf || (is_arr && !has_free);
    const int sfree = do_ins ? first_free(T.occ, nwords, lane) : -1;
    if (lane == 0) {
      // departure record, read before the slot is cleared
      jo[e] = is_dep ? (double)T.job[qd] : -1.0;
      to[e] = is_dep ? Tc : 0.0;
      fo[e] = is_dep ? T.fst[qd] : 0.0;
      if (is_dep) {
        T.occ[qd >> 5] &= ~(1u << (qd & 31));
        T.job[qd] = -1;
      }
      if (do_ins) {
        T.occ[sfree >> 5] |= 1u << (sfree & 31);
        T.job[sfree] = j_arr;
        T.cls[sfree] = (uint8_t)na_cls;
        T.flg[sfree] = 0;
        T.rem[sfree] = na_svc;
        T.rs[sfree] = 0.0;
        T.arr[sfree] = na_t;
        T.fst[sfree] = 0.0;
        T.rk[sfree] = SF ? __dmul_rn(na_svc, (double)nu[na_cls]) : na_svc;
      }
    }
    if (is_dep) need_sum -= nu[T.cls[qd]];
    if (do_ins) need_sum += nu[na_cls];
    if (is_arr) {
      ++ai;
      if (ai < jl) { na_t = a[ai]; na_need = nd_in[ai]; na_svc = sv[ai]; }
    }
    peak = max(peak, n + (is_arr ? 1 : 0) - (is_dep ? 1 : 0));
    __syncwarp();

    // -- ranks at t; the list split into waiting jobs (tmp, order kept)
    // and running ones (compacted in place at the front of ord).  Two
    // chunks a step: both chunks' fields are loaded before either is
    // written, so their shared-memory latencies overlap.
    int nw = 0, nr = 0;
    unsigned big = 0;   // a rank at or above the guard (never, in practice)
    for (int b = 0; b < n; b += 64) {
      int id[2], c[2];
      uint8_t f[2];
      double rm[2], st[2], r[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = b + 32 * u + lane;
        id[u] = p < n ? T.ord[p] : -1;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = max(id[u], 0);
        f[u] = T.flg[x];
        rm[u] = T.rem[x];
        st[u] = T.rs[x];
        r[u] = T.rk[x];
        c[u] = T.cls[x];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bool keep = id[u] >= 0 && !(is_dep && id[u] == qd);
        const bool run = keep && (f[u] & kRun);
        if (run) {
          const double cr = cur_rem_of(rm[u], st[u], t);
          r[u] = SF ? __dmul_rn(cr, (double)nu[c[u]]) : cr;
          T.rk[id[u]] = r[u];
        }
        if (keep) T.flg[id[u]] = f[u] & (uint8_t)~kDesired;
        big |= __ballot_sync(kFull, keep && r[u] >= kGuard);
        const unsigned bw = __ballot_sync(kFull, keep && !run);
        const unsigned br = __ballot_sync(kFull, run);
        if (keep && !run) T.tmp[nw + __popc(bw & lt)] = id[u];
        if (run) T.ord[nr + __popc(br & lt)] = id[u];
        nw += __popc(bw);
        nr += __popc(br);
      }
    }
    __syncwarp();

    // -- sort 1.  The running part, in the previous event's order, is
    // nearly sorted: odd-even passes, else the full merge sort.  Then the
    // arrival goes in by one pass of compares and the waiting part (still
    // sorted) is merged in.
    if (!oddeven_sort(T, T.ord, nr, kMaxPasses, lane)) {
      sort_list(T, nr, T.ord, nw, lane);
    }
    if (nw == 0 && do_ins) {
      // in place: the running jobs behind the arrival move up one slot,
      // chunk by chunk from the back
      int q = 0;   // running jobs ahead of the arrival
      for (int b = ((nr - 1) >> 5) << 5; b >= 0; b -= 32) {
        const int p = b + lane;
        const int id = p < nr ? T.ord[p] : 0;
        const bool ahead = p < nr && T.less(id, sfree);
        q += __popc(__ballot_sync(kFull, ahead));
        if (p < nr && !ahead) T.ord[p + 1] = id;
      }
      if (lane == 0) T.ord[q] = sfree;
      ++nr;
      __syncwarp();
    } else if (nw > 0) {
      int q = 0;   // running jobs ahead of the arrival
      for (int b = 0; b < nr; b += 32) {
        const int p = b + lane;
        bool ahead = false;
        if (p < nr) {
          const int id = T.ord[p];
          ahead = do_ins && T.less(id, sfree);
          T.tmp[nw + p + (do_ins && !ahead ? 1 : 0)] = id;
        }
        q += __popc(__ballot_sync(kFull, ahead));
      }
      if (do_ins) {
        if (lane == 0) T.tmp[nw + q] = sfree;
        ++nr;
      }
      __syncwarp();
      warp_merge(T, T.tmp, nw, T.tmp + nw, nr, T.ord, lane);
    }
    n = nw + nr;

    // -- the desired running set
    // When the needs of all the jobs in the system fit in k, every job
    // runs: SF has no prefix M, and FF's first fit takes every job (its
    // candidates are the ranks below the guard).
    bool all_des = SF ? (double)need_sum < kk : (!big && (double)need_sum <= kk);
    int m = 0;  // SF: M is ord[0..m)
    if (all_des) {
    } else if (SF) {
      // M, the shortest rank prefix whose cumulative need reaches k, and
      // each of its jobs' index within its need class in sort-1 order
      for (int c = lane; c < nnu; c += 32) cnt[c] = 0;
      __syncwarp();
      int cum = 0;
      bool has_m = false;
      for (int b = 0; b < n; b += 32) {
        const int p = b + lane;
        const bool valid = p < n;
        const int id = valid ? T.ord[p] : 0;
        const int c = valid ? T.cls[id] : 0;
        const bool ok = valid && T.rk[id] < kGuard;
        const int v = ok ? nu[c] : 0;
        const int incl = warp_incl_scan(v, lane);
        const unsigned hit =
            __ballot_sync(kFull, valid && (double)(cum + incl) >= kk);
        const int last = hit ? __ffs(hit) - 1 : 31;
        const bool in_m = ok && lane <= last;
        const unsigned grp = __match_any_sync(kFull, in_m ? c : -1);
        int base = 0;
        if (in_m) {
          base = cnt[c];
          T.tmp[p] = base + __popc(grp & lt);
        }
        __syncwarp();
        if (in_m && (grp & lt) == 0) cnt[c] = base + __popc(grp);
        __syncwarp();
        cum += __shfl_sync(kFull, incl, 31);
        if (hit) {
          has_m = true;
          m = b + __ffs(hit);
          break;
        }
      }
      if (has_m) {
        // the first-fit walk over M's descending-need classes, in closed
        // form: a class of need v takes its first min(count, F / v) jobs
        if (lane == 0) {
          double F = kk;
          for (int c = nnu - 1; c >= 0; --c) {
            const int cntc = cnt[c];
            const double v = (double)nu[c];
            int lim = 0;
            if (cntc > 0 && v <= F) {
              lim = (int)floor(F / v);
              while ((double)(lim + 1) * v <= F) ++lim;
              while (lim > 0 && (double)lim * v > F) --lim;
              lim = min(lim, cntc);
              F = __dsub_rn(F, (double)lim * v);
            }
            glim[c] = lim;
          }
        }
      } else {
        all_des = true;  // the total need is below k: every job runs
      }
      __syncwarp();
    } else {
      // first fit over the rank order, in the reference's rounds
      double F = kk;
      int ptr = 0;
      for (int r = 0; r < nnu; ++r) {
        const unsigned b0 = __ballot_sync(kFull, nu_l0 <= F);
        const unsigned b1 = __ballot_sync(kFull, nu_l1 <= F);
        const double u = b1 ? (double)nu[63 - __clz(b1)]
                            : (b0 ? (double)nu[31 - __clz(b0)] : 0.0);
        if (u == 0.0) break;
        int base = 0, d = 0, miss = -1;
        for (int b = ptr & ~31; b < n; b += 32) {
          const int p = b + lane;
          const bool valid = p < n && p >= ptr;
          const int id = valid ? T.ord[p] : 0;
          const int nq = valid ? nu[T.cls[id]] : 0;
          const bool el = valid && !(T.flg[id] & kDesired) &&
                          T.rk[id] < kGuard && nq >= 1 && (double)nq <= u;
          const int v = el ? nq : 0;
          const int incl = warp_incl_scan(v, lane);
          const bool take = el && __dsub_rn(F, (double)(base + incl - v)) >= u;
          if (take) {
            T.flg[id] |= kDesired;
            d += nq;
          }
          const unsigned mb = __ballot_sync(kFull, el && !take);
          base += __shfl_sync(kFull, incl, 31);
          if (mb) {
            miss = b + __ffs(mb) - 1;
            break;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
        F = __dsub_rn(F, (double)d);
        if (miss < 0) break;
        ptr = miss;
      }
      __syncwarp();
    }

    // -- preempt / start, and the next event's earliest completion
    double bv = kBig;
    int bi = kIntMax;
    for (int b = 0; b < n; b += 64) {   // two chunks a step, as above
      int id[2], c[2], ix[2];
      uint8_t f[2];
      double rm[2], st[2], r[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = b + 32 * u + lane;
        id[u] = p < n ? T.ord[p] : -1;
        ix[u] = SF && p < m ? T.tmp[p] : 0;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = max(id[u], 0);
        f[u] = T.flg[x];
        rm[u] = T.rem[x];
        st[u] = T.rs[x];
        r[u] = T.rk[x];
        c[u] = T.cls[x];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (id[u] < 0) continue;
        const int p = b + 32 * u + lane;
        const bool des =
            all_des || (SF ? (p < m && r[u] < kGuard && ix[u] < glim[c[u]])
                           : (f[u] & kDesired) != 0);
        const bool run = f[u] & kRun;
        uint8_t g = f[u];
        if (run && !des) {
          rm[u] = cur_rem_of(rm[u], st[u], t);
          T.rem[id[u]] = rm[u];
          ++npre;
          g &= (uint8_t)~kRun;
        } else if (des && !run) {
          st[u] = t;
          T.rs[id[u]] = t;
          if (!(g & kStarted)) T.fst[id[u]] = t;
          g |= kRun | kStarted;
        }
        T.flg[id[u]] = g;
        if (g & kRun) {
          const double cm = __dadd_rn(st[u], rm[u]);
          if (cm < bv || (cm == bv && id[u] < bi)) { bv = cm; bi = id[u]; }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    Tc = bv;
    qd = bi;
    if (is_arr) na_cls = nu_index(nu, nnu, (int)na_need);
    __syncwarp();
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) npre += __shfl_xor_sync(kFull, npre, o);
  if (lane == 0) {
    npre_out[blockIdx.x] = npre;
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

// Whether srpt_scan_kernel's table of Q slots fits its shared memory.
cudaError_t srpt_fits(int Q, bool* fits) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, srpt_scan_kernel<true, false>);
  if (err != cudaSuccess) return err;
  *fits = srpt_smem(Q) + attr.sharedSizeBytes <= (size_t)optin;
  return cudaSuccess;
}

int srpt_launch(const double* arrival, const double* need,
                const double* service, const double* kk, const int* j_live,
                const int* nu,
                int nnu, double* job_ev, double* t_ev, double* fs_ev,
                bool* ovf, int* npre, int* ne, int* peak, double* table, int R,
                int J, int Q, int sf, void* stream) {
  if (nnu < 1 || nnu > kMaxNU || Q < 1 || (Q & (Q - 1)))
    return (int)cudaErrorInvalidValue;
  bool fits = false;
  cudaError_t err = srpt_fits(Q, &fits);
  if (err != cudaSuccess) return (int)err;
  if (!fits && table == nullptr) return (int)cudaErrorInvalidValue;
  if (fits) table = nullptr;
  const size_t smem = table ? 0 : srpt_smem(Q);
  auto launch = [&](auto kernel) {
    const cudaError_t e = prepare_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        arrival, need, service, kk, j_live, nu, nnu, job_ev, t_ev, fs_ev, ovf,
        npre, ne, peak, table, J, Q);
    return cudaGetLastError();
  };
  if (sf)
    err = table ? launch(srpt_scan_kernel<true, true>)
                : launch(srpt_scan_kernel<true, false>);
  else
    err = table ? launch(srpt_scan_kernel<false, true>)
                : launch(srpt_scan_kernel<false, false>);
  return (int)err;
}

}  // namespace

extern "C" {

// kk [R] the servers and j_live [R] the jobs of each lane (J: the row
// stride, their maximum).
int msj_srpt_scan(const double* arrival, const double* need,
                  const double* service, const double* kk, const int* j_live,
                  const int* nu, int nnu, double* job_ev, double* t_ev,
                  double* fs_ev, bool* ovf, int* npre, int* ne, int* peak,
                  void* table, int R, int J, int Q, int sf, void* stream) {
  return srpt_launch(arrival, need, service, kk, j_live, nu, nnu, job_ev, t_ev,
                     fs_ev, ovf, npre, ne, peak, static_cast<double*>(table), R,
                     J, Q, sf, stream);
}

// *bytes = 0 when the table of Q slots fits the kernel's shared memory on
// the current device, else the global scratch msj_srpt_scan needs for
// each replication's table.
int msj_srpt_table_bytes(int Q, long long* bytes) {
  if (Q < 1) return (int)cudaErrorInvalidValue;
  bool fits = false;
  const cudaError_t err = srpt_fits(Q, &fits);
  if (err != cudaSuccess) return (int)err;
  *bytes = fits ? 0 : (long long)(srpt_table_words(Q) * sizeof(double));
  return 0;
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
