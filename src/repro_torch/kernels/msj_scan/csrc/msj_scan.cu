// Multiserver-job event scans for Hopper (sm_90a): FCFS, ModifiedBS-pi and
// BS-pi (Definition 1), one thread block per replication, each with and
// without drain-mode server failures.
//
// Replaces the Pallas kernels of the JAX reference package
// (repro/kernels/msj_scan/kernel.py):
//   fcfs_scan        <- fcfs_scan_fwd        (_fcfs_kernel)
//   fcfs_fail_scan   <- fcfs_fail_scan_fwd   (_fcfs_fail_kernel)
//   modbs_scan       <- modbs_scan_fwd       (_modbs_kernel)
//   modbs_fail_scan  <- modbs_fail_scan_fwd  (_modbs_fail_kernel)
//   bs_scan          <- bs_scan_fwd          (_bs_kernel)
//   bs_fail_scan     <- bs_fail_scan_fwd     (_bs_fail_kernel)
// and computes, bit for bit, the steps of repro/core/sim_jax.py
// (_fcfs_sorted_step, _fcfs_fail_step, _modbs_step, _modbs_fail_step,
// _bs_make_step, _bs_fail_make_step) and of their plain PyTorch versions
// in repro_torch/core/sim_torch.py.  Each kernel body is a template on
// kDrain: the clean scan is the kDrain = false instantiation, whose code
// the drain branches (if constexpr) leave untouched.
//
// What bounds these kernels.  Each replication is a chain of J (BS: 2J)
// dependent event steps; a step reads a few words of the trace and does
// O(k) (FCFS) or O(C*s_max + h) (ModBS, BS) compares and moves on state
// held in shared memory.  The bytes the work must move (the [R, J] inputs
// and outputs once) take well under a millisecond at 3.35 TB/s, so the
// kernels are latency-bound by the serial event chain: time per launch is
// (events) x (latency of one step), and the replications run side by side,
// one block each.  The design therefore keeps every piece of per-step state
// on chip (shared memory and registers; only the BS helper-wait rings, up
// to C*q_cap 24-byte job records per replication, live in a global scratch
// buffer) and spreads the O(k) vector work of a step over the threads of
// the block, with as few barriers per step as the data flow allows.  BS-pi
// also keeps global reads off its step's chain (see its own note).
//
// Where bit-identity with the reference breaks if one is careless:
//   * FMA.  Build with --fmad=false.  The steps only add, take maxima and
//     compare, so float64 results are exact as long as nothing is
//     contracted or reordered.
//   * argmin/argmax take the FIRST index on ties.  With cm = argmin(comp)
//     over the flat [C*s_max] completion matrix, a tie between classes
//     decides which class's rule-3 pull runs.
//   * The BS event order: is_commit = Th <= Tc && Th <= Ta, then
//     is_comp = Tc < Ta, else an arrival.  Ta = +inf once ai >= J; empty
//     A slots hold BIG = 1e30, not inf.
//   * The reference's mode="drop" scatters (to C*q_cap, C*s_max, 3C, C)
//     are skipped, never clamped.
//   * The ring write happens even on overflow; ovf |= enq &&
//     (tail + 1 - head > q_cap), and the host raises on ovf.
//   * rec_t of a non-recording event (tagged == -1) is t_ins, not 0.
//   * Class and need travel as float64 in the reference's packed job
//     record and are cast back to int; here they are read as int32, which
//     is the same value for every valid id.
//   * BS-pi's ring entries and head slots carry a copy of the job's record;
//     a head's class is the ring it came from, which is its clamped class.
// Drain mode (failures merged into the event stream on the host):
//   * A drain on a sorted free-time vector is W[0] := max(W[0], t_up),
//     re-sorted: the n = 1 case of the roll-and-insert.  Pad rows
//     (t = +inf, t_up = 0) are the identity; a drain never moves t_prev.
//   * FCFS and ModBS write the start of every merged row, failure rows
//     included, as the plain step computes it, so the raw outputs compare
//     whole.  ModBS: cls == C is a helper drain; a class drain extends the
//     row's first argmin to max(entry, t_up); only class drains and
//     arrivals write the row; the output is blocked && !is_fail.
//   * BS: a failure cursor fi adds the candidate Tf, which wins ties
//     (Tf <= Ta, Tc, Th and Tf < inf).  Completions need Tc < 0.5 * BIG and
//     arrivals ai < J, because trailing steps past a lane's events are
//     no-ops that still record tagged = -1 and rec_t = t_ins (maybe BIG).
//     A class drain on a free slot writes t_up at the row's first max (a
//     BIG entry) and takes one free slot; on a full row it extends the
//     first argmin to max(vmin, t_up).  A helper drain rolls the W of the
//     step's start.  The host passes length = 2J + F + F_A.
// Indices that come from the trace (class ids, needs) are clamped to their
// buffers, so malformed input cannot touch memory outside them; the host
// validates the trace before launch, and valid input is never clamped.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kBig = 1e30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// Warp-level pieces (ModBS runs one warp per replication; BS-pi's own
// pieces are beside its kernel).
// ---------------------------------------------------------------------------

// First index of the minimum of x[0..m) over the warp; every lane returns it.
__device__ __forceinline__ int warp_argmin(const double* x, int m, double* vmin) {
  const int lane = threadIdx.x & 31;
  double best = INFINITY;
  int bi = 0x7fffffff;
  for (int i = lane; i < m; i += 32) {
    const double v = x[i];
    if (v < best) { best = v; bi = i; }   // ascending i: keeps the first
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov < best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  *vmin = best;
  return bi;
}

// Number of entries of x[0..m) that are <= v (x > v with gt), over the warp.
__device__ __forceinline__ int warp_count_le(const double* x, int m, double v) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    cnt += __popc(__ballot_sync(kFull, i < m && x[i] <= v));
  }
  return cnt;
}

__device__ __forceinline__ int warp_count_gt(const double* x, int m, double v) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    cnt += __popc(__ballot_sync(kFull, i < m && x[i] > v));
  }
  return cnt;
}

// Sorted roll-and-insert of n copies of comp into the warp's free-time
// vector: the n smallest entries of src retire, p = count(src <= comp) - n,
// dst = [src[n:n+p], comp x n, src[n+p:]].  Ends with the warp in sync.
__device__ __forceinline__ void warp_roll_insert(const double* src, double* dst,
                                                 int h, int n, double comp) {
  const int lane = threadIdx.x & 31;
  const int p = warp_count_le(src, h, comp) - n;
  for (int i = lane; i < h; i += 32) {
    double v;
    if (i >= p && i < p + n) {
      v = comp;
    } else {
      v = src[min(i < p ? i + n : i, h - 1)];
    }
    dst[i] = v;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// FCFS: one block per replication, W [k] double-buffered in shared memory.
// Per job: every thread reads W[n-1] and forms start and comp; a block-wide
// ballot count gives p = count(W <= comp) - n (searchsorted "right" on the
// sorted W); each thread writes its entries of the rolled vector.  Two
// barriers per job.  kDrain: J counts merged rows; a failure row inserts
// one copy of max(W[0], t_up) instead (the drain).
// ---------------------------------------------------------------------------

template <bool kDrain>
__global__ void fcfs_scan_kernel(const double* __restrict__ arrival,
                                 const int* __restrict__ need,
                                 const double* __restrict__ service,
                                 const double* __restrict__ t_up,
                                 const bool* __restrict__ is_fail,
                                 double* __restrict__ starts, int J, int k) {
  extern __shared__ double smem[];
  double* Wa = smem;
  double* Wb = smem + k;
  int* wsum = reinterpret_cast<int*>(smem + 2 * k);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const int* nd = need + off;
  const double* sv = service + off;
  double* out = starts + off;

  for (int i = tid; i < k; i += nthr) Wa[i] = 0.0;
  double t_prev = 0.0;
  __syncthreads();
  for (int j = 0; j < J; ++j) {
    const double t = a[j];
    const int n = nd[j];
    const double svc = sv[j];
    const double nth = Wa[clampi(n - 1, 0, k - 1)];
    const double start = fmax(fmax(t, t_prev), nth);
    double comp = __dadd_rn(start, svc);
    int m = n;
    bool drain = false;
    if constexpr (kDrain) {
      drain = is_fail[off + j];
      if (drain) {
        comp = fmax(Wa[0], t_up[off + j]);
        m = 1;
      }
    }
    int cnt = 0;
    for (int base = 0; base < k; base += nthr) {
      const int i = base + tid;
      cnt += __popc(__ballot_sync(kFull, i < k && Wa[i] <= comp));
    }
    if (lane == 0) wsum[warp] = cnt;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < nwarps; ++w) total += wsum[w];
    const int p = total - m;
    for (int i = tid; i < k; i += nthr) {
      double v;
      if (i >= p && i < p + m) {
        v = comp;
      } else {
        v = Wa[min(i < p ? i + m : i, k - 1)];
      }
      Wb[i] = v;
    }
    if (tid == 0) out[j] = start;
    if (!drain) t_prev = start;
    __syncthreads();
    double* tmp = Wa; Wa = Wb; Wb = tmp;
  }
}

// ---------------------------------------------------------------------------
// ModifiedBS-pi (Definition 2): one warp per replication.  Shared memory
// holds the completion matrix [C*s_max] (slots beyond slots[c] hold BIG:
// permanently busy) and the helper free-time vector W [h], double-buffered.
// Per job: busy = count(row > t), blocked = busy >= s_max, the row's argmin
// takes t + svc unless blocked; a blocked job runs the FCFS step on W.
// kDrain: J counts merged rows; a failure row with cls == C drains W, one
// with cls < C extends its row's argmin entry to max(entry, t_up).
// ---------------------------------------------------------------------------

template <bool kDrain>
__global__ void modbs_scan_kernel(const double* __restrict__ arrival,
                                  const int* __restrict__ cls,
                                  const int* __restrict__ need,
                                  const double* __restrict__ service,
                                  const double* __restrict__ t_up,
                                  const bool* __restrict__ is_fail,
                                  const int* __restrict__ slots,
                                  bool* __restrict__ blocked_out,
                                  double* __restrict__ starts, int J, int C,
                                  int s_max, int h) {
  extern __shared__ double smem[];
  double* comp = smem;
  double* Wa = comp + C * s_max;
  double* Wb = Wa + h;
  const int lane = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const int* cl = cls + off;
  const int* nd = need + off;
  const double* sv = service + off;

  for (int i = lane; i < C * s_max; i += 32)
    comp[i] = (i % s_max) >= slots[i / s_max] ? kBig : 0.0;
  for (int i = lane; i < h; i += 32) Wa[i] = 0.0;
  double t_prev = 0.0;
  __syncwarp();
  for (int j = 0; j < J; ++j) {
    const double t = a[j];
    // a failure row's class column is its target block, C = the helper
    const int c = clampi(cl[j], 0, kDrain ? C : C - 1);
    const int n = nd[j];
    const double svc = sv[j];
    double* row = comp + (kDrain ? min(c, C - 1) : c) * s_max;
    const bool blocked = warp_count_gt(row, s_max, t) >= s_max;
    double rmin;
    const int idx = warp_argmin(row, s_max, &rmin);
    double start;
    bool isf = false;
    __syncwarp();
    if constexpr (!kDrain) {
      if (!blocked) {
        if (lane == 0) row[idx] = __dadd_rn(t, svc);
        start = t;
      } else {
        const double nth = Wa[clampi(n - 1, 0, h - 1)];
        start = fmax(fmax(t, t_prev), nth);
        warp_roll_insert(Wa, Wb, h, n, __dadd_rn(start, svc));
        double* tmp = Wa; Wa = Wb; Wb = tmp;
        t_prev = start;
      }
    } else {
      isf = is_fail[off + j];
      const double tu = t_up[off + j];
      const bool helper_fail = isf && c == C;
      const bool class_fail = isf && !helper_fail;
      const double start_h = fmax(fmax(t, t_prev), Wa[clampi(n - 1, 0, h - 1)]);
      if (lane == 0 && (class_fail || !isf))
        row[idx] = class_fail ? fmax(rmin, tu) : (blocked ? rmin : __dadd_rn(t, svc));
      if (helper_fail) {
        warp_roll_insert(Wa, Wb, h, 1, fmax(Wa[0], tu));
        double* tmp = Wa; Wa = Wb; Wb = tmp;
      } else if (!isf && blocked) {
        warp_roll_insert(Wa, Wb, h, n, __dadd_rn(start_h, svc));
        double* tmp = Wa; Wa = Wb; Wb = tmp;
        t_prev = start_h;
      }
      start = blocked ? start_h : t;
    }
    if (lane == 0) {
      blocked_out[off + j] = blocked && !isf;
      starts[off + j] = start;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// BS-pi (Definition 1): one warp per replication, the 2J-event scan of
// sim_jax._bs_make_step statement for statement.
//
// What bounds it on this card.  A step is ~100 compares, but each step
// depends on the last, and one warp has nothing to overlap with it, so a
// step costs the latency of its dependent chain of instructions: ~35
// cycles a shared load, shuffle or dependent float64 maximum, ~48 a
// redux.sync, ~74 an integer division (bench/bs_bench.py --phases splits
// a step; PERF.md section 6).  Global loads were not the bottleneck: taking
// them off the chain alone gained 1 %.  The design keeps the chain short
// by doing, at each step, only the work the event in hand needs:
//   * one branch per event type after the decision, so a step runs only
//     its own event's loads, writes and reductions;
//   * the earliest completion (Tc, its index and class) and the helper
//     queue's head (its job, record and start Th) are kept in registers;
//     an insert updates Tc with one compare, and the full argmin (redux.sync
//     over order-preserving keys; one when a single lane holds the high
//     word, three otherwise) runs only after a completion or a drain that
//     may raise it; after a pop the head is found again over the classes
//     (one pass and two redux.sync) only when the popped class held it;
//   * a class's free A slots are a bitmask while s_max <= 32: the first
//     free slot is the row's first maximum (free slots hold BIG, busy ones
//     less), so one find-first-set replaces the argmax.  A completion of
//     BIG or more would break that, so one sets a flag that sends every
//     later step to the exact argmax;
//   * the arrival stream (and, kDrain, the failure records) is read ahead
//     in windows of 32 entries, one per lane in registers, the next window
//     in flight; the record at the cursor is taken with shuffles after the
//     cursor moves;
//   * a job's record (arrival, service, need) travels with it in its ring
//     entry (ring_t / ring_i) and its class's head slot; each ring's last
//     D writes are also kept in a shared-memory cache (rc_t / rc_i, tagged
//     with the entry's index), which a pop reads unless the entry has left
//     it or the ring wrapped onto it (then the ring in global memory, the
//     last write to the slot, as the reference reads it); ring positions
//     are kept modulo q_cap, with no division;
//   * the event records are gathered one per lane and stored 32 at a time.
// Shared memory holds the completion matrix comp [C*s_max], the helper
// free-time vector W [h] (double-buffered), the head records ha, hs [C]
// (arrival, service) and hn [C] (need clamped to [1, h]), the ring cache
// [C*D], the counters st [5C] (free slots, ring heads and tails, both also
// modulo q_cap), the head job ids heads [C] and the free-slot masks fmask
// [C].  Every lane computes the step's scalars from the same state; lane
// 0 writes, and __syncwarp orders the writes before the next reads.
// kDrain (sim_jax._bs_fail_make_step): the [F] failure record (time,
// target, t_up) at the cursor fi comes from its own window, and the scan
// runs `length` = 2J + F + F_A steps (2J without failures).
// ---------------------------------------------------------------------------

// Order-preserving key of a double (not NaN): keys compare as the values
// do, and -0.0 keys as +0.0, so ties between them stay ties.
__device__ __forceinline__ unsigned long long bs_key(double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(
      v == 0.0 ? 0.0 : v);
  return (b >> 63) ? ~b : (b | (1ull << 63));
}

// The first index, over the warp, of the key K each lane's (key, idx)
// pair is compared against: K = the smallest key (kMax = false) or the
// largest; each lane passes the first index of its own best key.
template <bool kMax>
__device__ __forceinline__ int bs_first(unsigned long long key, int idx) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned khi = kMax ? __reduce_max_sync(kFull, hi)
                            : __reduce_min_sync(kFull, hi);
  const unsigned at = __ballot_sync(kFull, hi == khi);
  if (__popc(at) == 1)   // one lane holds the high word: its key wins
    return __shfl_sync(kFull, idx, __ffs(at) - 1);
  const unsigned klo = kMax ? __reduce_max_sync(kFull, hi == khi ? lo : 0u)
                            : __reduce_min_sync(kFull,
                                                hi == khi ? lo : 0xffffffffu);
  const bool mine = hi == khi && lo == klo;
  return (int)__reduce_min_sync(kFull, mine ? (unsigned)idx : 0x7fffffffu);
}

// The smallest head job id over classes [0, C) and the first class that
// holds it, with class c's head taken as `id` (a pop in hand); ids are
// non-negative, an empty ring's head is J.
__device__ __forceinline__ int bs_min_head(const int* heads, int C, int c,
                                           int id, int* gh) {
  const int lane = threadIdx.x & 31;
  int best = 0x7fffffff, bc = 0x7fffffff;
  for (int k = lane; k < C; k += 32) {
    const int v = k == c ? id : heads[k];
    if (v < best) { best = v; bc = k; }
  }
  *gh = (int)__reduce_min_sync(kFull, (unsigned)best);
  return (int)__reduce_min_sync(kFull,
                                best == *gh ? (unsigned)bc : 0x7fffffffu);
}

// Each lane's first index of its best entry of x[0..m) (entries lane,
// lane + 32, ...), loaded four at a time so the loads overlap.
template <bool kMax>
__device__ __forceinline__ void bs_lane_best(const double* x, int m,
                                             double* best, int* bi) {
  const int lane = threadIdx.x & 31;
  *best = kMax ? -INFINITY : INFINITY;
  *bi = lane < m ? lane : 0x7fffffff;
  for (int base = 0; base < m; base += 128) {
    double v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + 32 * k + lane;
      v[k] = i < m ? x[i] : *best;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // ascending index: keeps the first
      if (kMax ? v[k] > *best : v[k] < *best) {
        *best = v[k];
        *bi = base + 32 * k + lane;
      }
    }
  }
}

// First index of the minimum of x[0..m) over the warp, and the minimum.
__device__ __forceinline__ int bs_argmin(const double* x, int m, double* vmin) {
  double best;
  int bi;
  bs_lane_best<false>(x, m, &best, &bi);
  const int i = bs_first<false>(bs_key(best), bi);
  *vmin = x[i];
  return i;
}

// First index of the maximum of x[0..m) over the warp.
__device__ __forceinline__ int bs_argmax(const double* x, int m) {
  double best;
  int bi;
  bs_lane_best<true>(x, m, &best, &bi);
  return bs_first<true>(bs_key(best), bi);
}

// warp_roll_insert with the count as one redux.sync; no closing
// __syncwarp (the step's own orders dst before the next step reads it).
__device__ __forceinline__ void bs_roll_insert(const double* src, double* dst,
                                               int h, int n, double comp) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
#pragma unroll 4
  for (int i = lane; i < h; i += 32) cnt += src[i] <= comp ? 1 : 0;
  const int p = (int)__reduce_add_sync(kFull, (unsigned)cnt) - n;
#pragma unroll 4
  for (int i = lane; i < h; i += 32) {
    double v;
    if (i >= p && i < p + n) {
      v = comp;
    } else {
      v = src[min(i < p ? i + n : i, h - 1)];
    }
    dst[i] = v;
  }
}

template <bool kDrain>
__global__ void __launch_bounds__(32)
    bs_scan_kernel(const double* __restrict__ arrival,
                   const int* __restrict__ cls, const int* __restrict__ need,
                   const double* __restrict__ service,
                   const double* __restrict__ fail_t,
                   const int* __restrict__ fail_tgt,
                   const double* __restrict__ fail_up,
                   const int* __restrict__ slots, int* __restrict__ tagged_out,
                   double* __restrict__ rec_t_out, bool* __restrict__ ovf_out,
                   double2* ring_t_all, int2* ring_i_all, int J, int F, int C,
                   int s_max, int h, int q_cap, int D, int length) {
  extern __shared__ double smem[];
  const int CS = C * s_max;
  double* comp = smem;
  double* Wa = comp + CS;
  double* Wb = Wa + h;
  double* ha = Wb + h;
  double* hs = ha + C;
  // the ring cache: the last D entries written to each class's ring
  double2* rc_t = reinterpret_cast<double2*>(
      smem + ((CS + 2 * h + 2 * C + 1) & ~1));
  int4* rc_i = reinterpret_cast<int4*>(rc_t + C * D);
  int* st = reinterpret_cast<int*>(rc_i + C * D);
  int* heads = st + 5 * C;
  int* hn = heads + C;
  unsigned* fmask = reinterpret_cast<unsigned*>(hn + C);
  const int lane = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const int* cl = cls + off;
  const int* nd = need + off;
  const double* sv = service + off;
  double2* ring_t = ring_t_all + (size_t)blockIdx.x * C * q_cap;
  int2* ring_i = ring_i_all + (size_t)blockIdx.x * C * q_cap;
  int* tagged = tagged_out + (size_t)blockIdx.x * length;
  double* rec_t = rec_t_out + (size_t)blockIdx.x * length;
  const size_t off_f = (size_t)blockIdx.x * F;
  // the class of flat index i < C*s_max: __umulhi(i, magic), exact since
  // C*s_max < 2^16 (shared memory could not hold more)
  const unsigned magic = s_max > 1 ? (unsigned)(0x100000000ull / s_max + 1)
                                   : 0u;
  auto class_of = [&](int i) {
    return s_max > 1 ? (int)__umulhi((unsigned)i, magic) : i;
  };

  for (int i = lane; i < CS; i += 32) comp[i] = kBig;
  for (int i = lane; i < h; i += 32) Wa[i] = 0.0;
  for (int i = lane; i < C; i += 32) {
    st[i] = slots[i];
    for (int r = 1; r < 5; ++r) st[r * C + i] = 0;
    heads[i] = J;
    ha[i] = 0.0;
    hs[i] = 0.0;
    hn[i] = 1;
    fmask[i] = slots[i] >= 32 ? 0xffffffffu : (1u << max(slots[i], 0)) - 1u;
  }
  for (int i = lane; i < C * D; i += 32) rc_i[i] = make_int4(0, 1, -1, 0);

  // arrival windows: lane l holds entry wb + l (cur) and wb + 32 + l (nxt)
  int wb = 0;
  double cur_a, cur_s, nxt_a, nxt_s;
  int cur_c, cur_n, nxt_c, nxt_n;
  {
    const int i0 = min(lane, J - 1), i1 = min(32 + lane, J - 1);
    cur_a = a[i0]; cur_s = sv[i0]; cur_c = cl[i0]; cur_n = nd[i0];
    nxt_a = a[i1]; nxt_s = sv[i1]; nxt_c = cl[i1]; nxt_n = nd[i1];
  }
  int ai = 0, fi = 0;
  // the record of the arrival at the cursor ai, and Ta
  int j_arr, c_arr, n_arr;
  double a_arr, s_arr, v_arr, Ta;
  auto take_arrival = [&]() {
    j_arr = min(ai, J - 1);
    if (j_arr - wb >= 32) {
      wb += 32;
      cur_a = nxt_a; cur_s = nxt_s; cur_c = nxt_c; cur_n = nxt_n;
      const int i1 = min(wb + 32 + lane, J - 1);
      nxt_a = a[i1]; nxt_s = sv[i1]; nxt_c = cl[i1]; nxt_n = nd[i1];
    }
    const int src = j_arr - wb;
    a_arr = __shfl_sync(kFull, cur_a, src);
    s_arr = __shfl_sync(kFull, cur_s, src);
    c_arr = clampi(__shfl_sync(kFull, cur_c, src), 0, C - 1);
    n_arr = clampi(__shfl_sync(kFull, cur_n, src), 1, h);
    v_arr = __dadd_rn(a_arr, s_arr);
    Ta = ai < J ? a_arr : INFINITY;
  };
  take_arrival();
  // failure windows (kDrain), the same way at the cursor fi
  int fb = 0;
  double fcur_t = 0.0, fcur_u = 0.0, fnxt_t = 0.0, fnxt_u = 0.0;
  int fcur_g = 0, fnxt_g = 0;
  double Tf = INFINITY, fu = 0.0;
  int fc = 0;
  auto take_failure = [&]() {
    const int fi_c = min(fi, F - 1);
    if (fi_c - fb >= 32) {
      fb += 32;
      fcur_t = fnxt_t; fcur_u = fnxt_u; fcur_g = fnxt_g;
      const int i1 = min(fb + 32 + lane, F - 1);
      fnxt_t = fail_t[off_f + i1]; fnxt_u = fail_up[off_f + i1];
      fnxt_g = fail_tgt[off_f + i1];
    }
    const int fsrc = fi_c - fb;
    const double ft = __shfl_sync(kFull, fcur_t, fsrc);
    Tf = fi < F ? ft : INFINITY;
    fc = clampi(__shfl_sync(kFull, fcur_g, fsrc), 0, C);
    fu = __shfl_sync(kFull, fcur_u, fsrc);
  };
  if constexpr (kDrain) {
    const int i0 = min(lane, F - 1), i1 = min(32 + lane, F - 1);
    fcur_t = fail_t[off_f + i0]; fcur_u = fail_up[off_f + i0];
    fcur_g = fail_tgt[off_f + i0];
    fnxt_t = fail_t[off_f + i1]; fnxt_u = fail_up[off_f + i1];
    fnxt_g = fail_tgt[off_f + i1];
    take_failure();
  }
  int* s_free = st;            // free A slots
  int* s_g0 = st + C;          // ring heads and tails
  int* s_g1 = st + 2 * C;
  int* s_hw = st + 3 * C;      // the same modulo q_cap
  int* s_tw = st + 4 * C;
  double t_prev = 0.0, t_hol = 0.0;
  // the earliest completion: comp[cm] = Tc, cm in class c_cm
  double Tc = kBig;
  int cm = 0, c_cm = 0;
  bool need_min = false;
  // the helper queue's head: job gh of class gc, its record and start Th
  int gh = J, gc = 0, hn_g = 1;
  double ha_g = 0.0, hs_g = 0.0, Th = INFINITY;
  // a pop of class c's ring to its entry g0n of tail g1 (g0n modulo q_cap:
  // hwn): the new head comes from the ring cache, or from the ring when
  // the cache no longer holds it or the ring wrapped onto it (g1 - g0n >
  // q_cap: the entry is the last write to its slot); lane 0 moves the
  // counters and the head, every lane the helper queue's head
  auto pop = [&](int c, int g0n, int g1, int hwn) {
    int id = J, n = 1;
    double pa = 0.0, ps = 0.0;
    if (g0n < g1) {
      const int line = c * D + (g0n & (D - 1));
      const int4 ci = rc_i[line];
      if (ci.z == g0n && g1 - g0n <= q_cap) {
        const double2 t2 = rc_t[line];
        id = ci.x; n = ci.y; pa = t2.x; ps = t2.y;
      } else {
        const size_t slot = (size_t)c * q_cap + hwn;
        const double2 t2 = ring_t[slot];
        const int2 i2 = ring_i[slot];
        id = i2.x; n = i2.y; pa = t2.x; ps = t2.y;
      }
    }
    int g = gh, k = gc;
    if (c == gc) k = bs_min_head(heads, C, c, id, &g);
    else if (id < gh) { g = id; k = c; }
    __syncwarp();   // every lane has read the heads
    if (lane == 0) {
      s_g0[c] = g0n;
      s_hw[c] = hwn;
      heads[c] = id;
      if (g0n < g1) {
        ha[c] = pa;
        hs[c] = ps;
        hn[c] = n;
      }
    }
    if (k == c) {
      ha_g = pa; hs_g = ps; hn_g = n;
    } else if (k != gc) {
      ha_g = ha[k]; hs_g = hs[k]; hn_g = hn[k];
    }
    gh = g;
    gc = k;
  };
  // Th = the head's FCFS start on H (after W, t_prev, t_hol or the head
  // changed)
  auto start_on_h = [&]() {
    Th = gh < J ? fmax(fmax(ha_g, t_hol), fmax(t_prev, Wa[hn_g - 1]))
                : INFINITY;
  };
  // free slots by the exact argmax: s_max > 32 (no 32-bit mask), or a
  // busy slot at BIG or more
  bool huge = s_max > 32;
  int my_tag = -1;                // the records, one step per lane
  double my_rec = 0.0;
  bool ovf = false;
  __syncwarp();

  for (int e = 0; e < length; ++e) {
    if (need_min) {   // a completion or a drain may have raised Tc
      cm = bs_argmin(comp, CS, &Tc);
      c_cm = class_of(cm);
      need_min = false;
    }
    // the event: a breakdown (drain mode; it wins ties), a helper commit,
    // an A completion or an arrival
    bool is_fail = false;
    if constexpr (kDrain)
      is_fail = (Tf <= Ta) && (Tf <= Tc) && (Tf <= Th) && (Tf < INFINITY);
    const bool is_commit = !is_fail && (Th <= Tc) && (Th <= Ta);
    bool is_comp = !is_fail && !is_commit && (Tc < Ta);
    if constexpr (kDrain) is_comp = is_comp && Tc < 0.5 * kBig;
    bool is_arr = !is_fail && !is_commit && !is_comp;
    if constexpr (kDrain) is_arr = is_arr && ai < J;
    int tag = -1;
    double rec = Tc;

    // -- arrival (rule 1): a free A_i slot starts the job, else it enqueues
    if (is_arr) {
      const int free_c = s_free[c_arr];
      const unsigned fm = fmask[c_arr];
      if (free_c > 0) {
        const int pos = huge ? bs_argmax(comp + c_arr * s_max, s_max)
                             : __ffs(fm) - 1;
        const int i = c_arr * s_max + pos;
        __syncwarp();   // every lane has read the row
        if (lane == 0) {
          comp[i] = v_arr;
          s_free[c_arr] = free_c - 1;
          fmask[c_arr] = fm & ~(1u << (pos & 31));
        }
        // a busy slot at BIG or more would read as free: the exact argmax
        huge = huge || !(v_arr < kBig);
        if (v_arr < Tc || (v_arr == Tc && i < cm)) {
          Tc = v_arr;
          cm = i;
          c_cm = c_arr;
        }
        tag = j_arr;
      } else {
        const int head_c = s_g0[c_arr], tail_c = s_g1[c_arr];
        const int tw_c = s_tw[c_arr];
        ovf = ovf || (tail_c + 1 - head_c > q_cap);
        __syncwarp();   // every lane has read the counters
        if (lane == 0) {   // the ring write happens even on overflow
          const size_t slot = (size_t)c_arr * q_cap + tw_c;
          ring_t[slot] = make_double2(a_arr, s_arr);
          ring_i[slot] = make_int2(j_arr, n_arr);
          const int line = c_arr * D + (tail_c & (D - 1));
          rc_t[line] = make_double2(a_arr, s_arr);
          rc_i[line] = make_int4(j_arr, n_arr, tail_c, 0);
          s_g1[c_arr] = tail_c + 1;
          s_tw[c_arr] = tw_c + 1 == q_cap ? 0 : tw_c + 1;
          if (head_c == tail_c) {
            heads[c_arr] = j_arr;
            ha[c_arr] = a_arr;
            hs[c_arr] = s_arr;
            hn[c_arr] = n_arr;
          }
        }
        if (head_c == tail_c && gh == J) {
          // the first queued job is the helper's head (a later one never
          // is: its id is larger than every queued job's)
          gh = j_arr;
          gc = c_arr;
          ha_g = a_arr;
          hs_g = s_arr;
          hn_g = n_arr;
          start_on_h();
        }
        tag = j_arr + J;
      }
      rec = Ta;
      ai += 1;
      take_arrival();

    // -- A completion: rule 3 pulls the class head into the freed slot
    } else if (is_comp) {
      const int pull = heads[c_cm];
      const double s_pull = hs[c_cm];
      const int g0 = s_g0[c_cm], g1 = s_g1[c_cm], hw = s_hw[c_cm];
      const int free_c = s_free[c_cm];
      const unsigned fm = fmask[c_cm];
      need_min = true;
      if (pull < J) {
        const double v = __dadd_rn(Tc, s_pull);
        if (pull == gh) t_hol = fmax(t_hol, Tc);
        pop(c_cm, g0 + 1, g1, hw + 1 == q_cap ? 0 : hw + 1);
        if (lane == 0) comp[cm] = v;   // after pop's __syncwarp
        huge = huge || !(v < kBig);
        start_on_h();
        tag = pull;
      } else {
        __syncwarp();
        if (lane == 0) {
          comp[cm] = kBig;
          s_free[c_cm] = free_c + 1;
          fmask[c_cm] = fm | 1u << ((cm - c_cm * s_max) & 31);
        }
      }

    // -- helper commit: the global head starts on H at Th (pi = FCFS)
    } else if (is_commit) {
      const int g0n = s_g0[gc] + 1, g1 = s_g1[gc];
      const int hwn = s_hw[gc] + 1 == q_cap ? 0 : s_hw[gc] + 1;
      tag = gh + 2 * J;   // the commit's head exists: gh < J
      rec = Th;
      bs_roll_insert(Wa, Wb, h, hn_g, Th + hs_g);
      double* tmp = Wa; Wa = Wb; Wb = tmp;
      t_prev = Th;
      pop(gc, g0n, g1, hwn);   // its __syncwarp orders W before start_on_h
      start_on_h();

    // -- drain mode: the breakdown claims the earliest-free unit of its
    //    target block (fc == C: the helper); past a lane's events, no-ops
    } else if constexpr (kDrain) {
      if (is_fail) {
        if (fc == C) {
          bs_roll_insert(Wa, Wb, h, 1, fmax(Wa[0], fu));
          __syncwarp();
          double* tmp = Wa; Wa = Wb; Wb = tmp;
          start_on_h();
        } else if (s_free[fc] > 0) {   // a free slot until t_up
          const int pos = huge ? bs_argmax(comp + fc * s_max, s_max)
                               : __ffs(fmask[fc]) - 1;
          const int i = fc * s_max + pos;
          __syncwarp();
          if (lane == 0) {
            comp[i] = fu;
            s_free[fc] -= 1;
            fmask[fc] &= ~(1u << (pos & 31));
          }
          huge = huge || !(fu < kBig);
          if (fu < Tc || (fu == Tc && i < cm)) {
            Tc = fu;
            cm = i;
            c_cm = fc;
          }
        } else {   // all busy: the earliest completion waits for t_up
          double vmin;
          const int i = fc * s_max + bs_argmin(comp + fc * s_max, s_max,
                                               &vmin);
          const double v = fmax(vmin, fu);
          __syncwarp();
          if (lane == 0) comp[i] = v;
          huge = huge || !(v < kBig);
          need_min = i == cm;
        }
        fi += 1;
        take_failure();
      }
    }

    // -- record: lane e % 32 keeps step e's, stored 32 steps at a time
    if (lane == (e & 31)) {
      my_tag = tag;
      my_rec = rec;
    }
    if ((e & 31) == 31 || e == length - 1) {
      const int i = (e & ~31) + lane;
      if (i <= e) {
        tagged[i] = my_tag;
        rec_t[i] = my_rec;
      }
    }
    __syncwarp();
  }
  if (lane == 0) ovf_out[blockIdx.x] = ovf;
}

// Opt in to more than 48 KiB of dynamic shared memory where needed; fail
// with cudaErrorInvalidValue when the block's state does not fit.
template <typename K>
cudaError_t prepare_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Shared-memory bytes and block sizes of the kernels.
size_t msj_fcfs_smem(int k, int threads) {
  return 2 * (size_t)k * sizeof(double) + (threads / 32) * sizeof(int);
}
size_t msj_modbs_smem(int C, int s_max, int h) {
  return ((size_t)C * s_max + 2 * (size_t)h) * sizeof(double);
}
// The BS ring cache's lines per class: a power of two, at most 64, whose
// 32-byte lines take at most 16 KiB.
int msj_bs_cache_lines(int C) {
  int D = 64;
  while (D > 1 && (size_t)C * D * 32 > 16 * 1024) D >>= 1;
  return D;
}

size_t msj_bs_smem(int C, int s_max, int h) {
  const size_t nd = ((size_t)C * s_max + 2 * (size_t)h + 2 * (size_t)C + 1) & ~(size_t)1;
  return nd * sizeof(double) + (size_t)C * msj_bs_cache_lines(C) * 32 +
         8 * (size_t)C * sizeof(int);
}

// The BS rings' records in the caller's scratch of R*C*q_cap*24 bytes:
// (arrival, service) pairs, then (job id, need) pairs.
void bs_rings(void* scratch, int R, int C, int q_cap, double2** t, int2** i) {
  *t = static_cast<double2*>(scratch);
  *i = reinterpret_cast<int2*>(*t + (size_t)R * C * q_cap);
}

int msj_fcfs_threads(int k) {
  const int t = ((k + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

}  // namespace

extern "C" {

const char* msj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int msj_fcfs_scan(const double* arrival, const int* need, const double* service,
                  double* starts, int R, int J, int k, void* stream) {
  const int threads = msj_fcfs_threads(k);
  const size_t smem = msj_fcfs_smem(k, threads);
  cudaError_t err = prepare_smem(fcfs_scan_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  fcfs_scan_kernel<false><<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, need, service, nullptr, nullptr, starts, J, k);
  return (int)cudaGetLastError();
}

int msj_fcfs_fail_scan(const double* t, const int* need, const double* svc,
                       const double* t_up, const bool* is_fail, double* starts,
                       int R, int L, int k, void* stream) {
  const int threads = msj_fcfs_threads(k);
  const size_t smem = msj_fcfs_smem(k, threads);
  cudaError_t err = prepare_smem(fcfs_scan_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  fcfs_scan_kernel<true><<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, need, svc, t_up, is_fail, starts, L, k);
  return (int)cudaGetLastError();
}

int msj_modbs_scan(const double* arrival, const int* cls, const int* need,
                   const double* service, const int* slots, bool* blocked,
                   double* starts, int R, int J, int C, int s_max, int h,
                   void* stream) {
  const size_t smem = msj_modbs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(modbs_scan_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  modbs_scan_kernel<false><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, nullptr, nullptr, slots, blocked, starts, J, C,
      s_max, h);
  return (int)cudaGetLastError();
}

int msj_modbs_fail_scan(const double* t, const int* cls, const int* need,
                        const double* svc, const double* t_up, const bool* is_fail,
                        const int* slots, bool* blocked, double* starts, int R,
                        int L, int C, int s_max, int h, void* stream) {
  const size_t smem = msj_modbs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(modbs_scan_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  modbs_scan_kernel<true><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      t, cls, need, svc, t_up, is_fail, slots, blocked, starts, L, C, s_max, h);
  return (int)cudaGetLastError();
}

int msj_bs_scan(const double* arrival, const int* cls, const int* need,
                const double* service, const int* slots, int* tagged,
                double* rec_t, bool* ovf, void* ring_scratch, int R, int J,
                int C, int s_max, int h, int q_cap, void* stream) {
  const size_t smem = msj_bs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(bs_scan_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  double2* ring_t;
  int2* ring_i;
  bs_rings(ring_scratch, R, C, q_cap, &ring_t, &ring_i);
  bs_scan_kernel<false><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, nullptr, nullptr, nullptr, slots, tagged,
      rec_t, ovf, ring_t, ring_i, J, 0, C, s_max, h, q_cap,
      msj_bs_cache_lines(C), 2 * J);
  return (int)cudaGetLastError();
}

int msj_bs_fail_scan(const double* arrival, const int* cls, const int* need,
                     const double* service, const double* fail_t,
                     const int* fail_tgt, const double* fail_up, const int* slots,
                     int* tagged, double* rec_t, bool* ovf, void* ring_scratch,
                     int R, int J, int F, int C, int s_max, int h, int q_cap,
                     int length, void* stream) {
  const size_t smem = msj_bs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(bs_scan_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  double2* ring_t;
  int2* ring_i;
  bs_rings(ring_scratch, R, C, q_cap, &ring_t, &ring_i);
  bs_scan_kernel<true><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, fail_t, fail_tgt, fail_up, slots, tagged,
      rec_t, ovf, ring_t, ring_i, J, F, C, s_max, h, q_cap,
      msj_bs_cache_lines(C), length);
  return (int)cudaGetLastError();
}

}  // extern "C"
