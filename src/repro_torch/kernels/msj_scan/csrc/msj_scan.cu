// Multiserver-job event scans for Hopper (sm_90a): FCFS, ModifiedBS-pi and
// BS-pi (Definition 1), one warp per replication, each with and without
// drain-mode server failures.
//
// Replaces the Pallas kernels of the JAX reference package
// (repro/kernels/msj_scan/kernel.py):
//   fcfs_scan        <- fcfs_scan_fwd        (_fcfs_kernel)
//   fcfs_fail_scan   <- fcfs_fail_scan_fwd   (_fcfs_fail_kernel)
//   modbs_scan       <- modbs_scan_fwd       (_modbs_kernel)
//   modbs_fail_scan  <- modbs_fail_scan_fwd  (_modbs_fail_kernel)
//   bs_scan          <- bs_scan_fwd          (_bs_kernel)
//   bs_fail_scan     <- bs_fail_scan_fwd     (_bs_fail_kernel)
// It also holds loss_scan, the M/GI/s/s loss queue of sim_jax._loss_core,
// which the reference runs as a lax.scan with no Pallas kernel (see its
// note below), and computes, bit for bit, the steps of repro/core/sim_jax.py
// (_fcfs_sorted_step, _fcfs_fail_step, _modbs_step, _modbs_fail_step,
// _bs_make_step, _bs_fail_make_step) and of their plain PyTorch versions
// in repro_torch/core/sim_torch.py.  Each kernel body is a template on
// kDrain and kStream: the clean scan is the <false, false> instantiation,
// whose code the drain and stream branches (if constexpr) leave untouched.
//
// Carried (kStream) entries run one chunk of a stream (sim_jax's
// _fcfs_stream_core, _modbs_stream_core, _bs_stream_core; no Pallas
// kernel): the state is loaded from a carry at entry and written back at
// exit, in the port's canonical form.  FCFS and the ModBS helper carry W
// clamped to >= t_prev (rs_load builds the run-length groups from it,
// rs_store writes it back), ModBS carries each class row sorted, as the
// kernel keeps it; BS-pi carries the reference's chunk carry (ai, st,
// comp, ring of job ids, heads, W, t_prev, t_hol, ovf, ne): the queued
// jobs' records are written into the record ring at entry, the ring cache
// starts cold, the free-slot masks are rebuilt from comp, and at exit the
// ring holds each class's queued ids and 0 elsewhere.  A BS chunk step
// defers a commit past the horizon (Th > horizon) and a completion at or
// past it, and counts the events it processes; the loop runs `length`
// steps.  The step chains of the other instantiations are unchanged.
//
// What bounds these kernels.  Each replication is a chain of J (BS: 2J)
// dependent event steps, and the bytes the work must move (the [R, J]
// inputs and outputs once) take well under a millisecond at 3.35 TB/s, so
// time per launch is (events) x (latency of one step); the replications
// run side by side, one warp each.  One warp has nothing to overlap with
// its own chain, so a step costs the latency of its dependent
// instructions: ~35 cycles a shared load, shuffle or dependent float64
// maximum, ~48 a redux.sync, ~74 an integer modulo (bench/bs_bench.py and
// bench/fm_bench.py --phases; PERF.md section 6).  The design keeps every
// piece of per-step state on chip (shared memory and registers; only the
// BS helper-wait rings live in a global scratch buffer), reads the trace
// ahead in register windows, and does at each step only the work its
// outputs depend on: FCFS and the ModBS helper keep the run-length
// free-time state below (a step touches the groups its answer lies in,
// not the k entries), ModBS keeps each class row's minimum (no count and
// no argmin of the row unless it changed), BS-pi branches by event type
// (see its own note).  No kernel has a block-wide barrier.
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
//     arrivals ai < j_live, because trailing steps past a lane's events are
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
// The run-length free-time state of FCFS on m servers (the FCFS kernel's
// k servers, the ModBS helper's h), kept by one warp.
//
// The plain step keeps the sorted free-time vector W [m] and t_prev, the
// last start; a job of need n starts at max(t, t_prev, W[n-1]), the n
// smallest entries retire and n copies of its completion comp >= start
// are inserted.  The only output is the start.  Why a coarser state is
// exact:
//   * every start is >= t_prev, so an entry W[i] <= t_prev changes no
//     start: max(t, t_prev, W[n-1]) is max(t, t_prev) whatever its value;
//   * every arrival's comp >= start >= t_prev, so an entry <= t_prev
//     counts as <= comp whatever its value (its rank in the roll);
//   * a drain's comp is max(W[0], t_up): with W[0] <= t_prev it is t_up
//     when t_up > t_prev and is <= t_prev otherwise, again whatever W[0]
//     is; a drain never moves t_prev.  Pad rows (t = +inf, t_up = 0) stay
//     the identity: max(W[0], 0) = W[0].
// So the state is F, the number of entries <= t_prev, and the entries
// above t_prev as groups of equal value, each kept with its count, the
// entries at or below its value (stored as count + base, modulo 2^32, so
// a retire of n is base += n).  Jobs of need n insert n equal copies, so
// the groups are few (tens at the Fig. 1 and Fig. 3 loads, at any k),
// and about one folds a step.
//
// The groups are not kept in order.  Each has a slot (chunk t, lane) that
// only its lane reads or writes: the first four chunks in registers, more
// (up to m groups: need-1 jobs with distinct completions) spilled to the
// lane's column of shared memory.  Order is not needed, because a count
// grows with the value:
//   * W[r], r >= F, is the value of the group with the least count above
//     r: one redux.sync (min) over the lanes' candidates, a ballot and a
//     shuffle;
//   * the fold frees the slots of the groups <= the new start, and F is
//     the largest count among them (one redux.sync, max);
//   * comp goes into F (comp <= start), into its own group if one holds
//     comp (a ballot), or into the first free slot as a new group whose
//     count is the largest count below comp (one redux.sync) plus n;
//     every group above comp counts n more: a predicated add in its lane.
// A step is thus a fixed handful of warp-wide operations and register
// selects: no shift and no sort, and up to 128 groups no shared memory
// (no lane reads another's slot, so no __syncwarp either).  Chunks 2 and 3
// are visited only while they hold a group.
// ---------------------------------------------------------------------------

// register chunks of the state: group slots (chunk t, lane) for t < kRegChunks;
// chunks from kNarrow on are visited only while they hold a group
constexpr int kRegChunks = 4, kNarrow = 2;
constexpr int kNone = -2147483647 - 1;   // no count

// Slots past the register chunks a state of m servers can need: a new
// group takes the first free slot, so the highest slot in use stays below
// the most groups there can be, m.
__host__ __device__ __forceinline__ int msj_spill_slots(int m) {
  const int chunks = (m + 31) / 32 - kRegChunks;
  return chunks > 0 ? 32 * chunks : 0;
}

struct RunState {
  double* sv;      // slots past the register chunks, lane-major chunks of 32
  unsigned* sc;    // in shared memory: chunk kRegChunks + u at [32 u + lane]
  int nsh;         // shared chunks in use
  int cap;         // shared chunks there is room for
  int F;           // entries <= t_prev
  unsigned base;
  double t_prev;
  bool wide;       // a register chunk from kNarrow on holds a group
  double v[kRegChunks];    // this lane's slot in each register chunk: a
  unsigned c[kRegChunks];  // group's value (+inf: free) and count word
};

// m servers, of which the first `live` (1 <= live <= m) are live: a grid
// lane stacked beside cells of more servers has dead ones, BIG entries at
// the tail of the plain step's W (never free), which are here one group at
// BIG holding all m entries at or below it.  No finite completion undercuts
// it, so it never folds and, for a need within the live servers, is never
// W[n-1]; with live == m there is none.
__device__ __forceinline__ void rs_init(RunState& s, double* sv, unsigned* sc,
                                        int m, int live) {
  s.sv = sv; s.sc = sc; s.nsh = 0;
  s.cap = msj_spill_slots(m) / 32;
  s.F = live; s.base = 0u;   // W = 0 <= t_prev = 0
  s.t_prev = 0.0;
  s.wide = false;
#pragma unroll
  for (int t = 0; t < kRegChunks; ++t) {
    s.v[t] = INFINITY;
    s.c[t] = 0u;
  }
  if (live < m && (threadIdx.x & 31) == 0) {
    s.v[0] = kBig;
    s.c[0] = (unsigned)m;
  }
}

// The passes of rs_nth and rs_place over the shared chunks (more than
// 32 kRegChunks groups: rare; their loops stay rolled).
__device__ __forceinline__ unsigned rs_spill_least(const RunState& s, int r) {
  const int lane = threadIdx.x & 31;
  unsigned best = 0xffffffffu;
#pragma unroll 1
  for (int u = 0; u < s.nsh; ++u) {
    const double v = s.sv[32 * u + lane];
    const unsigned e = s.sc[32 * u + lane] - s.base;
    if (v < INFINITY && (int)e > r && e < best) best = e;
  }
  return best;
}

__device__ __forceinline__ double rs_spill_value(const RunState& s,
                                                 unsigned e0) {
  const int lane = threadIdx.x & 31;
  double x = INFINITY;
#pragma unroll 1
  for (int u = 0; u < s.nsh; ++u) {
    const double v = s.sv[32 * u + lane];
    if (v < INFINITY && s.sc[32 * u + lane] - s.base == e0) x = v;
  }
  return x;
}

__device__ __forceinline__ void rs_spill_place(RunState& s, double lim,
                                            double comp, unsigned add,
                                            int* m1, int* m2, bool* eq) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int u = 0; u < s.nsh; ++u) {
    const double v = s.sv[32 * u + lane];
    const unsigned c = s.sc[32 * u + lane];
    const int e = (int)(c - s.base);
    if (v <= lim) {
      *m1 = max(*m1, e);
      s.sv[32 * u + lane] = INFINITY;
    }
    if (v < comp) *m2 = max(*m2, e);
    *eq = *eq || v == comp;
    if (v >= comp) s.sc[32 * u + lane] = c + add;
  }
}

// A new group in the first free shared slot (a new chunk past the ones in
// use), then the chunks left empty at the top given back.
__device__ __forceinline__ void rs_spill_put(RunState& s, bool put,
                                             double comp, unsigned cn) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int u = 0; put && u < s.cap; ++u) {
    if (u == s.nsh) {
      s.sv[32 * u + lane] = INFINITY;
      s.nsh = u + 1;
    }
    const unsigned b = __ballot_sync(kFull,
                                     !(s.sv[32 * u + lane] < INFINITY));
    if (b) {
      if (lane == __ffs(b) - 1) {
        s.sv[32 * u + lane] = comp;
        s.sc[32 * u + lane] = cn;
      }
      put = false;
    }
  }
  while (s.nsh > 0 &&
         !__ballot_sync(kFull, s.sv[32 * (s.nsh - 1) + lane] < INFINITY))
    --s.nsh;
}

// W[r] when it lies above t_prev (the group whose count of entries at or
// below it is the least above r); else t_prev, which stands for it in
// every max and compare a step makes.  *e0: that count (0 with t_prev).
__device__ __forceinline__ double rs_nth(const RunState& s, int r, int* e0) {
  *e0 = 0;
  if (r < s.F) return s.t_prev;
  unsigned best = s.nsh > 0 ? rs_spill_least(s, r) : 0xffffffffu;
#pragma unroll
  for (int t = 0; t < kRegChunks; ++t) {
    if (t >= kNarrow && !s.wide) break;
    const unsigned e = s.c[t] - s.base;
    best = s.v[t] < INFINITY && (int)e > r && e < best ? e : best;
  }
  const unsigned mn = __reduce_min_sync(kFull, best);
  double x = s.nsh > 0 ? rs_spill_value(s, mn) : INFINITY;
#pragma unroll
  for (int t = 0; t < kRegChunks; ++t) {
    if (t >= kNarrow && !s.wide) break;
    x = s.v[t] < INFINITY && s.c[t] - s.base == mn ? s.v[t] : x;
  }
  const unsigned b = __ballot_sync(kFull, x < INFINITY);
  const double w = __shfl_sync(kFull, x, (__ffs(b) - 1) & 31);
  *e0 = (int)mn;
  return b ? w : s.t_prev;
}

// After the retire (base already advanced): fold the groups <= lim into F
// (F_ret: F when none folds; their slots are freed), then insert n copies
// of comp: into F when comp <= lim, else into comp's group or a new one in
// the first free slot.  lim and comp are finite, so a free slot (+inf)
// neither folds nor counts as below or at comp; it does take the count
// increment of the groups above comp, which nothing reads.
__device__ __forceinline__ void rs_place(RunState& s, double lim, double comp,
                                         int n, int F_ret) {
  const int lane = threadIdx.x & 31;
  const unsigned base = s.base;
  const bool grow = comp > lim;
  const unsigned add = grow ? (unsigned)n : 0u;
  int m1 = kNone, m2 = kNone;   // the largest counts folded, below comp
  bool eq = false;
  if (s.nsh > 0) rs_spill_place(s, lim, comp, add, &m1, &m2, &eq);
#pragma unroll
  for (int t = 0; t < kRegChunks; ++t) {
    if (t >= kNarrow && !s.wide) break;
    const double v = s.v[t];
    const int e = (int)(s.c[t] - base);
    m1 = v <= lim ? max(m1, e) : m1;
    m2 = v < comp ? max(m2, e) : m2;
    eq = eq || v == comp;
    s.c[t] += v >= comp ? add : 0u;   // n more entries at or below it
    s.v[t] = v <= lim ? INFINITY : v;
  }
  const int M1 = __reduce_max_sync(kFull, m1);
  const int M2 = __reduce_max_sync(kFull, m2);
  const bool make = grow && !__any_sync(kFull, eq);   // else comp's group
  int ft = -1, fl = 0;   // the first free register slot
  if (s.wide) {
#pragma unroll
    for (int t = kRegChunks - 1; t >= kNarrow; --t) {
      const unsigned b = __ballot_sync(kFull, !(s.v[t] < INFINITY));
      ft = b ? t : ft;
      fl = b ? __ffs(b) - 1 : fl;
    }
  } else {
    ft = kNarrow;   // the chunks from kNarrow on are free
  }
#pragma unroll
  for (int t = kNarrow - 1; t >= 0; --t) {
    const unsigned b = __ballot_sync(kFull, !(s.v[t] < INFINITY));
    ft = b ? t : ft;
    fl = b ? __ffs(b) - 1 : fl;
  }
  const int Fn = M1 != kNone ? max(M1, 0) : F_ret;
  const unsigned cn = base + (unsigned)((M2 != kNone ? max(M2, 0) : Fn) + n);
#pragma unroll
  for (int t = 0; t < kRegChunks; ++t) {
    const bool put = make && t == ft && lane == fl;
    s.v[t] = put ? comp : s.v[t];
    s.c[t] = put ? cn : s.c[t];
  }
  s.F = grow ? Fn : Fn + n;                  // comp in F: every group
  s.base = grow ? base : base - (unsigned)n;  // counts n more
  if (s.wide || (make && ft >= kNarrow)) {
    bool held = false;
#pragma unroll
    for (int t = kNarrow; t < kRegChunks; ++t)
      held = held || s.v[t] < INFINITY;
    s.wide = __any_sync(kFull, held);
  }
  if (s.nsh > 0 || (make && ft < 0))
    rs_spill_put(s, make && ft < 0, comp, cn);
}

// An arrival of need n (clamped to [1, m]) that starts at `start` and
// completes at comp: the n smallest entries retire, comp x n goes in.
__device__ __forceinline__ void rs_commit(RunState& s, double start,
                                          double comp, int n) {
  const int F_ret = s.F - n;   // read only when no group folds: n <= F
  s.base += (unsigned)n;
  rs_place(s, start, comp, n, F_ret);
  s.t_prev = start;
}

// A drain: W[0] := max(W[0], t_up), re-sorted.
__device__ __forceinline__ void rs_drain(RunState& s, double tu) {
  int e0;
  const double w0 = rs_nth(s, 0, &e0);   // t_prev when F > 0
  if (!(tu > w0)) return;   // max(W[0], t_up) = W[0]: nothing moves
  s.base += 1u;
  double lim = s.t_prev;    // nothing folds
  int F_ret = s.F - 1;
  if (s.F == 0) {
    F_ret = 0;
    if (e0 == 1) lim = w0;  // group 0 is empty now: it folds
  }
  rs_place(s, lim, tu, 1, F_ret);
}

// The state of a carried free-time vector W [m] (sorted, clamped to
// >= tp: an entry at or below the last start reaches no output) after
// rs_init(s, ..., m, m): F = the entries <= tp, then one group per run of
// equal values above tp, counted by the entries at or below its value,
// placed in slot order (group g in chunk g / 32, lane g % 32).  The groups
// are at most m, which is what the slots hold.
__device__ __forceinline__ void rs_load(RunState& s, const double* W, int m,
                                        double tp) {
  const int lane = threadIdx.x & 31;
  int F = 0, g = 0;
#pragma unroll 1
  for (int b = 0; b < m; b += 32) {
    const int i = b + lane;
    const double v = i < m ? W[i] : INFINITY;
    const double nx = i + 1 < m ? W[i + 1] : INFINITY;
    F += __popc(__ballot_sync(kFull, i < m && !(v > tp)));
    unsigned ends = __ballot_sync(kFull, i < m && v > tp && nx != v);
#pragma unroll 1
    while (ends) {
      const int src = __ffs(ends) - 1;
      ends &= ends - 1;
      const double gv = __shfl_sync(kFull, v, src);
      const unsigned gc = (unsigned)(b + src + 1);
      const int t = g >> 5;
      if (t >= kRegChunks) {
        double* sv = s.sv + 32 * (t - kRegChunks);
        if ((g & 31) == 0) sv[lane] = INFINITY;   // a new chunk: all free
        __syncwarp();
        if (lane == (g & 31)) {
          sv[lane] = gv;
          s.sc[32 * (t - kRegChunks) + lane] = gc;
        }
      } else if (lane == (g & 31)) {
#pragma unroll
        for (int u = 0; u < kRegChunks; ++u) {
          s.v[u] = u == t ? gv : s.v[u];
          s.c[u] = u == t ? gc : s.c[u];
        }
      }
      ++g;
    }
  }
  s.F = F;
  s.base = 0u;
  s.t_prev = tp;
  s.nsh = g > 32 * kRegChunks ? (g - 32 * kRegChunks + 31) / 32 : 0;
  s.wide = g > 32 * kNarrow;
  __syncwarp();
}

// W [m] of the state, clamped to >= t_prev: F copies of t_prev, then each
// group's value over the ranks below its count.  Each group writes its
// value at its top rank e - 1 and a suffix minimum from the top fills the
// ranks between (a group's value grows with its count).
__device__ __forceinline__ void rs_store(const RunState& s, double* W, int m) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < m; i += 32) W[i] = i < s.F ? s.t_prev : INFINITY;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kRegChunks; ++t)
    if (s.v[t] < INFINITY) W[(int)(s.c[t] - s.base) - 1] = s.v[t];
#pragma unroll 1
  for (int u = 0; u < s.nsh; ++u) {
    const double v = s.sv[32 * u + lane];
    if (v < INFINITY) W[(int)(s.sc[32 * u + lane] - s.base) - 1] = v;
  }
  __syncwarp();
  double above = INFINITY;
#pragma unroll 1
  for (int b = (m - 1) & ~31; b >= 0 && b + 32 > s.F; b -= 32) {
    const int i = b + lane;
    double x = i < m ? W[i] : INFINITY;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_down_sync(kFull, x, off);
      x = lane + off < 32 ? fmin(x, y) : x;
    }
    x = fmin(x, above);
    above = __shfl_sync(kFull, x, 0);
    if (i < m && i >= s.F) W[i] = x;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// FCFS: one warp per replication on the run-length state of k servers
// (shared memory: its spill past 128 groups), k_lane[b] of them live.
// The trace (and, kDrain, t_up / is_fail) is read ahead in windows of 32
// entries, one per lane, the next window in flight; the starts are
// gathered one per lane and stored 32 at a time.  kDrain: J counts merged
// rows; every row's start is max(t, t_prev, W[n-1]) on the state at the
// row, and a failure row then drains instead of inserting.  kStream: the
// state comes from the carry (carry_w [R][k], carry_t [R]) and goes back
// to it.
// ---------------------------------------------------------------------------

template <bool kDrain, bool kStream = false>
__global__ void __launch_bounds__(32)
    fcfs_scan_kernel(const double* __restrict__ arrival,
                     const int* __restrict__ need,
                     const double* __restrict__ service,
                     const double* __restrict__ t_up,
                     const bool* __restrict__ is_fail,
                     const int* __restrict__ k_lane,
                     double* __restrict__ starts, int J, int k,
                     double* __restrict__ carry_w = nullptr,
                     double* __restrict__ carry_t = nullptr) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const int* nd = need + off;
  const double* sv = service + off;
  double* out = starts + off;
  RunState s;
  const int spill = msj_spill_slots(k);
  if constexpr (kStream) {
    rs_init(s, smem, reinterpret_cast<unsigned*>(smem + spill), k, k);
    rs_load(s, carry_w + (size_t)blockIdx.x * k, k, carry_t[blockIdx.x]);
  } else {
    rs_init(s, smem, reinterpret_cast<unsigned*>(smem + spill), k,
            clampi(k_lane[blockIdx.x], 1, k));
  }

  // windows: lane l holds entry wb + l (cur) and wb + 32 + l (nxt)
  double cur_a, cur_s, nxt_a, nxt_s, cur_u = 0.0, nxt_u = 0.0;
  int cur_n, nxt_n;
  bool cur_f = false, nxt_f = false;
  {
    const int i0 = min(lane, J - 1), i1 = min(32 + lane, J - 1);
    cur_a = a[i0]; cur_s = sv[i0]; cur_n = nd[i0];
    nxt_a = a[i1]; nxt_s = sv[i1]; nxt_n = nd[i1];
    if constexpr (kDrain) {
      cur_u = t_up[off + i0]; cur_f = is_fail[off + i0];
      nxt_u = t_up[off + i1]; nxt_f = is_fail[off + i1];
    }
  }
  double my_start = 0.0;
  for (int j = 0; j < J; ++j) {
    const int src = j & 31;
    if (src == 0 && j > 0) {
      cur_a = nxt_a; cur_s = nxt_s; cur_n = nxt_n;
      const int i1 = min(j + 32 + lane, J - 1);
      nxt_a = a[i1]; nxt_s = sv[i1]; nxt_n = nd[i1];
      if constexpr (kDrain) {
        cur_u = nxt_u; cur_f = nxt_f;
        nxt_u = t_up[off + i1]; nxt_f = is_fail[off + i1];
      }
    }
    const double t = __shfl_sync(kFull, cur_a, src);
    const int n = clampi(__shfl_sync(kFull, cur_n, src), 1, k);
    const double svc = __shfl_sync(kFull, cur_s, src);
    int e_nth;
    const double start = fmax(fmax(t, s.t_prev), rs_nth(s, n - 1, &e_nth));
    bool drain = false;
    if constexpr (kDrain) drain = __shfl_sync(kFull, (int)cur_f, src) != 0;
    if (drain)
      rs_drain(s, __shfl_sync(kFull, cur_u, src));
    else
      rs_commit(s, start, __dadd_rn(start, svc), n);
    my_start = lane == src ? start : my_start;
    if (src == 31 || j == J - 1) {
      if (lane <= src) out[(j & ~31) + lane] = my_start;
    }
  }
  if constexpr (kStream) {
    rs_store(s, carry_w + (size_t)blockIdx.x * k, k);
    if (lane == 0) carry_t[blockIdx.x] = s.t_prev;
  }
}

// ---------------------------------------------------------------------------
// ModifiedBS-pi (Definition 2): one warp per replication.  Shared memory
// holds each class row of the completion matrix [C][s_max] sorted
// ascending (slots beyond slots[c] hold BIG: permanently busy; slots [R][C]
// is the block's own row) and the spill of the helper's run-length state
// (h servers, h_lane[b] of them live).  Only the row's
// multiset of completions reaches an output: a job is blocked when all
// s_max entries are > t, which is row[0] > t (the kept minimum: no count
// and no argmin), and a start on a free slot, or a class drain, replaces
// one smallest entry (the plain step's first argmin; which of equal
// entries it is changes nothing), so a row step is one vote: the minimum
// retires, and the new entry goes in after the p = count(row[1:] <= new)
// entries, which move down one place.  A blocked job runs the FCFS step
// on the helper's run-length state.  kDrain: J counts merged rows; a
// failure row with cls == C drains the helper, one with cls < C replaces
// its row's minimum by max(minimum, t_up).  kStream: the rows (sorted),
// the helper's W and t_prev come from the carry (carry_comp [R][C*s_max],
// carry_w [R][h], carry_t [R]) and go back to it.
// ---------------------------------------------------------------------------

// The smallest entry of a sorted row of m leaves and nv goes in.  cur, nxt:
// row[lane], row[lane + 1] as read at the top of the step (m <= 32).
__device__ __forceinline__ void row_replace_min(double* row, int m, double nv,
                                                double cur, double nxt) {
  const int lane = threadIdx.x & 31;
  if (m <= 32) {
    const int p = __popc(__ballot_sync(kFull, lane >= 1 && lane < m &&
                                                  cur <= nv));
    const double y = lane < p ? nxt : nv;
    __syncwarp();   // every lane has read the row
    if (lane <= p) row[lane] = y;
    return;
  }
  int p = 0;
#pragma unroll 1
  for (int b = 0; b < m; b += 32) {
    const int i = b + lane;
    p += __popc(__ballot_sync(kFull, i >= 1 && i < m && row[i] <= nv));
  }
#pragma unroll 1
  for (int b = 0; b <= p; b += 32) {
    const int i = b + lane;
    const double y = i < p ? row[i + 1] : nv;
    __syncwarp();   // every lane has read its entry
    if (i <= p) row[i] = y;
  }
}

template <bool kDrain, bool kStream = false>
__global__ void __launch_bounds__(32)
    modbs_scan_kernel(const double* __restrict__ arrival,
                      const int* __restrict__ cls,
                      const int* __restrict__ need,
                      const double* __restrict__ service,
                      const double* __restrict__ t_up,
                      const bool* __restrict__ is_fail,
                      const int* __restrict__ slots_all,
                      const int* __restrict__ h_lane,
                      bool* __restrict__ blocked_out,
                      double* __restrict__ starts, int J, int C, int s_max,
                      int h, double* __restrict__ carry_comp = nullptr,
                      double* __restrict__ carry_w = nullptr,
                      double* __restrict__ carry_t = nullptr) {
  extern __shared__ double smem[];
  const int CS = C * s_max;
  double* comp = smem;
  double* hv = comp + CS;
  unsigned* hc = reinterpret_cast<unsigned*>(hv + msj_spill_slots(h));
  const int lane = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const int* cl = cls + off;
  const int* nd = need + off;
  const double* sv = service + off;
  RunState s;
  if constexpr (kStream) {
    const double* cc = carry_comp + (size_t)blockIdx.x * CS;
    for (int i = lane; i < CS; i += 32) comp[i] = cc[i];
    rs_init(s, hv, hc, h, h);
    rs_load(s, carry_w + (size_t)blockIdx.x * h, h, carry_t[blockIdx.x]);
  } else {
    const int* slots = slots_all + (size_t)blockIdx.x * C;
    for (int i = lane; i < CS; i += 32)   // free slots first: sorted
      comp[i] = (i % s_max) >= slots[i / s_max] ? kBig : 0.0;
    rs_init(s, hv, hc, h, clampi(h_lane[blockIdx.x], 1, h));
  }

  double cur_a, cur_s, nxt_a, nxt_s, cur_u = 0.0, nxt_u = 0.0;
  int cur_c, cur_n, nxt_c, nxt_n;
  bool cur_f = false, nxt_f = false;
  {
    const int i0 = min(lane, J - 1), i1 = min(32 + lane, J - 1);
    cur_a = a[i0]; cur_s = sv[i0]; cur_c = cl[i0]; cur_n = nd[i0];
    nxt_a = a[i1]; nxt_s = sv[i1]; nxt_c = cl[i1]; nxt_n = nd[i1];
    if constexpr (kDrain) {
      cur_u = t_up[off + i0]; cur_f = is_fail[off + i0];
      nxt_u = t_up[off + i1]; nxt_f = is_fail[off + i1];
    }
  }
  double my_start = 0.0;
  bool my_blocked = false;
  __syncwarp();
  for (int j = 0; j < J; ++j) {
    const int src = j & 31;
    if (src == 0 && j > 0) {
      cur_a = nxt_a; cur_s = nxt_s; cur_c = nxt_c; cur_n = nxt_n;
      const int i1 = min(j + 32 + lane, J - 1);
      nxt_a = a[i1]; nxt_s = sv[i1]; nxt_c = cl[i1]; nxt_n = nd[i1];
      if constexpr (kDrain) {
        cur_u = nxt_u; cur_f = nxt_f;
        nxt_u = t_up[off + i1]; nxt_f = is_fail[off + i1];
      }
    }
    const double t = __shfl_sync(kFull, cur_a, src);
    // a failure row's class column is its target block, C = the helper
    const int c = clampi(__shfl_sync(kFull, cur_c, src), 0,
                         kDrain ? C : C - 1);
    const int n = clampi(__shfl_sync(kFull, cur_n, src), 1, h);
    const double svc = __shfl_sync(kFull, cur_s, src);
    double* row = comp + (kDrain ? min(c, C - 1) : c) * s_max;
    const double r0 = row[0];   // the row's minimum
    double cur = INFINITY, nxt = INFINITY;
    if (s_max <= 32) {
      if (lane < s_max) cur = row[lane];
      if (lane + 1 < s_max) nxt = row[lane + 1];
    }
    const bool blocked = r0 > t;
    bool isf = false, helper_fail = false, class_fail = false;
    double tu = 0.0;
    if constexpr (kDrain) {
      isf = __shfl_sync(kFull, (int)cur_f, src) != 0;
      tu = __shfl_sync(kFull, cur_u, src);
      helper_fail = isf && c == C;
      class_fail = isf && !helper_fail;
    }
    double start = t;
    if (blocked) {
      int e_nth;
      start = fmax(fmax(t, s.t_prev), rs_nth(s, n - 1, &e_nth));
    }
    // only class drains and arrivals on a free slot write the row
    if (class_fail || (!isf && !blocked))
      row_replace_min(row, s_max,
                      class_fail ? fmax(r0, tu) : __dadd_rn(t, svc), cur,
                      nxt);
    if (helper_fail)
      rs_drain(s, tu);
    else if (!isf && blocked)
      rs_commit(s, start, __dadd_rn(start, svc), n);
    my_start = lane == src ? start : my_start;
    my_blocked = lane == src ? blocked && !isf : my_blocked;
    if (src == 31 || j == J - 1) {
      if (lane <= src) {
        starts[off + (j & ~31) + lane] = my_start;
        blocked_out[off + (j & ~31) + lane] = my_blocked;
      }
    }
    // the row's and the helper's writes before the next step's reads
    __syncwarp();
  }
  if constexpr (kStream) {
    double* cc = carry_comp + (size_t)blockIdx.x * CS;
    for (int i = lane; i < CS; i += 32) cc[i] = comp[i];
    rs_store(s, carry_w + (size_t)blockIdx.x * h, h);
    if (lane == 0) carry_t[blockIdx.x] = s.t_prev;
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
// A block reads its own sizes: slots [R][C] (padded classes have none),
// h_lane (the helper's W holds BIG, dead servers, past them) and j_live, its
// jobs (J is the row stride; a job at or past j_live is never admitted).
// Without failures the block runs its 2 j_live events and records (-1, Tc)
// past them, as a step with no event would.
// kStream (sim_jax._bs_stream_make_step): the state comes from the chunk
// carry (c_ai, c_st [R][3C], c_comp, c_ring [R][C*q_cap] job ids, c_heads,
// c_W, c_tp, c_th, ovf_out, c_ne) and goes back to it; `length` steps,
// a commit only while Th <= horizon[b], a completion only while
// Tc < horizon[b] and Tc < 0.5 BIG, an arrival only while ai < J; ne
// counts the events.
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

// Sorted roll-and-insert of n copies of comp into the helper's free-time
// vector: the n smallest entries of src retire, p = count(src <= comp) - n
// (one redux.sync), dst = [src[n:n+p], comp x n, src[n+p:]].  No closing
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

template <bool kDrain, bool kStream = false>
__global__ void __launch_bounds__(32)
    bs_scan_kernel(const double* __restrict__ arrival,
                   const int* __restrict__ cls, const int* __restrict__ need,
                   const double* __restrict__ service,
                   const double* __restrict__ fail_t,
                   const int* __restrict__ fail_tgt,
                   const double* __restrict__ fail_up,
                   const int* __restrict__ slots_all,
                   const int* __restrict__ h_lane,
                   const int* __restrict__ j_live, int* __restrict__ tagged_out,
                   double* __restrict__ rec_t_out, bool* __restrict__ ovf_out,
                   double2* ring_t_all, int2* ring_i_all, int J, int F, int C,
                   int s_max, int h, int q_cap, int D, int length,
                   const double* __restrict__ horizon = nullptr,
                   int* __restrict__ c_ai = nullptr,
                   int* __restrict__ c_st = nullptr,
                   double* __restrict__ c_comp = nullptr,
                   int* __restrict__ c_ring = nullptr,
                   int* __restrict__ c_heads = nullptr,
                   double* __restrict__ c_W = nullptr,
                   double* __restrict__ c_tp = nullptr,
                   double* __restrict__ c_th = nullptr,
                   int* __restrict__ c_ne = nullptr) {
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
  const int* slots = slots_all + (size_t)blockIdx.x * C;
  const int h_live = kStream ? h : clampi(h_lane[blockIdx.x], 1, h);
  const int jl = kStream ? J : clampi(j_live[blockIdx.x], 0, J);
  const int n_ev = kDrain || kStream ? length : min(2 * jl, length);
  const size_t b = blockIdx.x;
  // the class of flat index i < C*s_max: __umulhi(i, magic), exact since
  // C*s_max < 2^16 (shared memory could not hold more)
  const unsigned magic = s_max > 1 ? (unsigned)(0x100000000ull / s_max + 1)
                                   : 0u;
  auto class_of = [&](int i) {
    return s_max > 1 ? (int)__umulhi((unsigned)i, magic) : i;
  };

  // free slots by the exact argmax: s_max > 32 (no 32-bit mask), or a
  // busy slot at BIG or more
  bool huge = s_max > 32;
  int ai = 0, fi = 0;
  if constexpr (kStream) {
    // the carry: a class's free slots are its BIG entries below slots[c]
    // (a carry with another count of them, or a busy entry above BIG,
    // takes the exact argmax)
    const int* cst = c_st + b * 3 * C;
    const double* ccomp = c_comp + b * CS;
    for (int i = lane; i < CS; i += 32) comp[i] = ccomp[i];
    for (int i = lane; i < h; i += 32) Wa[i] = c_W[b * h + i];
    bool odd = false;
    for (int i = lane; i < C; i += 32) {
      const int g0 = cst[C + i], g1 = cst[2 * C + i];
      st[i] = cst[i];
      st[C + i] = g0;
      st[2 * C + i] = g1;
      st[3 * C + i] = g0 % q_cap;
      st[4 * C + i] = g1 % q_cap;
      const int hd = c_heads[b * C + i];
      heads[i] = hd;
      const int jh = clampi(hd, 0, J - 1);
      ha[i] = hd < J ? a[jh] : 0.0;
      hs[i] = hd < J ? sv[jh] : 0.0;
      hn[i] = hd < J ? clampi(nd[jh], 1, h) : 1;
      unsigned fm = 0u;
      int n_big = 0;
      for (int r = 0; r < min(slots[i], s_max); ++r) {
        const double v = ccomp[i * s_max + r];
        if (v == kBig) {
          ++n_big;
          fm |= r < 32 ? 1u << r : 0u;
        }
        odd = odd || v > kBig;
      }
      fmask[i] = fm;
      odd = odd || n_big != st[i];
    }
    huge = huge || __any_sync(kFull, odd);
    // the queued jobs' records into the ring, at their slots
    for (int c = 0; c < C; ++c) {
      const int g0 = cst[C + c], g1 = cst[2 * C + c];
      for (int g = max(g0, g1 - q_cap) + lane; g < g1; g += 32) {
        const size_t slot = (size_t)c * q_cap + g % q_cap;
        const int id = clampi(c_ring[b * C * q_cap + slot], 0, J - 1);
        ring_t[slot] = make_double2(a[id], sv[id]);
        ring_i[slot] = make_int2(id, clampi(nd[id], 1, h));
      }
    }
    ai = c_ai[b];
  } else {
    for (int i = lane; i < CS; i += 32) comp[i] = kBig;
    for (int i = lane; i < h; i += 32) Wa[i] = i < h_live ? 0.0 : kBig;
    for (int i = lane; i < C; i += 32) {
      st[i] = slots[i];
      for (int r = 1; r < 5; ++r) st[r * C + i] = 0;
      heads[i] = J;
      ha[i] = 0.0;
      hs[i] = 0.0;
      hn[i] = 1;
      fmask[i] = slots[i] >= 32 ? 0xffffffffu : (1u << max(slots[i], 0)) - 1u;
    }
  }
  for (int i = lane; i < C * D; i += 32) rc_i[i] = make_int4(0, 1, -1, 0);

  // arrival windows: lane l holds entry wb + l (cur) and wb + 32 + l (nxt)
  int wb = min(ai, J - 1) & ~31;
  double cur_a, cur_s, nxt_a, nxt_s;
  int cur_c, cur_n, nxt_c, nxt_n;
  {
    const int i0 = min(wb + lane, J - 1), i1 = min(wb + 32 + lane, J - 1);
    cur_a = a[i0]; cur_s = sv[i0]; cur_c = cl[i0]; cur_n = nd[i0];
    nxt_a = a[i1]; nxt_s = sv[i1]; nxt_c = cl[i1]; nxt_n = nd[i1];
  }
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
    Ta = ai < jl ? a_arr : INFINITY;
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
  bool need_min = kStream;
  // the helper queue's head: job gh of class gc, its record and start Th
  int gh = J, gc = 0, hn_g = 1;
  double ha_g = 0.0, hs_g = 0.0, Th = INFINITY;
  double hz = INFINITY;   // kStream: the chunk's horizon
  int ne = 0;             // kStream: events processed
  if constexpr (kStream) {
    t_prev = c_tp[b];
    t_hol = c_th[b];
    hz = horizon[b];
    ne = c_ne[b];
  }
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
  int my_tag = -1;                // the records, one step per lane
  double my_rec = 0.0;
  bool ovf = kStream ? ovf_out[b] : false;
  __syncwarp();
  if constexpr (kStream) {   // the carried queue's head
    gc = bs_min_head(heads, C, -1, J, &gh);
    if (gh < J) {
      ha_g = ha[gc]; hs_g = hs[gc]; hn_g = hn[gc];
    }
    start_on_h();
  }

  for (int e = 0; e < n_ev; ++e) {
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
    bool is_commit = !is_fail && (Th <= Tc) && (Th <= Ta);
    if constexpr (kStream) is_commit = is_commit && Th <= hz;
    bool is_comp = !is_fail && !is_commit && (Tc < Ta);
    if constexpr (kDrain || kStream) is_comp = is_comp && Tc < 0.5 * kBig;
    if constexpr (kStream) is_comp = is_comp && Tc < hz;
    bool is_arr = !is_fail && !is_commit && !is_comp;
    if constexpr (kDrain || kStream) is_arr = is_arr && ai < jl;
    if constexpr (kStream) ne += is_commit || is_comp || is_arr ? 1 : 0;
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
    if ((e & 31) == 31 || e == n_ev - 1) {
      const int i = (e & ~31) + lane;
      if (i <= e) {
        tagged[i] = my_tag;
        rec_t[i] = my_rec;
      }
    }
    __syncwarp();
  }
  if (lane == 0) ovf_out[blockIdx.x] = ovf;
  if constexpr (kStream) {   // the carry back, the ring as queued ids
    for (int i = lane; i < CS; i += 32) c_comp[b * CS + i] = comp[i];
    for (int i = lane; i < h; i += 32) c_W[b * h + i] = Wa[i];
    int* cst = c_st + b * 3 * C;
    for (int i = lane; i < C; i += 32) {
      cst[i] = s_free[i];
      cst[C + i] = s_g0[i];
      cst[2 * C + i] = s_g1[i];
      c_heads[b * C + i] = heads[i];
    }
    for (int c = 0; c < C; ++c) {
      const int n = min(s_g1[c] - s_g0[c], q_cap), hw = s_hw[c];
      for (int p = lane; p < q_cap; p += 32) {
        const int d = p >= hw ? p - hw : p - hw + q_cap;
        const size_t slot = (size_t)c * q_cap + p;
        c_ring[b * C * q_cap + slot] = d < n ? ring_i[slot].x : 0;
      }
    }
    if (lane == 0) {
      c_ai[b] = ai;
      c_tp[b] = t_prev;
      c_th[b] = t_hol;
      c_ne[b] = ne;
    }
  }
  if (n_ev < length) {   // past a grid lane's events: (-1, Tc) records
    if (need_min) cm = bs_argmin(comp, CS, &Tc);
    for (int i = n_ev + lane; i < length; i += 32) {
      tagged[i] = -1;
      rec_t[i] = Tc;
    }
  }
}

// ---------------------------------------------------------------------------
// The M/GI/s/s loss queue (sim_jax._loss_core, the Property-1 building
// block; the reference scans it with lax.scan, no Pallas kernel): one warp
// per replication.  Shared memory holds the s completion times as one
// sorted row, kept as a ModBS class row is: the plain step's job is
// blocked when all s entries are > t, which is row[0] > t, and an admitted
// job replaces a smallest entry with t + svc (row_replace_min).  Only the
// row's multiset reaches the output (the plain step's first argmin is one
// of the equal minima), so the order it is kept in changes nothing, and the
// only arithmetic is that one float64 add.  What bounds it: each step
// depends on the last, a chain of a shared load, a compare, a ballot and a
// shared store (for s > 32 a pass over the row's 32-entry chunks), J steps
// per replication; the bytes, R*J*17, take microseconds.  Arrival and
// service are read in 32-entry windows, one entry a lane, the next window
// in flight; the blocked flags are stored 32 at a time.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
    loss_scan_kernel(const double* __restrict__ arrival,
                     const double* __restrict__ service,
                     bool* __restrict__ blocked_out, int J, int s) {
  extern __shared__ double smem[];
  double* row = smem;
  const int lane = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const double* sv = service + off;
  for (int i = lane; i < s; i += 32) row[i] = 0.0;
  double cur_a, cur_s, nxt_a, nxt_s;
  {
    const int i0 = min(lane, J - 1), i1 = min(32 + lane, J - 1);
    cur_a = a[i0]; cur_s = sv[i0];
    nxt_a = a[i1]; nxt_s = sv[i1];
  }
  bool my_blocked = false;
  __syncwarp();
  for (int j = 0; j < J; ++j) {
    const int src = j & 31;
    if (src == 0 && j > 0) {
      cur_a = nxt_a; cur_s = nxt_s;
      const int i1 = min(j + 32 + lane, J - 1);
      nxt_a = a[i1]; nxt_s = sv[i1];
    }
    const double t = __shfl_sync(kFull, cur_a, src);
    const double svc = __shfl_sync(kFull, cur_s, src);
    const double r0 = row[0];   // the earliest completion
    double cur = INFINITY, nxt = INFINITY;
    if (s <= 32) {
      if (lane < s) cur = row[lane];
      if (lane + 1 < s) nxt = row[lane + 1];
    }
    const bool blocked = r0 > t;
    if (!blocked) row_replace_min(row, s, __dadd_rn(t, svc), cur, nxt);
    my_blocked = lane == src ? blocked : my_blocked;
    if (src == 31 || j == J - 1) {
      if (lane <= src) blocked_out[off + (j & ~31) + lane] = my_blocked;
    }
    // the row's writes before the next step's reads
    __syncwarp();
  }
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

// Shared-memory bytes of the kernels: a run-length state of m servers
// spills its groups past the register chunks, at most m, 12 bytes each.
size_t msj_run_smem(int m) {
  return (size_t)msj_spill_slots(m) * (sizeof(double) + sizeof(unsigned));
}
size_t msj_modbs_smem(int C, int s_max, int h) {
  return (size_t)C * s_max * sizeof(double) + msj_run_smem(h);
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

}  // namespace

extern "C" {

const char* msj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Per-lane sizes: k_lane, h_lane, j_live [R] and slots [R][C], a row per
// block; k, h, C, s_max and the row stride J are their maxima (shared
// memory is sized by them).
int msj_fcfs_scan(const double* arrival, const int* need, const double* service,
                  const int* k_lane, double* starts, int R, int J, int k,
                  void* stream) {
  const size_t smem = msj_run_smem(k);
  cudaError_t err = prepare_smem(fcfs_scan_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  fcfs_scan_kernel<false><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, need, service, nullptr, nullptr, k_lane, starts, J, k);
  return (int)cudaGetLastError();
}

int msj_fcfs_fail_scan(const double* t, const int* need, const double* svc,
                       const double* t_up, const bool* is_fail,
                       const int* k_lane, double* starts, int R, int L, int k,
                       void* stream) {
  const size_t smem = msj_run_smem(k);
  cudaError_t err = prepare_smem(fcfs_scan_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  fcfs_scan_kernel<true><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      t, need, svc, t_up, is_fail, k_lane, starts, L, k);
  return (int)cudaGetLastError();
}

int msj_modbs_scan(const double* arrival, const int* cls, const int* need,
                   const double* service, const int* slots, const int* h_lane,
                   bool* blocked, double* starts, int R, int J, int C,
                   int s_max, int h, void* stream) {
  const size_t smem = msj_modbs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(modbs_scan_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  modbs_scan_kernel<false><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, nullptr, nullptr, slots, h_lane, blocked,
      starts, J, C, s_max, h);
  return (int)cudaGetLastError();
}

int msj_modbs_fail_scan(const double* t, const int* cls, const int* need,
                        const double* svc, const double* t_up, const bool* is_fail,
                        const int* slots, const int* h_lane, bool* blocked,
                        double* starts, int R, int L, int C, int s_max, int h,
                        void* stream) {
  const size_t smem = msj_modbs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(modbs_scan_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  modbs_scan_kernel<true><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      t, cls, need, svc, t_up, is_fail, slots, h_lane, blocked, starts, L, C,
      s_max, h);
  return (int)cudaGetLastError();
}

int msj_bs_scan(const double* arrival, const int* cls, const int* need,
                const double* service, const int* slots, const int* h_lane,
                const int* j_live, int* tagged, double* rec_t, bool* ovf,
                void* ring_scratch, int R, int J, int C, int s_max, int h,
                int q_cap, void* stream) {
  const size_t smem = msj_bs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(bs_scan_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  double2* ring_t;
  int2* ring_i;
  bs_rings(ring_scratch, R, C, q_cap, &ring_t, &ring_i);
  bs_scan_kernel<false><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, nullptr, nullptr, nullptr, slots, h_lane,
      j_live, tagged, rec_t, ovf, ring_t, ring_i, J, 0, C, s_max, h, q_cap,
      msj_bs_cache_lines(C), 2 * J);
  return (int)cudaGetLastError();
}

int msj_bs_fail_scan(const double* arrival, const int* cls, const int* need,
                     const double* service, const double* fail_t,
                     const int* fail_tgt, const double* fail_up, const int* slots,
                     const int* h_lane, const int* j_live, int* tagged,
                     double* rec_t, bool* ovf, void* ring_scratch, int R, int J,
                     int F, int C, int s_max, int h, int q_cap, int length,
                     void* stream) {
  const size_t smem = msj_bs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(bs_scan_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  double2* ring_t;
  int2* ring_i;
  bs_rings(ring_scratch, R, C, q_cap, &ring_t, &ring_i);
  bs_scan_kernel<true><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, fail_t, fail_tgt, fail_up, slots, h_lane,
      j_live, tagged, rec_t, ovf, ring_t, ring_i, J, F, C, s_max, h, q_cap,
      msj_bs_cache_lines(C), length);
  return (int)cudaGetLastError();
}

// The loss queue: s completion times of 8 bytes in shared memory.
int msj_loss_scan(const double* arrival, const double* service,
                  bool* blocked, int R, int J, int s, void* stream) {
  const size_t smem = (size_t)s * sizeof(double);
  cudaError_t err = prepare_smem(loss_scan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  loss_scan_kernel<<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, service, blocked, J, s);
  return (int)cudaGetLastError();
}

// Carried entries: one chunk of a stream, the carry read at entry and
// written back in place (the caller passes copies).
int msj_fcfs_stream(const double* arrival, const int* need,
                    const double* service, double* carry_w, double* carry_t,
                    double* starts, int R, int J, int k, void* stream) {
  const size_t smem = msj_run_smem(k);
  cudaError_t err = prepare_smem(fcfs_scan_kernel<false, true>, smem);
  if (err != cudaSuccess) return (int)err;
  fcfs_scan_kernel<false, true>
      <<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
          arrival, need, service, nullptr, nullptr, nullptr, starts, J, k,
          carry_w, carry_t);
  return (int)cudaGetLastError();
}

int msj_modbs_stream(const double* arrival, const int* cls, const int* need,
                     const double* service, double* carry_comp,
                     double* carry_w, double* carry_t, bool* blocked,
                     double* starts, int R, int J, int C, int s_max, int h,
                     void* stream) {
  const size_t smem = msj_modbs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(modbs_scan_kernel<false, true>, smem);
  if (err != cudaSuccess) return (int)err;
  modbs_scan_kernel<false, true>
      <<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
          arrival, cls, need, service, nullptr, nullptr, nullptr, nullptr,
          blocked, starts, J, C, s_max, h, carry_comp, carry_w, carry_t);
  return (int)cudaGetLastError();
}

// The carry, in order: ai [R], st [R][3C], comp [R][C*s_max],
// ring [R][C*q_cap], heads [R][C], W [R][h], t_prev, t_hol [R], ovf [R],
// ne [R]; slots [R][C].
int msj_bs_stream(const double* arrival, const int* cls, const int* need,
                  const double* service, const int* slots,
                  const double* horizon, int* c_ai, int* c_st, double* c_comp,
                  int* c_ring, int* c_heads, double* c_W, double* c_tp,
                  double* c_th, bool* c_ovf, int* c_ne, int* tagged,
                  double* rec_t, void* ring_scratch, int R, int J, int C,
                  int s_max, int h, int q_cap, int length, void* stream) {
  const size_t smem = msj_bs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(bs_scan_kernel<false, true>, smem);
  if (err != cudaSuccess) return (int)err;
  double2* ring_t;
  int2* ring_i;
  bs_rings(ring_scratch, R, C, q_cap, &ring_t, &ring_i);
  bs_scan_kernel<false, true>
      <<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
          arrival, cls, need, service, nullptr, nullptr, nullptr, slots,
          nullptr, nullptr, tagged, rec_t, c_ovf, ring_t, ring_i, J, 0, C,
          s_max, h, q_cap, msj_bs_cache_lines(C), length, horizon, c_ai,
          c_st, c_comp, c_ring, c_heads, c_W, c_tp, c_th, c_ne);
  return (int)cudaGetLastError();
}

}  // extern "C"
