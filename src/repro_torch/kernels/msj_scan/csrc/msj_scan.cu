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
// to C*q_cap ints per replication, live in a global scratch buffer that
// stays in L2) and spreads the O(k) vector work of a step over the threads
// of the block, with as few barriers per step as the data flow allows.
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
// Warp-level pieces (ModBS and BS run one warp per replication).
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

// First index of the maximum of x[0..m) over the warp.
__device__ __forceinline__ int warp_argmax(const double* x, int m) {
  const int lane = threadIdx.x & 31;
  double best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = lane; i < m; i += 32) {
    const double v = x[i];
    if (v > best) { best = v; bi = i; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
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
// sim_jax._bs_make_step statement for statement.  Shared memory holds the
// completion matrix comp [C*s_max], the helper free-time vector W [h]
// (double-buffered), the counters st [3C] (free slots, ring heads, ring
// tails) and the per-class head jobs heads [C]; ai, t_prev, t_hol and ovf
// live in registers, identical in every lane.  The per-class helper-wait
// rings [C*q_cap] live in global scratch.  Every lane computes the step's
// scalars from the same shared state; lane 0 alone writes scalar state,
// and __syncwarp orders the writes before the next reads.  kDrain
// (sim_jax._bs_fail_make_step): the [F] failure record (time, target,
// t_up) is read from global memory at the cursor fi, and the scan runs
// `length` = 2J + F + F_A steps (2J without failures).
// ---------------------------------------------------------------------------

template <bool kDrain>
__global__ void bs_scan_kernel(const double* __restrict__ arrival,
                               const int* __restrict__ cls,
                               const int* __restrict__ need,
                               const double* __restrict__ service,
                               const double* __restrict__ fail_t,
                               const int* __restrict__ fail_tgt,
                               const double* __restrict__ fail_up,
                               const int* __restrict__ slots,
                               int* __restrict__ tagged_out,
                               double* __restrict__ rec_t_out,
                               bool* __restrict__ ovf_out,
                               int* __restrict__ ring_scratch, int J, int F,
                               int C, int s_max, int h, int q_cap,
                               int length) {
  extern __shared__ double smem[];
  const int CS = C * s_max;
  double* comp = smem;
  double* Wa = comp + CS;
  double* Wb = Wa + h;
  int* st = reinterpret_cast<int*>(Wb + h);
  int* heads = st + 3 * C;
  const int lane = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * J;
  const double* a = arrival + off;
  const int* cl = cls + off;
  const int* nd = need + off;
  const double* sv = service + off;
  int* ring = ring_scratch + (size_t)blockIdx.x * C * q_cap;
  int* tagged = tagged_out + (size_t)blockIdx.x * length;
  double* rec_t = rec_t_out + (size_t)blockIdx.x * length;
  const size_t off_f = (size_t)blockIdx.x * F;

  for (int i = lane; i < CS; i += 32) comp[i] = kBig;
  for (int i = lane; i < h; i += 32) Wa[i] = 0.0;
  for (int i = lane; i < C; i += 32) {
    st[i] = slots[i];
    st[C + i] = 0;
    st[2 * C + i] = 0;
    heads[i] = J;
  }
  int ai = 0, fi = 0;
  double t_prev = 0.0, t_hol = 0.0;
  bool ovf = false;
  __syncwarp();

  for (int e = 0; e < length; ++e) {
    const int j_arr = min(ai, J - 1);
    const double Ta = ai < J ? a[j_arr] : INFINITY;
    double Tc;
    const int cm = warp_argmin(comp, CS, &Tc);
    int gh = heads[0];
    for (int c = 1; c < C; ++c) gh = min(gh, heads[c]);
    const bool has_head = gh < J;
    const int jh = min(gh, J - 1);
    const int nh = clampi(nd[jh], 1, h);
    const double Th = has_head
        ? fmax(fmax(a[jh], t_hol), fmax(t_prev, Wa[nh - 1])) : INFINITY;

    // drain mode: the next breakdown wins ties and claims the earliest-free
    // unit of its target block (C = the helper)
    bool is_fail = false, helper_fail = false;
    bool fail_free = false, fail_busy = false;
    int fcc = 0, pos_free = 0, cmf = 0;
    double fu = 0.0, vmin = 0.0;
    if constexpr (kDrain) {
      const int fi_c = min(fi, F - 1);
      const double Tf = fi < F ? fail_t[off_f + fi_c] : INFINITY;
      const int fc = clampi(fail_tgt[off_f + fi_c], 0, C);
      fu = fail_up[off_f + fi_c];
      is_fail = (Tf <= Ta) && (Tf <= Tc) && (Tf <= Th) && (Tf < INFINITY);
      fi += is_fail ? 1 : 0;
      fcc = min(fc, C - 1);
      helper_fail = is_fail && fc == C;
      const bool class_fail = is_fail && !helper_fail;
      fail_free = class_fail && st[fcc] > 0;
      fail_busy = class_fail && !(st[fcc] > 0);
      if (fail_free) pos_free = warp_argmax(comp + fcc * s_max, s_max);
      if (fail_busy) cmf = warp_argmin(comp + fcc * s_max, s_max, &vmin);
    }
    const bool is_commit = !is_fail && (Th <= Tc) && (Th <= Ta);
    bool is_comp = !is_fail && !is_commit && (Tc < Ta);
    if constexpr (kDrain) is_comp = is_comp && Tc < 0.5 * kBig;
    bool is_arr = !is_fail && !is_commit && !is_comp;
    if constexpr (kDrain) is_arr = is_arr && ai < J;

    // arrival (rule 1): a free A_i slot starts the job, else it enqueues
    const int c_arr = clampi(cl[j_arr], 0, C - 1);
    const int free_c = st[c_arr];
    const int head_c = st[C + c_arr];
    const int tail_c = st[2 * C + c_arr];
    const bool has_slot = is_arr && free_c > 0;
    const bool enq = is_arr && !has_slot;
    if (enq && lane == 0) ring[c_arr * q_cap + tail_c % q_cap] = j_arr;
    ovf = ovf || (enq && (tail_c + 1 - head_c > q_cap));
    ai += is_arr ? 1 : 0;

    // A completion: rule 3 pulls the class head into the freed slot
    const int c_comp = cm / s_max;
    const int pull = heads[c_comp];
    const bool can_pull = is_comp && pull < J;
    const int jp = min(pull, J - 1);
    if (can_pull && pull == gh) t_hol = fmax(t_hol, Tc);

    const bool ins = has_slot || can_pull;
    const int j_ins = is_arr ? j_arr : jp;
    const double t_ins = is_arr ? Ta : Tc;
    const int pos = has_slot ? warp_argmax(comp + c_arr * s_max, s_max) : 0;
    const double comp_h = Th + sv[jh];
    const int pop_c = can_pull ? c_comp : clampi(cl[jh], 0, C - 1);
    __syncwarp();   // every lane has read comp, W, st and heads

    // comp: clear the completed slot, or insert the next A start
    if (lane == 0) {
      const double v = __dadd_rn(t_ins, sv[j_ins]);
      if (is_comp && !can_pull) comp[cm] = kBig;
      if (has_slot) comp[c_arr * s_max + pos] = v;
      else if (can_pull) comp[cm] = v;
      if constexpr (kDrain) {
        if (fail_free) comp[fcc * s_max + pos_free] = fu;
        else if (fail_busy) comp[fcc * s_max + cmf] = fmax(vmin, fu);
      }
    }

    // helper commit: the global head starts on H at Th (pi = FCFS)
    if (is_commit) {
      warp_roll_insert(Wa, Wb, h, nh, comp_h);
      double* tmp = Wa; Wa = Wb; Wb = tmp;
      t_prev = Th;
    }
    if constexpr (kDrain) {   // helper drain (never on a commit step)
      if (helper_fail) {
        warp_roll_insert(Wa, Wb, h, 1, fmax(Wa[0], fu));
        double* tmp = Wa; Wa = Wb; Wb = tmp;
      }
    }

    // counters, then the per-class head jobs
    const bool did_pop = can_pull || is_commit;
    if (lane == 0) {
      if (is_arr) st[c_arr] += has_slot ? -1 : 0;
      else if (is_comp) st[c_comp] += can_pull ? 0 : 1;
      if (enq) st[2 * C + c_arr] += 1;
      if constexpr (kDrain) {
        if (fail_free) st[fcc] -= 1;
      }
      if (did_pop) {
        const int g0 = ++st[C + pop_c];
        const int g1 = st[2 * C + pop_c];
        heads[pop_c] = g0 < g1 ? ring[pop_c * q_cap + g0 % q_cap] : J;
      }
      if (enq && head_c == tail_c) heads[c_arr] = j_arr;
      tagged[e] = is_commit ? jh + 2 * J
                            : (ins ? j_ins : (enq ? j_arr + J : -1));
      rec_t[e] = is_commit ? Th : t_ins;
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
size_t msj_bs_smem(int C, int s_max, int h) {
  return ((size_t)C * s_max + 2 * (size_t)h) * sizeof(double) + 4 * (size_t)C * sizeof(int);
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
                double* rec_t, bool* ovf, int* ring_scratch, int R, int J,
                int C, int s_max, int h, int q_cap, void* stream) {
  const size_t smem = msj_bs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(bs_scan_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  bs_scan_kernel<false><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, nullptr, nullptr, nullptr, slots, tagged,
      rec_t, ovf, ring_scratch, J, 0, C, s_max, h, q_cap, 2 * J);
  return (int)cudaGetLastError();
}

int msj_bs_fail_scan(const double* arrival, const int* cls, const int* need,
                     const double* service, const double* fail_t,
                     const int* fail_tgt, const double* fail_up, const int* slots,
                     int* tagged, double* rec_t, bool* ovf, int* ring_scratch,
                     int R, int J, int F, int C, int s_max, int h, int q_cap,
                     int length, void* stream) {
  const size_t smem = msj_bs_smem(C, s_max, h);
  cudaError_t err = prepare_smem(bs_scan_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  bs_scan_kernel<true><<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      arrival, cls, need, service, fail_t, fail_tgt, fail_up, slots, tagged,
      rec_t, ovf, ring_scratch, J, F, C, s_max, h, q_cap, length);
  return (int)cudaGetLastError();
}

}  // extern "C"
