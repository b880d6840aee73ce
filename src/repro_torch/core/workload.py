"""Multiserver-job workload model (paper §3.1) and the Figure-1–3 workloads.

The port's own copy of the parts of the reference ``repro.core.workload``
that the Fig. 1–3 sweeps need: service-time distributions, job classes,
the ``Workload`` with its per-replication Philox trace sampler, the
``BatchTrace``/``Trace`` containers (with the bootstrap
``BatchTrace.from_trace``), the streaming chunk sources
(:class:`ChunkSource`: replayed, Poisson, diurnal, flash-crowd, MMPP and
bootstrap streams, each chunk from its own :func:`chunk_stream`
substream), the subcritical/critical scalings (eqs. 6-8), the Figure-1/2
workloads and the Table-2/3 HPC workloads of Figure 3.  Sampling is plain
numpy with the same Philox streams as the reference, so a seed gives
bit-equal traces and chunks on both sides.

A workload is a finite set of job *classes*.  A class-``i`` job requires the
simultaneous possession of ``n_i`` servers for a random service time ``D_i``
(mean ``d_i``) and arrives with probability ``alpha_i``; the aggregate arrival
process is Poisson(``lam``) onto ``k`` unit-speed servers.

Relative demand  ``rho_i = alpha_i * d_i * n_i``      (paper notation ϱ_i)
Aggregate demand ``rho_tot = sum_i rho_i``            (ϱ)
Load             ``load = lam / k * rho_tot``         (ρ, eq. 1)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

# --------------------------------------------------------------------------
# Service-time distributions.
#
# Distributions are represented as small picklable objects with a mean and a
# sampler.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServiceDistribution:
    """A nonnegative service-time distribution."""

    kind: str  # "exponential" | "deterministic" | "lognormal" | "hyperexp"
    mean: float
    # second parameter, meaning depends on kind:
    #   lognormal -> std, hyperexp -> (p, mu1, mu2) packed in aux
    std: float = 0.0
    aux: tuple = ()

    def sample(self, rng: np.random.Generator, size: int | None = None):
        if self.kind == "exponential":
            return rng.exponential(self.mean, size=size)
        if self.kind == "deterministic":
            if size is None:
                return self.mean
            return np.full(size, self.mean)
        if self.kind == "lognormal":
            mu, sigma = _lognormal_params(self.mean, self.std)
            return rng.lognormal(mu, sigma, size=size)
        if self.kind == "hyperexp":
            p, m1, m2 = self.aux
            if size is None:
                branch = rng.random() < p
                return rng.exponential(m1 if branch else m2)
            branch = rng.random(size) < p
            return np.where(branch, rng.exponential(m1, size), rng.exponential(m2, size))
        raise ValueError(f"unknown service distribution kind {self.kind!r}")

    def scv(self) -> float:
        """Squared coefficient of variation (used for sanity checks only)."""
        if self.kind == "exponential":
            return 1.0
        if self.kind == "deterministic":
            return 0.0
        if self.kind == "lognormal":
            return (self.std / self.mean) ** 2
        if self.kind == "hyperexp":
            p, m1, m2 = self.aux
            m = p * m1 + (1 - p) * m2
            second = 2 * (p * m1**2 + (1 - p) * m2**2)
            return second / m**2 - 1.0
        raise ValueError(self.kind)


def _lognormal_params(mean: float, std: float) -> tuple[float, float]:
    """(mu, sigma) of a lognormal with the given mean/std."""
    if mean <= 0:
        raise ValueError("lognormal mean must be positive")
    var = std * std
    sigma2 = math.log(1.0 + var / (mean * mean))
    mu = math.log(mean) - 0.5 * sigma2
    return mu, math.sqrt(sigma2)


def Exp(mean: float) -> ServiceDistribution:
    return ServiceDistribution("exponential", float(mean))


def Det(mean: float) -> ServiceDistribution:
    return ServiceDistribution("deterministic", float(mean))


def LogNormal(mean: float, std: float) -> ServiceDistribution:
    return ServiceDistribution("lognormal", float(mean), float(std))


def Hyperexp(p: float, mu1: float, mu2: float) -> ServiceDistribution:
    """Two-phase hyperexponential: Exp(mean ``mu1``) w.p. ``p``, else
    Exp(mean ``mu2``).

    The ``"hyperexp"`` kind always existed in :class:`ServiceDistribution`
    (sampler and scv), but had no constructor next to :func:`Exp` /
    :func:`Det` / :func:`LogNormal` — every caller had to hand-pack
    ``aux`` and precompute the mean.  ``mu1``/``mu2`` are the *branch
    means*; the overall mean is ``p*mu1 + (1-p)*mu2`` and the scv is
    ``2(p*mu1^2 + (1-p)*mu2^2)/mean^2 - 1 >= 1`` — the standard
    high-variability service model (scv > 1 needs mu1 != mu2).
    """
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"branch probability p must be in [0, 1], got {p}")
    if mu1 <= 0 or mu2 <= 0:
        raise ValueError(f"branch means must be positive, got {mu1}, {mu2}")
    mean = p * mu1 + (1.0 - p) * mu2
    return ServiceDistribution("hyperexp", float(mean),
                               aux=(float(p), float(mu1), float(mu2)))


# --------------------------------------------------------------------------
# Job classes and workloads.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JobClass:
    """A job class: server need ``n``, service-time distribution, arrival prob."""

    name: str
    n: int                      # server need  (n_i, a constant)
    service: ServiceDistribution
    alpha: float                # class probability (alpha_i)

    @property
    def d(self) -> float:
        """Mean service time d_i = E[D_i]."""
        return self.service.mean

    @property
    def demand(self) -> float:
        """Relative demand  ϱ_i = alpha_i * d_i * n_i."""
        return self.alpha * self.d * self.n


@dataclasses.dataclass(frozen=True)
class Workload:
    """A multiserver-job workload: k servers, Poisson(lam), C classes."""

    k: int
    lam: float
    classes: tuple[JobClass, ...]

    def __post_init__(self):
        s = sum(c.alpha for c in self.classes)
        if not math.isclose(s, 1.0, rel_tol=1e-9, abs_tol=1e-9):
            raise ValueError(f"class probabilities must sum to 1, got {s}")
        for c in self.classes:
            if c.n > self.k:
                raise ValueError(f"class {c.name}: need {c.n} > k={self.k}")

    # -- paper quantities ---------------------------------------------------

    @property
    def C(self) -> int:
        return len(self.classes)

    @property
    def demands(self) -> np.ndarray:
        """ϱ_i for each class."""
        return np.array([c.demand for c in self.classes])

    @property
    def total_demand(self) -> float:
        """ϱ = Σ ϱ_i."""
        return float(self.demands.sum())

    @property
    def load(self) -> float:
        """ρ = (λ/k) ϱ  (eq. 1)."""
        return self.lam / self.k * self.total_demand

    @property
    def needs(self) -> np.ndarray:
        return np.array([c.n for c in self.classes], dtype=np.int64)

    @property
    def alphas(self) -> np.ndarray:
        return np.array([c.alpha for c in self.classes])

    @property
    def means(self) -> np.ndarray:
        return np.array([c.d for c in self.classes])

    def with_load(self, load: float) -> "Workload":
        """Rescale λ so the workload has the given load ρ."""
        lam = load * self.k / self.total_demand
        return dataclasses.replace(self, lam=lam)

    def zero_wait_response_time(self) -> float:
        """Σ α_i d_i — the Thm-1 limit of R_{BS-π} (all jobs served instantly)."""
        return float(sum(c.alpha * c.d for c in self.classes))

    # -- trace sampling -----------------------------------------------------

    def sample_trace(self, num_jobs: int, seed=0) -> "Trace":
        """Sample ``num_jobs`` Poisson arrivals with i.i.d. classes/services.

        ``seed`` is anything :func:`numpy.random.default_rng` accepts — an
        int, a ``SeedSequence``, or a ``BitGenerator`` such as the Philox
        stream returned by :func:`replication_stream`.
        """
        rng = np.random.default_rng(seed)
        inter = rng.exponential(1.0 / self.lam, size=num_jobs)
        arrival = np.cumsum(inter)
        cls = rng.choice(self.C, size=num_jobs, p=self.alphas)
        service = np.empty(num_jobs)
        for i, c in enumerate(self.classes):
            mask = cls == i
            service[mask] = c.service.sample(rng, size=int(mask.sum()))
        needs = self.needs[cls]
        return Trace(arrival=arrival, cls=cls.astype(np.int64), service=service,
                     need=needs, k=self.k, C=self.C)

    def sample_traces(self, num_jobs: int, reps: int,
                      seed: int = 0) -> "BatchTrace":
        """Sample ``reps`` independent replications as stacked [R, J] arrays.

        Replication ``r`` draws from the counter-based Philox stream
        ``replication_stream(seed, r)``, so the batch is reproducible
        replication-by-replication against the single-trace path:

            sample_traces(J, R, seed).rep(r)
              == sample_trace(J, seed=replication_stream(seed, r))

        This is the sampling side of the batched sweep
        (:mod:`repro_torch.core.sim_batch`).
        """
        if reps < 1:
            raise ValueError("need at least one replication")
        traces = [self.sample_trace(num_jobs, seed=replication_stream(seed, r))
                  for r in range(reps)]
        return BatchTrace(
            arrival=np.stack([t.arrival for t in traces]),
            cls=np.stack([t.cls for t in traces]),
            service=np.stack([t.service for t in traces]),
            need=np.stack([t.need for t in traces]),
            k=self.k, C=self.C)


def replication_stream(seed: int, rep: int) -> np.random.Philox:
    """The Philox stream of replication ``rep`` under master seed ``seed``.

    Philox is counter-based: distinct (seed, rep) keys give independent
    streams with no sequential seeding artifacts, and the mapping is pure
    arithmetic — no SeedSequence state to thread through checkpoints.
    """
    if seed < 0 or rep < 0:
        raise ValueError("seed and rep must be nonnegative")
    return np.random.Philox(key=np.array([seed, rep], dtype=np.uint64))


def chunk_stream(seed: int, rep: int, chunk: int) -> np.random.Philox:
    """The Philox substream of chunk ``chunk`` within replication ``rep``.

    Streaming sources draw every chunk from its own counter-based
    substream, so chunk ``c`` of a stream is a pure function of
    ``(seed, rep, c)`` — a resumed stream regenerates the exact chunks a
    killed run would have produced, with no generator state beyond the
    chunk index (prefix stability).  The substream sets Philox counter
    word 3 to ``chunk + 1``: the base replication stream starts at
    counter 0 and the failure streams advance counter word 2 (via
    ``.jumped``), so the three uses can never collide.
    """
    if chunk < 0:
        raise ValueError("chunk index must be nonnegative")
    return np.random.Philox(
        counter=np.array([0, 0, 0, chunk + 1], dtype=np.uint64),
        key=np.array([seed, rep], dtype=np.uint64))


@dataclasses.dataclass(frozen=True)
class BatchTrace:
    """``reps`` stacked replications of a job trace ([R, J] arrays).

    ``C`` is the class count of the generating workload; a short trace may
    never sample the last class, so deriving it from ``cls.max()+1`` would
    under-report.  Hand-built batches may leave it ``None`` (observed max).
    """

    arrival: np.ndarray   # float64 [R, J], nondecreasing along axis 1
    cls: np.ndarray       # int64   [R, J]
    service: np.ndarray   # float64 [R, J]
    need: np.ndarray      # int64   [R, J]
    k: int
    C: int | None = None  # workload class count (None: derive from cls)

    def __post_init__(self):
        if not (self.arrival.shape == self.cls.shape == self.service.shape
                == self.need.shape) or self.arrival.ndim != 2:
            raise ValueError("batch arrays must share one [R, J] shape")

    @property
    def reps(self) -> int:
        return self.arrival.shape[0]

    @property
    def num_jobs(self) -> int:
        return self.arrival.shape[1]

    @property
    def num_classes(self) -> int:
        """Workload C when known, else the observed class count."""
        if self.C is not None:
            return self.C
        return int(self.cls.max()) + 1 if self.cls.size else 0

    def rep(self, r: int) -> "Trace":
        """Replication ``r`` as a plain single :class:`Trace`."""
        return Trace(arrival=self.arrival[r], cls=self.cls[r],
                     service=self.service[r], need=self.need[r], k=self.k,
                     C=self.C)

    def slice_jobs(self, start: int, stop: int) -> "BatchTrace":
        """Jobs ``[start, stop)`` of every replication as a sub-batch."""
        return BatchTrace(arrival=self.arrival[:, start:stop],
                          cls=self.cls[:, start:stop],
                          service=self.service[:, start:stop],
                          need=self.need[:, start:stop], k=self.k, C=self.C)

    def pad_jobs(self, j_max: int) -> "BatchTrace":
        """Pad every replication to ``j_max`` jobs with sentinel no-ops.

        The padding rule of grid stacking (cells of different J padded to
        the grid's largest), the reference's ``BatchTrace.pad_jobs``.
        Sentinel jobs repeat the replication's last arrival time (arrivals
        stay nondecreasing and finite) with ``service=0``, ``need=1``,
        ``cls=0``.  The arrival-ordered scans (FCFS, ModBS) process them
        after every real job, and the event scans (BS, SRPT) never admit
        them (their per-lane ``j_live``); either way the first
        ``num_jobs`` outputs equal the unpadded run's.
        """
        J = self.num_jobs
        if j_max < J:
            raise ValueError(f"cannot pad {J} jobs down to {j_max}")
        if j_max == J:
            return self
        pad = j_max - J
        last = (self.arrival[:, -1:] if J
                else np.zeros((self.reps, 1), self.arrival.dtype))
        return BatchTrace(
            arrival=np.concatenate(
                [self.arrival, np.repeat(last, pad, axis=1)], axis=1),
            cls=np.concatenate(
                [self.cls, np.zeros((self.reps, pad), self.cls.dtype)],
                axis=1),
            service=np.concatenate(
                [self.service,
                 np.zeros((self.reps, pad), self.service.dtype)], axis=1),
            need=np.concatenate(
                [self.need, np.ones((self.reps, pad), self.need.dtype)],
                axis=1),
            k=self.k, C=self.C)

    def chunks(self, chunk_jobs: int):
        """Iterate the batch as consecutive ``chunk_jobs``-sized sub-batches
        (the last may be ragged): the replay form of a stream."""
        if chunk_jobs < 1:
            raise ValueError(f"chunk_jobs must be >= 1, got {chunk_jobs}")
        for pos in range(0, self.num_jobs, chunk_jobs):
            yield self.slice_jobs(pos, min(pos + chunk_jobs, self.num_jobs))

    @classmethod
    def from_arrays(cls, arrival, cls_, service, need, k: int,
                    C: int | None = None) -> "BatchTrace":
        """A batch from plain [R, J] arrays (numpy or anything numpy reads).

        Carries a batch across from another implementation — the JAX
        reference's ``BatchTrace`` fields, a file, a test's hand-built
        trace — so both sides simulate the same data.  The arrays are
        copied into the dtypes this package uses (float64 times, int64
        class ids and needs); nothing aliases the caller's buffers.
        """
        return cls(arrival=np.array(arrival, dtype=np.float64),
                   cls=np.array(cls_, dtype=np.int64),
                   service=np.array(service, dtype=np.float64),
                   need=np.array(need, dtype=np.int64),
                   k=int(k), C=None if C is None else int(C))

    @classmethod
    def from_trace(cls, trace: "Trace", reps: int, seed: int = 0,
                   method: str = "iid", block_len: int | None = None,
                   stream: bool = False) -> "BatchTrace":
        """Bootstrap-resample an empirical trace into ``reps`` replications.

        Jobs are resampled as whole (interarrival gap, class, service,
        need) records and arrivals are the cumulative sum of the resampled
        gaps, so they stay nondecreasing.  ``method="iid"`` draws J
        records independently with replacement; ``method="block"`` is the
        moving-block bootstrap with blocks of ``block_len`` consecutive
        jobs (default ``ceil(J ** (1/3))``).  Replication ``r`` draws from
        ``replication_stream(seed, r)``, the reference's streams, so a
        seed gives the reference's batch bit for bit.

        ``stream=True`` returns a :class:`BootstrapSource` instead: each
        chunk resamples from its own :func:`chunk_stream` substream and
        arrivals continue across chunks, so a log of any length replays
        at constant memory through ``engines.simulate_stream``.
        """
        J = trace.num_jobs
        if J < 1:
            raise ValueError("cannot bootstrap an empty trace")
        if reps < 1:
            raise ValueError("need at least one replication")
        if method not in ("iid", "block"):
            raise ValueError(f"unknown bootstrap method {method!r}; "
                             f"expected 'iid' or 'block'")
        if block_len is None:
            block_len = min(J, max(1, math.ceil(J ** (1.0 / 3.0))))
        elif not 1 <= block_len <= J:
            raise ValueError(f"block_len must be in [1, {J}], "
                             f"got {block_len}")
        if stream:
            return BootstrapSource(trace=trace, reps=reps, seed=seed,
                                   method=method, block_len=block_len)
        gaps = np.diff(trace.arrival, prepend=0.0)
        idx = np.empty((reps, J), dtype=np.int64)
        for r in range(reps):
            rng = np.random.default_rng(replication_stream(seed, r))
            if method == "iid":
                idx[r] = rng.integers(0, J, size=J)
            else:
                n_blocks = -(-J // block_len)
                starts = rng.integers(0, J - block_len + 1, size=n_blocks)
                idx[r] = (starts[:, None]
                          + np.arange(block_len)[None, :]).ravel()[:J]
        return cls(arrival=np.cumsum(gaps[idx], axis=1), cls=trace.cls[idx],
                   service=trace.service[idx], need=trace.need[idx],
                   k=trace.k, C=trace.C)


@dataclasses.dataclass(frozen=True)
class Trace:
    """A concrete job trace (arrival times, classes, service times, needs).

    ``C`` carries the generating workload's class count so per-class metrics
    and partition-backed policies agree on C even when a short trace never
    samples the last class; ``None`` (hand-built traces) falls back to the
    observed maximum.
    """

    arrival: np.ndarray   # float64 [J], nondecreasing
    cls: np.ndarray       # int64   [J]
    service: np.ndarray   # float64 [J]
    need: np.ndarray      # int64   [J]
    k: int
    C: int | None = None  # workload class count (None: derive from cls)

    def __post_init__(self):
        J = len(self.arrival)
        if not (len(self.cls) == len(self.service) == len(self.need) == J):
            raise ValueError("trace arrays must have equal length")

    @property
    def num_jobs(self) -> int:
        return len(self.arrival)

    @property
    def num_classes(self) -> int:
        """Workload C when known, else the observed class count."""
        if self.C is not None:
            return self.C
        return int(self.cls.max()) + 1 if len(self.cls) else 0


# --------------------------------------------------------------------------
# Streaming chunk sources.
#
# A ChunkSource describes an (optionally unbounded) arrival stream as a pure
# function of explicit state, so `engines.simulate_stream` can pull the next
# chunk_jobs jobs at a time and never materialize the full [R, J] batch.
# Every source draws chunk c of replication r from the counter-based Philox
# substream `chunk_stream(seed, r, c)` — prefix stability: the chunks a
# resumed run generates are bit-identical to those a killed run would have
# produced, with no RNG state beyond the chunk index.
# --------------------------------------------------------------------------


class ChunkSource:
    """Base class for streaming chunk generators.

    A source exposes ``reps`` / ``k`` / ``C`` / ``total_jobs`` (``None``
    for an unbounded stream) plus two methods:

    * ``init_state() -> dict[str, np.ndarray]`` — the initial generator
      state, a flat dict of numpy arrays so it rides a checkpoint tree
      through :mod:`repro_torch.checkpoint` unchanged.
    * ``next_chunk(state, n) -> (BatchTrace, state)`` — the next ``n``
      jobs of every replication and the successor state.

    Determinism contract: ``next_chunk`` must be a *pure* function of
    ``(state, n)``.  Generator sources are chunk-size-dependent by design
    (different ``n`` sequences consume the thinning/bulk draws
    differently) but deterministic and prefix-stable for a fixed chunk
    schedule; :class:`TraceReplaySource` is additionally chunk-size
    *invariant* and anchors the bit-identity tests against
    ``engines.simulate``.
    """

    def init_state(self) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def next_chunk(self, state: dict[str, np.ndarray],
                   n: int) -> tuple["BatchTrace", dict[str, np.ndarray]]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TraceReplaySource(ChunkSource):
    """Replay a fully materialized :class:`BatchTrace` chunk by chunk.

    The chunk-size-invariant source: state is just the replay position,
    so any chunk schedule yields the same job sequence — feeding it
    through ``simulate_stream`` is bit-identical to one monolithic
    ``simulate`` call on ``batch``.
    """

    batch: BatchTrace

    @property
    def reps(self) -> int:
        return self.batch.reps

    @property
    def k(self) -> int:
        return self.batch.k

    @property
    def C(self) -> int | None:
        return self.batch.C

    @property
    def total_jobs(self) -> int:
        return self.batch.num_jobs

    def init_state(self) -> dict[str, np.ndarray]:
        return {"pos": np.zeros((), dtype=np.int64)}

    def next_chunk(self, state, n):
        pos = int(state["pos"])
        stop = min(pos + n, self.batch.num_jobs)
        if stop <= pos:
            raise ValueError("trace replay source is exhausted")
        return (self.batch.slice_jobs(pos, stop),
                {"pos": np.asarray(stop, dtype=np.int64)})


def _sample_marks(rng: np.random.Generator, wl: Workload,
                  n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """I.i.d. (class, service, need) marks for ``n`` arrivals of ``wl``.

    Shared by every generator source; the draw order (classes, then
    per-class service fills) matches :meth:`Workload.sample_trace` so the
    mark distribution is identical on both paths.
    """
    cls = rng.choice(wl.C, size=n, p=wl.alphas).astype(np.int64)
    service = np.empty(n)
    for i, c in enumerate(wl.classes):
        mask = cls == i
        service[mask] = c.service.sample(rng, size=int(mask.sum()))
    return cls, service, wl.needs[cls]


@dataclasses.dataclass(frozen=True)
class PoissonSource(ChunkSource):
    """Unbounded stationary Poisson(λ) arrivals with ``wl``'s class mix.

    The streaming counterpart of :meth:`Workload.sample_traces`: same
    marks, but arrivals continue forever — state is the chunk index plus
    each replication's last arrival time.
    """

    wl: Workload
    reps: int
    seed: int = 0

    @property
    def k(self) -> int:
        return self.wl.k

    @property
    def C(self) -> int:
        return self.wl.C

    @property
    def total_jobs(self) -> None:
        return None

    def init_state(self) -> dict[str, np.ndarray]:
        return {"chunk": np.zeros((), dtype=np.int64),
                "t_last": np.zeros(self.reps)}

    def next_chunk(self, state, n):
        chunk = int(state["chunk"])
        t_last = np.asarray(state["t_last"], dtype=np.float64)
        arrival = np.empty((self.reps, n))
        cls = np.empty((self.reps, n), dtype=np.int64)
        service = np.empty((self.reps, n))
        need = np.empty((self.reps, n), dtype=np.int64)
        for r in range(self.reps):
            rng = np.random.default_rng(chunk_stream(self.seed, r, chunk))
            inter = rng.exponential(1.0 / self.wl.lam, size=n)
            arrival[r] = t_last[r] + np.cumsum(inter)
            cls[r], service[r], need[r] = _sample_marks(rng, self.wl, n)
        batch = BatchTrace(arrival=arrival, cls=cls, service=service,
                           need=need, k=self.wl.k, C=self.wl.C)
        return batch, {"chunk": np.asarray(chunk + 1, dtype=np.int64),
                       "t_last": arrival[:, -1].copy()}


class _RateModulatedSource(ChunkSource):
    """Base for time-varying λ(t) sources (Lewis–Shedler thinning).

    Candidate arrivals are drawn homogeneously at ``rate_max`` and kept
    with probability ``rate(t)/rate_max``; truncating at the n-th
    *accepted* arrival and resuming candidates from its timestamp is
    distributionally exact because the candidate process is Poisson
    (memoryless) and the thinning marks are independent.  Subclasses
    provide ``wl``/``reps``/``seed`` fields plus a vectorized ``rate(t)``
    and its finite upper bound ``rate_max``.
    """

    def rate(self, t: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def rate_max(self) -> float:
        raise NotImplementedError

    @property
    def k(self) -> int:
        return self.wl.k

    @property
    def C(self) -> int:
        return self.wl.C

    @property
    def total_jobs(self) -> None:
        return None

    def init_state(self) -> dict[str, np.ndarray]:
        return {"chunk": np.zeros((), dtype=np.int64),
                "t_last": np.zeros(self.reps)}

    def _thin(self, rng: np.random.Generator, t0: float, n: int) -> np.ndarray:
        """First ``n`` accepted arrivals of the thinned process after ``t0``."""
        lam_max = self.rate_max
        accepted = np.empty(0)
        t = t0
        while accepted.size < n:
            m = max(64, 2 * (n - accepted.size))
            cand = t + np.cumsum(rng.exponential(1.0 / lam_max, size=m))
            keep = rng.random(m) * lam_max < self.rate(cand)
            accepted = np.concatenate([accepted, cand[keep]])
            t = cand[-1]
        return accepted[:n]

    def next_chunk(self, state, n):
        chunk = int(state["chunk"])
        t_last = np.asarray(state["t_last"], dtype=np.float64)
        arrival = np.empty((self.reps, n))
        cls = np.empty((self.reps, n), dtype=np.int64)
        service = np.empty((self.reps, n))
        need = np.empty((self.reps, n), dtype=np.int64)
        for r in range(self.reps):
            rng = np.random.default_rng(chunk_stream(self.seed, r, chunk))
            arrival[r] = self._thin(rng, float(t_last[r]), n)
            cls[r], service[r], need[r] = _sample_marks(rng, self.wl, n)
        batch = BatchTrace(arrival=arrival, cls=cls, service=service,
                           need=need, k=self.wl.k, C=self.wl.C)
        return batch, {"chunk": np.asarray(chunk + 1, dtype=np.int64),
                       "t_last": arrival[:, -1].copy()}


@dataclasses.dataclass(frozen=True)
class DiurnalSource(_RateModulatedSource):
    """Sinusoidal diurnal load: λ(t) = λ·(1 + amplitude·sin(2πt/period))."""

    wl: Workload
    reps: int
    seed: int = 0
    period: float = 24.0
    amplitude: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1] so λ(t) >= 0, "
                             f"got {self.amplitude}")
        if self.period <= 0:
            raise ValueError(f"period must be positive, got {self.period}")

    def rate(self, t: np.ndarray) -> np.ndarray:
        return self.wl.lam * (1.0 + self.amplitude
                              * np.sin(2.0 * math.pi * t / self.period))

    @property
    def rate_max(self) -> float:
        return self.wl.lam * (1.0 + self.amplitude)


@dataclasses.dataclass(frozen=True)
class FlashCrowdSource(_RateModulatedSource):
    """Flash crowd: λ(t) = λ·factor on [at, at+duration), else λ."""

    wl: Workload
    reps: int
    seed: int = 0
    at: float = 100.0
    duration: float = 50.0
    factor: float = 3.0

    def __post_init__(self):
        if self.factor <= 0 or self.duration <= 0:
            raise ValueError("factor and duration must be positive")

    def rate(self, t: np.ndarray) -> np.ndarray:
        in_crowd = (t >= self.at) & (t < self.at + self.duration)
        return np.where(in_crowd, self.wl.lam * self.factor, self.wl.lam)

    @property
    def rate_max(self) -> float:
        return self.wl.lam * max(1.0, self.factor)


@dataclasses.dataclass(frozen=True)
class MMPPSource(ChunkSource):
    """Two-phase Markov-modulated Poisson arrivals (bursty load).

    The modulating chain alternates between phases 0 and 1 with
    exponential sojourns of mean ``stay[ph]``; arrivals within a sojourn
    of length d are a Poisson(``rates[ph]``·d) bulk placed at sorted
    uniforms.  Truncating the n-th arrival mid-sojourn and resuming from
    (its timestamp, its phase) is exact: the residual sojourn is
    exponential (memoryless) and the within-sojourn arrival process is
    Poisson, so redrawing both fresh is distributionally identical.
    """

    wl: Workload
    reps: int
    rates: tuple[float, float]
    stay: tuple[float, float] = (10.0, 10.0)
    seed: int = 0

    def __post_init__(self):
        if len(self.rates) != 2 or len(self.stay) != 2:
            raise ValueError("MMPPSource is two-phase: rates and stay "
                             "must each have 2 entries")
        if min(self.rates) < 0 or max(self.rates) <= 0:
            raise ValueError(f"phase rates must be nonnegative with at "
                             f"least one positive, got {self.rates}")
        if min(self.stay) <= 0:
            raise ValueError(f"mean sojourns must be positive, "
                             f"got {self.stay}")

    @property
    def k(self) -> int:
        return self.wl.k

    @property
    def C(self) -> int:
        return self.wl.C

    @property
    def total_jobs(self) -> None:
        return None

    def init_state(self) -> dict[str, np.ndarray]:
        return {"chunk": np.zeros((), dtype=np.int64),
                "t_last": np.zeros(self.reps),
                "phase": np.zeros(self.reps, dtype=np.int64)}

    def next_chunk(self, state, n):
        chunk = int(state["chunk"])
        t_last = np.asarray(state["t_last"], dtype=np.float64)
        phase = np.asarray(state["phase"], dtype=np.int64)
        arrival = np.empty((self.reps, n))
        cls = np.empty((self.reps, n), dtype=np.int64)
        service = np.empty((self.reps, n))
        need = np.empty((self.reps, n), dtype=np.int64)
        new_phase = np.empty(self.reps, dtype=np.int64)
        for r in range(self.reps):
            rng = np.random.default_rng(chunk_stream(self.seed, r, chunk))
            t, ph = float(t_last[r]), int(phase[r])
            times, phases, count = [], [], 0
            while count < n:
                d = rng.exponential(self.stay[ph])
                m = int(rng.poisson(self.rates[ph] * d))
                if m:
                    times.append(t + np.sort(rng.random(m)) * d)
                    phases.append(np.full(m, ph, dtype=np.int64))
                    count += m
                t += d
                ph = 1 - ph
            arrival[r] = np.concatenate(times)[:n]
            new_phase[r] = np.concatenate(phases)[n - 1]
            cls[r], service[r], need[r] = _sample_marks(rng, self.wl, n)
        batch = BatchTrace(arrival=arrival, cls=cls, service=service,
                           need=need, k=self.wl.k, C=self.wl.C)
        return batch, {"chunk": np.asarray(chunk + 1, dtype=np.int64),
                       "t_last": arrival[:, -1].copy(), "phase": new_phase}


@dataclasses.dataclass(frozen=True)
class BootstrapSource(ChunkSource):
    """Unbounded bootstrap replay of an empirical trace.

    The chunked mode of :meth:`BatchTrace.from_trace` (``stream=True``):
    each chunk resamples ``n`` whole (gap, class, service, need) records
    from the underlying trace via the chunk's Philox substream, and
    arrival times continue from the previous chunk's last arrival — an
    SWF log of any length replays at constant memory.  ``method`` /
    ``block_len`` follow :meth:`BatchTrace.from_trace` (blocks never
    straddle a chunk boundary).
    """

    trace: Trace
    reps: int
    seed: int = 0
    method: str = "iid"
    block_len: int | None = None

    def __post_init__(self):
        if self.trace.num_jobs < 1:
            raise ValueError("cannot bootstrap an empty trace")
        if self.reps < 1:
            raise ValueError("need at least one replication")
        if self.method not in ("iid", "block"):
            raise ValueError(f"unknown bootstrap method {self.method!r}; "
                             f"expected 'iid' or 'block'")
        J = self.trace.num_jobs
        if self.block_len is not None and not 1 <= self.block_len <= J:
            raise ValueError(f"block_len must be in [1, {J}], "
                             f"got {self.block_len}")

    @property
    def k(self) -> int:
        return self.trace.k

    @property
    def C(self) -> int | None:
        return self.trace.C

    @property
    def total_jobs(self) -> None:
        return None

    def init_state(self) -> dict[str, np.ndarray]:
        return {"chunk": np.zeros((), dtype=np.int64),
                "t_last": np.zeros(self.reps)}

    def next_chunk(self, state, n):
        chunk = int(state["chunk"])
        t_last = np.asarray(state["t_last"], dtype=np.float64)
        J = self.trace.num_jobs
        bl = self.block_len
        if bl is None:
            bl = min(J, max(1, math.ceil(J ** (1.0 / 3.0))))
        gaps = np.diff(self.trace.arrival, prepend=0.0)
        arrival = np.empty((self.reps, n))
        cls = np.empty((self.reps, n), dtype=np.int64)
        service = np.empty((self.reps, n))
        need = np.empty((self.reps, n), dtype=np.int64)
        for r in range(self.reps):
            rng = np.random.default_rng(chunk_stream(self.seed, r, chunk))
            if self.method == "iid":
                idx = rng.integers(0, J, size=n)
            else:
                n_blocks = -(-n // bl)
                starts = rng.integers(0, J - bl + 1, size=n_blocks)
                idx = (starts[:, None]
                       + np.arange(bl)[None, :]).ravel()[:n]
            arrival[r] = t_last[r] + np.cumsum(gaps[idx])
            cls[r] = self.trace.cls[idx]
            service[r] = self.trace.service[idx]
            need[r] = self.trace.need[idx]
        batch = BatchTrace(arrival=arrival, cls=cls, service=service,
                           need=need, k=self.trace.k, C=self.trace.C)
        return batch, {"chunk": np.asarray(chunk + 1, dtype=np.int64),
                       "t_last": arrival[:, -1].copy()}


# --------------------------------------------------------------------------
# Limiting-regime scalings (paper eqs. 6, 7, 8).
# --------------------------------------------------------------------------


def default_fk(k: int) -> int:
    """The paper's Figure-1 growth rate f_k = floor((k/32)^(2/3)).

    The 1e-9 guard keeps exact powers from flooring down a unit
    ((256/32)^(2/3) evaluates to 3.9999999999999996 in binary fp).
    """
    return max(1, int(math.floor((k / 32.0) ** (2.0 / 3.0) + 1e-9)))


def subcritical_scaling(base_classes: Sequence[JobClass], lam: float, k: int,
                        fk: Callable[[int], int] = default_fk) -> Workload:
    """Eq. (7): λ^(k) = λ k/f_k,  n_i^(k) = n_i f_k,  α, D fixed.

    ``lam`` is the base rate; the resulting load is  ρ = λ ϱ  independent of k.
    """
    f = fk(k)
    classes = tuple(
        dataclasses.replace(c, n=c.n * f) for c in base_classes
    )
    return Workload(k=k, lam=lam * k / f, classes=classes)


def critical_scaling(base_classes: Sequence[JobClass], theta: float, k: int,
                     fk: Callable[[int], int] = default_fk) -> Workload:
    """Eq. (8): Halfin-Whitt.  (1-ρ^(k)) sqrt(k/f_k) -> θ,  n_i^(k) = n_i f_k.

    We set ρ^(k) = 1 - θ sqrt(f_k/k) exactly (the canonical pre-limit choice)
    and solve λ^(k) from eq. (1).
    """
    f = fk(k)
    rho_k = 1.0 - theta * math.sqrt(f / k)
    if rho_k <= 0:
        raise ValueError(f"k={k} too small for theta={theta}")
    classes = tuple(dataclasses.replace(c, n=c.n * f) for c in base_classes)
    demand = sum(c.alpha * c.d * c.n for c in classes)
    lam_k = rho_k * k / demand
    return Workload(k=k, lam=lam_k, classes=classes)


# --------------------------------------------------------------------------
# The paper's workloads.
# --------------------------------------------------------------------------


def figure1_base_classes() -> tuple[JobClass, ...]:
    """Figure-1 workload, expressed at f_k = 1 (base needs).

    Small jobs: prob 0.95, (need, mean) = (1, 1).
    Large jobs: prob 0.05, (need, mean) = (2, 40), (4, 20) or (8, 10) with
    equal probability.  Exponential service times.
    """
    return (
        JobClass("small", 1, Exp(1.0), 0.95),
        JobClass("large-2", 2, Exp(40.0), 0.05 / 3),
        JobClass("large-4", 4, Exp(20.0), 0.05 / 3),
        JobClass("large-8", 8, Exp(10.0), 0.05 / 3),
    )


def figure1_workload(k: int, theta: float = 0.7) -> Workload:
    """The exact Figure-1 cell for a given total server count k."""
    return critical_scaling(figure1_base_classes(), theta, k)


def figure2_workload(k: int, load: float) -> Workload:
    """Figures 2a/2b: same classes as Figure 1 at fixed k, load swept.

    Figure 2 uses constant k (heavy traffic: k fixed, ρ→1; subcritical uses
    the eq.-7 scaling).  Server needs/means as in Figure 1 with f_k as in
    ``default_fk``.
    """
    f = default_fk(k)
    classes = tuple(dataclasses.replace(c, n=c.n * f)
                    for c in figure1_base_classes())
    demand = sum(c.alpha * c.d * c.n for c in classes)
    lam = load * k / demand
    return Workload(k=k, lam=lam, classes=classes)


# --------------------------------------------------------------------------
# The Figure-3 HPC workloads (paper Tables 2 and 3).
# --------------------------------------------------------------------------

# Table 2 — SDSC SP2 log (mean, std, n, alpha), cleaned, needs <= 64.
SDSC_SP2_TABLE = (
    (10519.71, 18267.03, 1, 0.2321),
    (1436.82, 6250.19, 2, 0.1496),
    (5643.69, 18123.70, 4, 0.1624),
    (9248.53, 18468.51, 8, 0.1652),
    (10601.46, 17050.63, 16, 0.1560),
    (12139.59, 22654.86, 32, 0.0807),
    (8302.33, 19074.81, 64, 0.0540),
)

# Table 3 — KIT FH2 log.
KIT_FH2_TABLE = (
    (1845.19, 11440.31, 1, 0.7851),
    (1470.13, 5237.83, 2, 0.0180),
    (11169.87, 38631.83, 4, 0.0406),
    (3167.33, 19727.29, 8, 0.0137),
    (5706.45, 17212.04, 16, 0.0539),
    (60673.08, 92531.56, 32, 0.0493),
    (61343.42, 106094.97, 64, 0.0393),
)


def _table_workload(table, k: int, load: float, dist: str) -> Workload:
    alphas = np.array([row[3] for row in table])
    alphas = alphas / alphas.sum()  # tables are rounded; renormalize
    classes = []
    for (mean, std, n, _), a in zip(table, alphas):
        if dist == "lognormal":
            svc = LogNormal(mean, std)
        elif dist == "exponential":
            svc = Exp(mean)
        else:
            raise ValueError(dist)
        classes.append(JobClass(f"n{n}", n, svc, float(a)))
    wl = Workload(k=k, lam=1.0, classes=tuple(classes))
    return wl.with_load(load)


def sdsc_sp2_workload(k: int = 512, load: float = 0.8,
                      dist: str = "lognormal") -> Workload:
    """Table-2 workload (SDSC SP2).  Service times: lognormal fit of mean/std."""
    return _table_workload(SDSC_SP2_TABLE, k, load, dist)


def kit_fh2_workload(k: int = 512, load: float = 0.8,
                     dist: str = "lognormal") -> Workload:
    """Table-3 workload (KIT FH2)."""
    return _table_workload(KIT_FH2_TABLE, k, load, dist)
