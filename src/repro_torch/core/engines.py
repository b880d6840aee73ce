"""Simulation-engine registry of the port — the single dispatch point.

The port's counterpart of ``repro.core.engines``, with its own registry:
cores register under a ``(policy, engine)`` key and every caller goes
through :func:`simulate` / :func:`simulate_grid`::

    from repro_torch.core import engines
    res = engines.simulate("bs-fcfs", batch, wl=wl)            # on the card
    res = engines.simulate("bs-fcfs", batch, wl=wl, device="cpu")
    res = engines.simulate("msf", batch, engine="python")     # on the host

* **Key**: ``(policy, engine)``; policy names are the reference's
  canonical names (``"fcfs"``, ``"modbs-fcfs"``, ``"bs-fcfs"``,
  ``"sf-srpt"``, ``"ff-srpt"``, ``"serverfilling"``, ``"msf"``, ...) and
  :func:`canonical` resolves the short aliases.  The port has two
  engines:

  - ``"torch"`` (:mod:`repro_torch.kernels.msj_scan.ops`) for the five
    scan policies; its cores dispatch on the device of the tensors they
    build: on ``device="cpu"`` the plain PyTorch versions run, on
    ``device="cuda"`` the hand-written kernels of
    :mod:`repro_torch.kernels.msj_scan`;
  - ``"python"`` (:mod:`repro_torch.core.simulator`), the event-driven
    engine, for all eleven policies of :mod:`repro_torch.core.policies`:
    plain Python and numpy on the host, the oracle of every other core.

  Coverage::

      policy          python   torch (+ grid core)
      fcfs            yes      yes
      modbs-fcfs      yes      yes
      bs-fcfs         yes      yes
      sf-srpt         yes      yes
      ff-srpt         yes      yes
      serverfilling, sf-gittins, msf, lsf, backfill,
      maxweight       yes      --

* **Core**: ``core(batch, *, device, partition=None, wl=None, **kw) ->
  BatchSimResult`` for a ``"torch"`` core; a ``"python"`` core takes no
  ``device``.  Cores do not mutate the batch.
* **Determinism**: on a fixed batch every core returns the result of the
  reference's engines bit for bit (rtol=0), on either device, and so
  every ``"torch"`` core equals the ``"python"`` core of its policy.
* **Device**: :data:`DEVICE_ENGINES` run on the card by default.
  ``device="cuda"`` without a CUDA device raises ``RuntimeError``;
  nothing falls back to the CPU quietly.  The device is resolved only
  for those engines: a caller who names ``engine="python"`` asked for the
  host oracle, and ``device`` is ignored there.
* **Fallback**: :func:`simulate` / :func:`simulate_grid` take
  ``fallback=True`` to run a policy that has no ``"torch"`` core (the
  event-engine-only six) on ``"python"`` instead of raising, announced
  by a once-per-process ``RuntimeWarning`` (:func:`warn_fallback`).  A
  policy that has a ``"torch"`` core never goes to the event engine: not
  on a failed kernel build, not on a missing card.
* **Registration**: cores self-register when their provider module is
  imported, lazily on first dispatch (``_PROVIDERS``).  Double
  registration of a key is an error.  This registry is separate from the
  reference's: the port registers nothing there.

* **Failures**: ``failures=`` takes a drain-mode
  :class:`~repro_torch.core.failures.FailureBatch` for ``fcfs``,
  ``modbs-fcfs`` and ``bs-fcfs``: the outages are merged into the event
  stream on the host and the ``*_fail_scan`` kernels (or their plain
  versions) run it; the result grows the ``kills``/``requeues``/
  ``availability`` observables; ``engine="python"`` runs the same
  streams through its per-replication loops.  ``mode="kill"``
  (kill-and-requeue, BS-π repartitioned on every capacity change) runs
  on ``engine="python"`` for every policy; the ``"torch"`` cores raise
  ``NotImplementedError`` on it, as on ``failures=`` for the SRPT pair.

* **Grids**: :func:`simulate_grid` takes a sequence of :class:`GridCell`
  s — each a batch with its own k, J, partition and failures — and runs
  the policy's grid core (:func:`register_grid`), which stacks every cell
  onto one (cells x reps) lane axis and makes one wrapper call: one kernel
  launch per policy per grid on the card.  Cell g of the result equals
  ``simulate(policy, cells[g].batch, ...)`` and the reference's grid cell
  g bit for bit.  An engine with no grid core (``"python"``) runs the
  cells one by one behind the same call.

* **Streams**: :func:`simulate_stream` runs ``fcfs``, ``modbs-fcfs`` and
  ``bs-fcfs`` over a :class:`~repro_torch.core.workload.ChunkSource`
  chunk by chunk (:func:`register_stream` cores, one carried kernel
  launch per chunk on the card) at memory independent of the stream's
  length, and checkpoints after every chunk with ``ckpt_dir=``; on a
  replayed batch it equals ``stream_fold(simulate(...))`` bit for bit.
  ``"torch"`` is the only streaming engine.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids import cycles
    from .sim_batch import BatchSimResult
    from .workload import BatchTrace

#: modules whose import registers engine cores
_PROVIDERS = ("repro_torch.core.simulator",        # engine="python"
              "repro_torch.kernels.msj_scan.ops")  # engine="torch"

#: engines whose cores run on a device and take ``device=``
DEVICE_ENGINES = ("torch",)

_REGISTRY: dict[tuple[str, str], Callable[..., "BatchSimResult"]] = {}

#: grid cores take a sequence of GridCells and return one BatchSimResult
#: per cell — a distinct signature, so a registry of their own
_GRID_REGISTRY: dict[tuple[str, str], Callable[..., list]] = {}

#: stream cores take a ChunkSource and return a StreamResult — a distinct
#: signature again, so a registry of their own
_STREAM_REGISTRY: dict[tuple[str, str], Callable] = {}

#: short CLI aliases -> canonical policy names
ALIASES = {
    "bs": "bs-fcfs", "balanced-splitting": "bs-fcfs",
    "modbs": "modbs-fcfs", "modified-bs": "modbs-fcfs",
}

def canonical(policy: str) -> str:
    """Resolve a short policy alias to its canonical name."""
    return ALIASES.get(policy, policy)


def register(policy: str, engine: str):
    """Decorator: register a simulation core under ``(policy, engine)``."""
    def deco(fn: Callable[..., "BatchSimResult"]):
        key = (policy, engine)
        if key in _REGISTRY:
            raise ValueError(f"engine core {key} registered twice")
        _REGISTRY[key] = fn
        return fn
    return deco


def register_grid(policy: str, engine: str):
    """Decorator: register a grid core under ``(policy, engine)``.

    A grid core is ``core(cells, *, device) -> list[BatchSimResult]``:
    ``cells`` a tuple of validated :class:`GridCell` s of one ``reps``
    and one failure axis, the list index-aligned with it, cell g equal
    bit for bit to ``simulate(policy, cells[g].batch, engine=engine,
    ...)``.
    """
    def deco(fn: Callable[..., list]):
        key = (policy, engine)
        if key in _GRID_REGISTRY:
            raise ValueError(f"grid core {key} registered twice")
        _GRID_REGISTRY[key] = fn
        return fn
    return deco


def register_stream(policy: str, engine: str):
    """Decorator: register a streaming core under ``(policy, engine)``.

    A stream core is ``core(source, *, device, chunk_jobs, total_jobs,
    partition=None, wl=None, policy, **kw) -> StreamResult``: it pulls
    per-chunk batches from a
    :class:`~repro_torch.core.workload.ChunkSource` and folds the
    observables online, never holding the whole [R, J] batch.
    """
    def deco(fn: Callable):
        key = (policy, engine)
        if key in _STREAM_REGISTRY:
            raise ValueError(f"stream core {key} registered twice")
        _STREAM_REGISTRY[key] = fn
        return fn
    return deco


def _ensure_registered() -> None:
    for mod in _PROVIDERS:
        importlib.import_module(mod)


def registered() -> tuple[tuple[str, str], ...]:
    """All registered ``(policy, engine)`` keys, sorted."""
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def available_engines() -> tuple[str, ...]:
    """All engine names with at least one registered core, sorted."""
    return tuple(sorted({e for _, e in registered()}))


def engines_for(policy: str) -> tuple[str, ...]:
    """Engines registered for a policy (canonicalized), sorted."""
    pol = canonical(policy)
    return tuple(sorted(e for p, e in registered() if p == pol))


def grid_registered() -> tuple[tuple[str, str], ...]:
    """All registered grid ``(policy, engine)`` keys, sorted."""
    _ensure_registered()
    return tuple(sorted(_GRID_REGISTRY))


def grid_engines_for(policy: str) -> tuple[str, ...]:
    """Engines with a grid core for a policy (canonicalized), sorted."""
    pol = canonical(policy)
    return tuple(sorted(e for p, e in grid_registered() if p == pol))


def stream_registered() -> tuple[tuple[str, str], ...]:
    """All registered streaming ``(policy, engine)`` keys, sorted."""
    _ensure_registered()
    return tuple(sorted(_STREAM_REGISTRY))


def stream_engines_for(policy: str) -> tuple[str, ...]:
    """Engines with a streaming core for a policy (canonicalized), sorted."""
    pol = canonical(policy)
    return tuple(sorted(e for p, e in stream_registered() if p == pol))


def get_stream(policy: str, engine: str) -> Callable:
    """The registered streaming core for ``(policy, engine)``.

    A policy that streams under another engine -> ``ValueError`` naming
    the engines that do; a policy with no streaming core (the SRPT pair)
    -> ``KeyError``.
    """
    _ensure_registered()
    pol = canonical(policy)
    core = _STREAM_REGISTRY.get((pol, engine))
    if core is not None:
        return core
    streaming = stream_engines_for(pol)
    if streaming:
        raise ValueError(
            f"engine {engine!r} has no streaming core for policy {pol!r}; "
            f"streaming engines: {list(streaming)}")
    raise KeyError(
        f"no streaming core for policy {policy!r}; registered streaming "
        f"policies: {sorted({p for p, _ in _STREAM_REGISTRY})}")


def policies_for(engine: str) -> tuple[str, ...]:
    """Policies registered for an engine, sorted."""
    return tuple(sorted(p for p, e in registered() if e == engine))


def get(policy: str, engine: str) -> Callable[..., "BatchSimResult"]:
    """The registered core for ``(policy, engine)``.

    Unknown policy -> ``KeyError``; known policy under an unknown engine
    -> ``ValueError``.
    """
    _ensure_registered()
    pol = canonical(policy)
    core = _REGISTRY.get((pol, engine))
    if core is not None:
        return core
    if not engines_for(pol):
        raise KeyError(f"no simulation core for policy {policy!r}; "
                       f"registered policies: "
                       f"{sorted({p for p, _ in _REGISTRY})}")
    raise ValueError(f"unknown engine {engine!r} for policy {pol!r}; "
                     f"registered engines: {list(engines_for(pol))}")


#: (policy, engine) pairs that already emitted their fallback warning —
#: one RuntimeWarning per process per pair, not one per batch
_WARNED_FALLBACKS: set[tuple[str, str]] = set()


def warn_fallback(policy: str, engine: str) -> None:
    """Once-per-process ``RuntimeWarning`` for an event-engine fallback.

    The event engine is orders of magnitude slower than the kernels, so a
    sweep that quietly sends a policy there can take hours without anyone
    seeing why.  Every dispatch site that substitutes ``engine="python"``
    for a policy with no core under the requested engine announces it
    here.
    """
    import warnings
    key = (canonical(policy), engine)
    if key in _WARNED_FALLBACKS:
        return
    _WARNED_FALLBACKS.add(key)
    warnings.warn(
        f"policy {key[0]!r} has no engine {engine!r} core — falling back "
        f"to the python event oracle (orders of magnitude slower); "
        f"registered engines for this policy: {list(engines_for(key[0]))}",
        RuntimeWarning, stacklevel=3)


def _resolve_fallback(policy: str, engine: str, fallback: bool) -> str:
    """The engine to dispatch: ``"python"`` for a policy with no
    ``"torch"`` core when ``fallback`` allows it, else ``engine``."""
    pol = canonical(policy)
    if not fallback or engine == "python" or (pol, "torch") in registered():
        return engine
    get(pol, "python")  # unknown policy stays a loud KeyError
    warn_fallback(pol, engine)
    return "python"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it cannot run.

    ``"cuda"`` without a CUDA device is a ``RuntimeError`` — the port never
    moves a run the caller put on the card to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         f"or 'cpu'")
    return dev


def validate_batch(batch: "BatchTrace", *, partition=None,
                   failures=None) -> None:
    """Loud input validation shared by every core.

    Malformed batches are rejected before dispatch with a ``ValueError``
    naming the first offending replication, as in the reference; the port
    also rejects needs above k, which the kernels could not host.  A
    failure batch must match the batch's k and replication count.
    """
    def _first_bad(mask) -> int:
        return int(np.argmax(mask.any(axis=1)))

    if np.isnan(batch.arrival).any():
        raise ValueError("batch.arrival contains NaN (first bad replication "
                         f"{_first_bad(np.isnan(batch.arrival))})")
    if np.isnan(batch.service).any():
        raise ValueError("batch.service contains NaN (first bad replication "
                         f"{_first_bad(np.isnan(batch.service))})")
    gaps = np.diff(batch.arrival, axis=1)
    if batch.arrival.size and (batch.arrival[:, 0] < 0).any():
        raise ValueError("negative arrival times (first bad replication "
                         f"{int(np.argmax(batch.arrival[:, 0] < 0))})")
    if (gaps < 0).any():
        raise ValueError("arrival times are not nondecreasing along the job "
                         f"axis (first bad replication {_first_bad(gaps < 0)})")
    if (batch.service < 0).any():
        raise ValueError("negative service times (first bad replication "
                         f"{_first_bad(batch.service < 0)})")
    if (batch.need < 1).any():
        raise ValueError("server needs must be >= 1 (first bad replication "
                         f"{_first_bad(batch.need < 1)})")
    if (batch.need > batch.k).any():
        raise ValueError(f"server needs must be <= k={batch.k} (first bad "
                         f"replication {_first_bad(batch.need > batch.k)})")
    if partition is not None:
        C = partition.C
        bad = (batch.cls < 0) | (batch.cls >= C)
        if bad.any():
            raise ValueError(
                f"class ids outside the partition's [0, {C}) range (first "
                f"bad replication {_first_bad(bad)})")
    if failures is not None:
        if getattr(failures, "k", batch.k) != batch.k:
            raise ValueError(f"failures.k={failures.k} != batch.k={batch.k}")
        if getattr(failures, "reps", batch.reps) != batch.reps:
            raise ValueError(f"failures.reps={failures.reps} != "
                             f"batch.reps={batch.reps}")


def simulate(policy: str, batch: "BatchTrace", *, engine: str = "torch",
             device="cuda", partition=None, wl=None, failures=None,
             fallback: bool = False, **kw) -> "BatchSimResult":
    """Run ``batch`` through the registered ``(policy, engine)`` core.

    ``device`` is where a ``"torch"`` core runs: ``"cuda"`` (the default)
    launches the hand-written kernels and raises without a card,
    ``"cpu"`` runs their plain PyTorch versions; ``engine="python"`` runs
    on the host and ignores it.  ``partition``/``wl`` feed the eq.-2
    partition (ModBS and BS need one of them); extra keywords (e.g.
    ``queue_cap`` for ``bs-fcfs`` and the SRPT pair) pass through to the
    core.  ``failures`` is a ``FailureBatch`` of the batch's k and
    replication count: ``mode="drain"`` for ``fcfs``, ``modbs-fcfs`` and
    ``bs-fcfs`` on either engine, ``mode="kill"`` for every policy on
    ``"python"``.  ``fallback=True`` runs a policy with no ``"torch"``
    core on ``"python"`` with a once-per-process ``RuntimeWarning``.
    """
    engine = _resolve_fallback(policy, engine, fallback)
    core = get(policy, engine)
    dev = resolve_device(device) if engine in DEVICE_ENGINES else None
    validate_batch(batch, partition=partition,
                   failures=failures if hasattr(failures, "k") else None)
    if dev is not None:
        kw["device"] = dev
    return core(batch, partition=partition, wl=wl, failures=failures, **kw)


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One cell of a simulation grid: a batch plus its per-cell context.

    ``partition``/``wl`` feed the eq.-2 partition as the matching
    :func:`simulate` keywords would; ``failures`` injects the cell's
    drain-mode ``FailureBatch``; ``queue_cap`` bounds the BS-FCFS
    helper-wait rings (``None`` = the default ``min(J, 8192)``).
    """

    batch: "BatchTrace"
    partition: object = None
    wl: object = None
    failures: object = None
    queue_cap: int | None = None


def simulate_grid(policy: str, cells: Sequence[GridCell], *,
                  engine: str = "torch", device="cuda",
                  fallback: bool = False) -> list:
    """Run every grid cell under one policy; one ``BatchSimResult`` each.

    The policy's grid core stacks the cells onto one (cells x reps) lane
    axis and makes one wrapper call, so on the card a grid is one kernel
    launch however many (k, load) cells it has; cell ``g`` of the result
    equals ``simulate(policy, cells[g].batch, ...)`` bit for bit.  An
    engine with no grid core (``"python"``) runs the cells one by one,
    with the same results.  Every cell must have the same ``reps``, and
    failures are all-or-none across cells, as in the reference.
    ``device`` and ``fallback`` act as in :func:`simulate`.
    """
    cells = tuple(cells)
    if not cells:
        raise ValueError("simulate_grid needs at least one cell")
    engine = _resolve_fallback(policy, engine, fallback)
    core = get(policy, engine)  # loud unknown-policy/engine errors first
    dev = resolve_device(device) if engine in DEVICE_ENGINES else None
    R = cells[0].batch.reps
    for g, cell in enumerate(cells):
        if cell.batch.reps != R:
            raise ValueError(
                f"grid cells must share one replication count; cell {g} "
                f"has reps={cell.batch.reps}, cell 0 has reps={R}")
        fb = cell.failures
        try:
            validate_batch(cell.batch, partition=cell.partition,
                           failures=fb if hasattr(fb, "k") else None)
        except ValueError as e:
            raise ValueError(f"grid cell {g}: {e}") from None
    if sum(c.failures is not None for c in cells) not in (0, len(cells)):
        raise ValueError(
            "mixed failure/no-failure cells in one grid — split into one "
            "simulate_grid call per failure axis")
    grid_core = _GRID_REGISTRY.get((canonical(policy), engine))
    if grid_core is not None:
        return grid_core(cells, device=dev)
    out = []
    for cell in cells:
        kw = {} if cell.queue_cap is None else {"queue_cap": cell.queue_cap}
        out.append(core(cell.batch, partition=cell.partition, wl=cell.wl,
                        failures=cell.failures, **kw))
    return out


def simulate_stream(policy: str, source, *, engine: str = "torch",
                    device="cuda", chunk_jobs: int,
                    total_jobs: int | None = None, partition=None, wl=None,
                    **kw):
    """Stream ``source`` through the ``(policy, engine)`` chunked core.

    The constant-memory counterpart of :func:`simulate`: the simulation
    is a sequence of ``chunk_jobs``-sized chunk scans, each resumed from
    the previous chunk's carry, with the observables (running mean and M2
    of response and wait, the queueing / helper / routing counts) folded
    into an accumulator, so memory is O(R · chunk_jobs) whatever the
    stream's length.  Returns a
    :class:`~repro_torch.core.stream.StreamResult`.

    ``source`` is a :class:`~repro_torch.core.workload.ChunkSource` —
    replayed (:class:`~repro_torch.core.workload.TraceReplaySource`, or a
    bare ``BatchTrace``, wrapped in one), bootstrapped
    (``BatchTrace.from_trace(..., stream=True)``) or generated
    (``PoissonSource``, ``DiurnalSource``, ``FlashCrowdSource``,
    ``MMPPSource``).  ``total_jobs`` bounds an unbounded source (required
    there; a finite one defaults to its ``total_jobs``).

    ``device="cuda"`` (the default) launches the carried kernels, one a
    chunk, and raises without a card; ``device="cpu"`` runs their plain
    versions.  On a replayed batch the result equals
    ``stream_fold(simulate(policy, batch, ...))`` bit for bit for every
    chunk size, on either device.

    ``ckpt_dir=`` saves the carry, the accumulator and the source's state
    after every chunk (:mod:`repro_torch.checkpoint`); ``resume=True``
    restores the latest chunk and goes on, and fails loudly if the
    stream's layout (``chunk_jobs``, ``reps``, ``k``, policy, ...)
    changed since.  The carries are device-independent, so a stream
    checkpointed on the CPU resumes on the card bit for bit.  Other
    keywords (``queue_cap``, ``backlog_cap``, ``block``) pass through to
    the core.
    """
    from .workload import BatchTrace, TraceReplaySource

    if isinstance(source, BatchTrace):
        source = TraceReplaySource(source)
    core = get_stream(policy, engine)
    dev = resolve_device(device)
    if chunk_jobs < 1:
        raise ValueError(f"chunk_jobs must be >= 1, got {chunk_jobs}")
    if total_jobs is None:
        total_jobs = source.total_jobs
    if total_jobs is None:
        raise ValueError(
            "total_jobs is required for an unbounded source "
            f"({type(source).__name__} has source.total_jobs=None)")
    if total_jobs < 1:
        raise ValueError(f"total_jobs must be >= 1, got {total_jobs}")
    return core(source, device=dev, chunk_jobs=chunk_jobs,
                total_jobs=total_jobs, partition=partition, wl=wl,
                policy=policy, **kw)
