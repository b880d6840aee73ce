"""Device timing and per-phase stamps for the port's bench scripts.

* :func:`device_ms` — a call's device time, queued behind a sleep kernel
  (``chip_smoke.py``, :mod:`.srpt_bench`, :mod:`.decode_timeline`);
* :func:`insert_at` — a copy of a kernel's source with stamping code put
  in beside a named line, so a bench script builds a stamped copy of a
  kernel and the kernel itself carries no stamps (:mod:`.srpt_bench`
  ``--phases``, :mod:`.decode_timeline`).

Card only at call time; nothing here touches the card at import.
"""

from __future__ import annotations

import time


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    call: CUDA events around the calls, all queued behind a sleep kernel
    that outlasts their enqueueing, so the card runs them back to back and
    the host's time per call (Python, allocation, launch) is not read as
    the kernels' (where one call takes longer to enqueue than to run, the
    events would otherwise time the host)."""
    import torch

    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.2, 2.0 * reps * host_s + 1e-3) * 2e9))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def insert_at(text: str, line: str, code: str, *, before: bool = False,
              start: int = 0, source: str = "the source") -> str:
    """``text`` with ``code`` inserted after (``before``: before) the first
    occurrence of ``line`` at or after offset ``start``; raises
    ``RuntimeError`` if ``line`` is not there, so a stamp never lands
    somewhere the kernel has moved away from."""
    i = text.find(line, start)
    if i < 0:
        raise RuntimeError(f"line not found in {source}: {line!r}")
    j = i if before else i + len(line)
    return text[:j] + code + text[j:]
