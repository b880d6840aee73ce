"""Erlang-B (M/GI/s/s) machinery — paper §4.1.

The port's copy of ``repro.core.erlang``.  The Erlang loss formula
(eq. 3) is insensitive to the service distribution beyond its mean, which
is why the paper can treat general D_i.  Implemented:

* ``erlang_b``          — numerically stable recursion (works for s ~ 1e7)
* ``erlang_b_array``    — the full vector E_1..E_s (used by theory plots)
* ``mean_response``     — eq. (4):  R_s = d (1 - E_s(λd))
* ``halfin_whitt_limit``— Lemma 1:  lim √s E_s = φ(θ)/Φ(θ)

The numpy half runs the reference's float operations in the reference's
order, so every value equals the reference's.  ``erlang_b_torch`` (the
reference's ``erlang_b_jnp``) runs the same recursion on a float64 tensor
of loads, on the tensor's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

try:  # scipy is available in this environment; keep a fallback anyway.
    from scipy.stats import norm as _norm

    def _phi(x):
        return _norm.pdf(x)

    def _Phi(x):
        return _norm.cdf(x)
except Exception:  # pragma: no cover
    def _phi(x):
        return math.exp(-x * x / 2.0) / math.sqrt(2.0 * math.pi)

    def _Phi(x):
        return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def erlang_b(s: int, offered_load: float) -> float:
    """Blocking probability E_s(a) of an M/GI/s/s queue with offered load a=λd.

    Uses the standard recursion  E_0 = 1,  E_s = a E_{s-1} / (s + a E_{s-1}),
    which is numerically stable for any s (no factorials).
    """
    if s < 0:
        raise ValueError("s must be >= 0")
    a = float(offered_load)
    if a < 0:
        raise ValueError("offered load must be >= 0")
    if a == 0.0:
        return 0.0 if s > 0 else 1.0
    # The direct recursion is stable; E_s may underflow double for large s
    # (fine: it IS ~0 there).
    e = 1.0
    for j in range(1, s + 1):
        e = a * e / (j + a * e)
    return e


def erlang_b_array(s: int, offered_load: float) -> np.ndarray:
    """[E_0, E_1, ..., E_s] via the recursion (vector version)."""
    a = float(offered_load)
    out = np.empty(s + 1)
    out[0] = 1.0
    e = 1.0
    for j in range(1, s + 1):
        e = a * e / (j + a * e)
        out[j] = e
    return out


def erlang_b_log(s: int, offered_load: float) -> float:
    """log E_s(a) — useful when E underflows (subcritical, large s)."""
    a = float(offered_load)
    if a <= 0:
        return -math.inf if s > 0 else 0.0
    log_e = 0.0  # log E_0
    for j in range(1, s + 1):
        # E_j = a E_{j-1} / (j + a E_{j-1})
        #   log E_j = log a + log E_{j-1} - log(j + a E_{j-1})
        log_ae = math.log(a) + log_e
        # log(j + exp(log_ae)) computed stably:
        m = max(math.log(j), log_ae)
        log_den = m + math.log(math.exp(math.log(j) - m) + math.exp(log_ae - m))
        log_e = log_ae - log_den
    return log_e


def mean_response(s: int, lam: float, d: float) -> float:
    """Eq. (4):  R_s = d (1 - E_s(λ d)) — mean response time of M/GI/s/s.

    (Blocked jobs contribute 0; accepted jobs take exactly their service
    time since there is no queueing in a loss system.)
    """
    return d * (1.0 - erlang_b(s, lam * d))


def halfin_whitt_limit(theta: float) -> float:
    """Lemma 1:  lim_{s→∞} √s · E_s(λd) = φ(θ)/Φ(θ)  when (1-ρ)√s → θ."""
    return float(_phi(theta) / _Phi(theta))


def erlang_b_torch(s: int, offered_load, *, device=None) -> torch.Tensor:
    """E_s of every offered load in ``offered_load``, as a float64 tensor.

    The recursion of :func:`erlang_b` elementwise (E_0 = 1), so each entry
    equals ``erlang_b(s, a)`` bit for bit for a > 0 (a = 0 gives 0 here,
    as the reference's ``erlang_b_jnp`` does, and 1 at s = 0).  A tensor
    stays on its device unless ``device`` is given; anything else
    (a Python or numpy number or array) goes to the card unless
    ``device="cpu"``.  ``device="cuda"`` without a card raises.
    """
    from .engines import resolve_device

    if device is None:
        device = (offered_load.device if isinstance(offered_load, torch.Tensor)
                  else "cuda")
    a = torch.as_tensor(offered_load, dtype=torch.float64,
                        device=resolve_device(device))
    e = torch.ones_like(a)
    for j in range(1, s + 1):
        e = a * e / (j + a * e)
    return e
