"""The port's Erlang-B machinery (``repro_torch.core.erlang``) against the
reference's (``repro.core.erlang``).

The numpy functions run the reference's float operations in its order, so
every value must be equal (``==``), on ``tests/test_erlang.py``'s (s, a)
cases and on a grid up to s = 10 000.  ``erlang_b_torch`` runs the same
recursion on a float64 tensor: equal to ``erlang_b`` bit for bit (a > 0),
and within rel 1e-12 of the reference's ``erlang_b_jnp`` under x64.
"""

import math

import numpy as np
import pytest
import torch

from _torch_jaxref import x64  # the reference's x64 alias
from repro.core import erlang as ref

from repro_torch.core import erlang

CASES = [(1, 0.5), (4, 2.0), (10, 9.0), (20, 25.0)]
GRID_S = [0, 1, 2, 7, 64, 500, 2048, 10_000]
GRID_A = [0.0, 0.3, 5.0, 480.0, 2000.0, 9_950.0, 12_000.0]


def _same(x, y):
    return x == y or (math.isnan(x) and math.isnan(y))


def _check_all(s, a):
    assert _same(erlang.erlang_b(s, a), ref.erlang_b(s, a)), (s, a)
    assert np.array_equal(erlang.erlang_b_array(s, a),
                          ref.erlang_b_array(s, a)), (s, a)
    assert _same(erlang.erlang_b_log(s, a), ref.erlang_b_log(s, a)), (s, a)
    assert _same(erlang.mean_response(s, a / 2.0, 2.0),
                 ref.mean_response(s, a / 2.0, 2.0)), (s, a)


@pytest.mark.parametrize("s,a", CASES)
def test_numpy_functions_equal_reference_on_its_cases(s, a):
    _check_all(s, a)


@pytest.mark.parametrize("s", GRID_S)
def test_numpy_functions_equal_reference_on_a_grid(s):
    for a in GRID_A:
        _check_all(s, a)


@pytest.mark.parametrize("theta", [0.05, 0.7, 1.0, 3.0])
def test_halfin_whitt_limit_equals_reference(theta):
    assert erlang.halfin_whitt_limit(theta) == ref.halfin_whitt_limit(theta)


def test_bad_arguments_raise_as_the_reference_does():
    for fn in (erlang.erlang_b, ref.erlang_b):
        with pytest.raises(ValueError, match="s must be >= 0"):
            fn(-1, 2.0)
        with pytest.raises(ValueError, match="offered load"):
            fn(3, -1.0)


@pytest.mark.parametrize("s", [1, 10, 64, 2048])
def test_erlang_b_torch_is_the_recursion_bit_for_bit(s):
    loads = [0.3, 5.0, 50.0, 480.0, 2000.0, 9_950.0]
    e = erlang.erlang_b_torch(s, loads, device="cpu")
    assert e.dtype == torch.float64 and e.device.type == "cpu"
    assert e.tolist() == [erlang.erlang_b(s, a) for a in loads]
    with x64():
        want = [float(ref.erlang_b_jnp(s, a)) for a in loads]
    np.testing.assert_allclose(e.numpy(), want, rtol=1e-12, atol=0)


def test_erlang_b_torch_devices():
    """A CPU tensor stays on the CPU; a Python number goes to the card
    unless ``device="cpu"`` (and raises where there is none)."""
    t = torch.tensor([8.0, 0.0], dtype=torch.float64)
    e = erlang.erlang_b_torch(10, t)
    assert e.device.type == "cpu"
    assert e.tolist() == [erlang.erlang_b(10, 8.0), 0.0]
    assert erlang.erlang_b_torch(0, 3.0, device="cpu").item() == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            erlang.erlang_b_torch(10, 8.0)


def test_lemma1_halfin_whitt_convergence():
    """√s·E_s(λd) -> φ(θ)/Φ(θ) under (1-ρ)√s -> θ (``test_erlang.py``'s
    check, on the port)."""
    theta = 0.7
    limit = erlang.halfin_whitt_limit(theta)
    errs = []
    for s in (100, 1000, 10000):
        a = s * (1 - theta / math.sqrt(s))
        errs.append(abs(math.sqrt(s) * erlang.erlang_b(s, a) - limit))
    assert errs[-1] < errs[0]
    assert errs[-1] < 0.02 * limit
