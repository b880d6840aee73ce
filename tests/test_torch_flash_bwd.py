"""The flash-attention backward's plain version against the JAX reference.

The reference trains through ``repro.models.layers.flash_attention``,
whose custom VJP ``_flash_bwd`` recomputes the probability tiles from
(q, k, v, out, lse).  On this CPU the port's ``flash_attention_bwd`` runs
its plain version, ``flash_attention_bwd_ref``, and
``models.layers.flash_attention`` under autograd goes through the
``FlashAttention`` Function, whose forward is the forward wrapper with its
lse and whose backward is that wrapper.  Each is held, on the same inputs
made with numpy, to ``jax.vjp`` of the reference's function, and the lse
to ``_flash_fwd_impl``'s, at ``tests/test_kernels.py``'s tolerances:
float32 2e-5 (its custom-VJP test's), bfloat16 2e-2 (atol = rtol).
Shapes: causal and non-causal, G = H / Kh in {1, 4, 9}, (D, Dv) in
{(32, 32), (80, 80), (192, 128)} (80: stablelm-3b; 192 / 128: MLA), and
non-causal Sq != Sk.  The CUDA kernel is held to the same plain version on
the card by ``chip_smoke.py`` and ``tests/test_torch_card.py``.
"""

import numpy as np
import pytest
import torch

import _torch_jaxref  # noqa: F401  (the R1 alias, before any repro import)

import jax
import jax.numpy as jnp
from repro.models import layers as ref_layers

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_fwd)
from repro_torch.models import layers

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CHUNK = 32

# (B, Sq, Sk, H, Kh, D, Dv, causal)
SHAPES = [
    (2, 64, 64, 4, 4, 32, 32, True),        # G 1
    (2, 64, 64, 4, 4, 32, 32, False),
    (1, 96, 96, 8, 2, 80, 80, True),        # G 4, stablelm-3b's head dim
    (1, 64, 128, 8, 2, 80, 80, False),      # Sq != Sk
    (1, 64, 64, 9, 1, 32, 32, True),        # G 9 (starcoder2-7b's group)
    (1, 32, 96, 9, 1, 32, 32, False),
    (1, 64, 64, 2, 2, 192, 128, True),      # MLA's D 192 / Dv 128
    (1, 32, 64, 4, 1, 192, 128, False),
]


def _both(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _close(port, ref, dtype):
    tol = TOLS[dtype]
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _reference(jq, jk, jv, jdo, causal):
    """(out, lse, (dq, dk, dv)) of the reference's model attention."""
    def f(q, k, v):
        return ref_layers.flash_attention(q, k, v, causal=causal,
                                          chunk_q=CHUNK, chunk_k=CHUNK)
    out, vjp = jax.vjp(f, jq, jk, jv)
    _, lse = ref_layers._flash_fwd_impl((causal, CHUNK, CHUNK, 0), jq, jk,
                                        jv)
    return out, lse, vjp(jdo)


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,Dv,causal", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_matches_reference_vjp(B, Sq, Sk, H, Kh, D, Dv,
                                              causal, dtype, rng):
    jq, q = _both(rng, (B, Sq, H, D), dtype)
    jk, k = _both(rng, (B, Sk, Kh, D), dtype)
    jv, v = _both(rng, (B, Sk, Kh, Dv), dtype)
    jdo, do = _both(rng, (B, Sq, H, Dv), dtype)
    r_out, r_lse, r_grads = _reference(jq, jk, jv, jdo, causal)

    # the wrappers: forward with its lse, then the backward
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    _close(out, r_out, dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), atol=2e-5,
                               rtol=2e-5)
    grads = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for g, t, r in zip(grads, (q, k, v), r_grads):
        assert g.shape == t.shape and g.dtype == t.dtype
        _close(g, r, dtype)

    # the model's entry point under autograd: the Function, whose backward
    # is the same wrapper on the same saved tensors
    launches = flash_attention_bwd.launches
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    oa = layers.flash_attention(qa, ka, va, causal=causal, chunk_q=CHUNK,
                                chunk_k=CHUNK)
    assert oa.grad_fn is not None
    oa.backward(do)
    for t, g in zip((qa, ka, va), grads):
        assert torch.equal(t.grad, g)
    assert flash_attention_bwd.launches == launches   # the CPU launches none


def test_backward_plain_version_is_autograd_of_the_plain_forward(rng):
    """``flash_attention_bwd_ref`` equals torch autograd through the plain
    forward in float32 (the same function, differentiated two ways)."""
    B, Sq, Sk, H, Kh, D, Dv = 2, 40, 40, 6, 2, 16, 8
    for causal in (True, False):
        _, q = _both(rng, (B, Sq, H, D), "float32")
        _, k = _both(rng, (B, Sk, Kh, D), "float32")
        _, v = _both(rng, (B, Sk, Kh, Dv), "float32")
        _, do = _both(rng, (B, Sq, H, Dv), "float32")
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     return_lse=True)
        got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(
            flash_attention_fwd(*leaves, causal=causal), leaves, do)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_backward_checks_its_inputs(rng):
    _, q = _both(rng, (1, 16, 2, 8), "float32")
    _, k = _both(rng, (1, 16, 2, 8), "float32")
    o, lse = flash_attention_fwd(q, k, k, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, k, o, lse[:, :, :8].contiguous(), o)
    with pytest.raises(ValueError, match="do"):
        flash_attention_bwd(q, k, k, o, lse, o.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, k, k, o, lse, o.transpose(1, 2).contiguous()
                            .transpose(1, 2))


def test_refuse_grad_names_the_kernel():
    """A kernel without a backward refuses tracked inputs on the card
    (each CUDA wrapper calls ``refuse_grad`` before its launch); untracked
    inputs, or grad mode off, pass."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gmm.*backward kernel "
                       "is not yet ported"):
        refuse_grad("gmm", torch.zeros(2), x)
    refuse_grad("gmm", torch.zeros(2), None)
    with torch.no_grad():
        refuse_grad("gmm", x)
