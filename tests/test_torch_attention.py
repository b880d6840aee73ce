"""The attention kernels' plain versions against the JAX reference.

On this CPU the wrappers ``flash_attention_fwd`` / ``decode_attention_fwd``
run their plain PyTorch versions.  Each is held, on the same inputs made
with numpy, to the reference's Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it) and to the reference model's own jnp
function (``layers.flash_attention`` / ``layers.attention_decode``), at
``tests/test_kernels.py``'s tolerances: float32 2e-5, bfloat16 2e-2
(atol = rtol).  The shapes are that file's (GQA, Dv != D, non-causal with
Sq != Sk, MQA) plus head dim 80, stablelm-3b's.  The CUDA kernels are held
to the same plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_card.py``.

``flash_attention_fwd`` picks one of two CUDA kernels with the pure
function ``_flash_route``, whose cases are pinned here.  The tensor-core
kernel's rounding of p (three bf16 parts into P.V, each key tile's P.V
added to O in float32), emulated in plain PyTorch by
``bench/decode_vs_forward.emulate_flash``, is held to
``flash_attention_ref`` within the card's bf16 limit, 1e-5 + 2^-6 |ref|,
at ``FLASH_SHAPES`` and one 2048-token shape.
"""

import numpy as np
import pytest
import torch

import _torch_jaxref  # noqa: F401  (the R1 alias, before any repro import)

import jax.numpy as jnp
from repro.kernels.decode_attention import decode_attention
from repro.kernels.flash_attention import flash_attention
from repro.models import layers as ref_layers

from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_ref)
from repro_torch.bench.decode_vs_forward import emulate_flash
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention.kernel import _flash_route
from repro_torch.models import layers

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
# CUDA kernel against its plain version, as (atol, rtol): both round one
# float32 result to the dtype, so in bfloat16 they differ by at most one
# unit in the last place (2^-7 |ref|); the limit allows two, plus the
# float32 sums' own difference
PLAIN_TOLS = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 2.0 ** -6)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, 64, True),
    (1, 128, 256, 4, 4, 128, 128, False),
    (2, 256, 256, 6, 3, 64, 32, True),
    (1, 512, 512, 8, 1, 64, 64, True),     # MQA
    (1, 128, 128, 4, 2, 80, 80, True),     # stablelm-3b's head dim
]
DECODE_SHAPES = [
    (2, 1024, 8, 2, 64, 64, 128),
    (3, 512, 4, 4, 128, 64, 256),
    (1, 256, 16, 2, 64, 128, 64),
    (2, 512, 8, 8, 80, 80, 128),           # stablelm-3b's head dim, MHA
]


def _both(rng, shape, dtype):
    """The same normal sample as a jax and a torch array of ``dtype``."""
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _close(port, ref, dtype):
    tol = TOLS[dtype]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _close_plain(out, ref, dtype):
    atol, rtol = PLAIN_TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,Dv,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(B, Sq, Sk, H, Kh, D, Dv, causal,
                                       dtype, rng):
    jq, q = _both(rng, (B, Sq, H, D), dtype)
    jk, k = _both(rng, (B, Sk, Kh, D), dtype)
    jv, v = _both(rng, (B, Sk, Kh, Dv), dtype)
    out = flash_attention_fwd(q, k, v, causal=causal)
    assert out.shape == (B, Sq, H, Dv) and out.dtype == q.dtype
    _close(out, flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64), dtype)
    _close(out, ref_layers.flash_attention(jq, jk, jv, causal=causal,
                                           chunk_q=64, chunk_k=64), dtype)
    # the port model's entry point reaches the same function, and the
    # port's naive oracle is the reference's
    naive = ref_layers.attention_ref(jq, jk, jv, causal=causal)
    _close(layers.flash_attention(q, k, v, causal=causal, chunk_q=64,
                                  chunk_k=64), naive, dtype)
    _close(layers.attention_ref(q, k, v, causal=causal), naive, dtype)


@pytest.mark.parametrize("B,Sk,H,Kh,D,Dv,bk", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference(B, Sk, H, Kh, D, Dv, bk, dtype,
                                        rng):
    jq, q = _both(rng, (B, H, D), dtype)
    jk, k = _both(rng, (B, Sk, Kh, D), dtype)
    jv, v = _both(rng, (B, Sk, Kh, Dv), dtype)
    pos = rng.integers(1, Sk, size=B).astype(np.int32)
    out = decode_attention_fwd(q, k, v, torch.tensor(pos))
    assert out.shape == (B, H, Dv) and out.dtype == q.dtype
    _close(out, decode_attention(jq, jk, jv, jnp.asarray(pos), block_k=bk),
           dtype)
    # the model's function takes one scalar position for the whole batch
    p0 = int(pos[0])
    port = layers.attention_decode(q[:, None], k, v, p0)
    ref = ref_layers.attention_decode(jq[:, None], jk, jv, jnp.int32(p0))
    assert port.shape == (B, 1, H, Dv)
    _close(port, ref, dtype)


def test_decode_negative_pos_masks_everything_as_the_reference(rng):
    """pos < 0 masks every position to -1e30: the softmax is uniform."""
    jq, q = _both(rng, (2, 4, 32), "float32")
    jk, k = _both(rng, (2, 64, 2, 32), "float32")
    jv, v = _both(rng, (2, 64, 2, 16), "float32")
    pos = np.array([-1, 10], np.int32)
    out = decode_attention_fwd(q, k, v, torch.tensor(pos))
    from repro.kernels.decode_attention import ref as ref_decode
    _close(out, ref_decode.decode_attention_ref(jq, jk, jv,
                                                jnp.asarray(pos)),
           "float32")
    np.testing.assert_allclose(out[0].numpy(),
                               v[0].mean(0).repeat_interleave(2, 0).numpy(),
                               atol=2e-5)


def test_flash_chunk_contract_and_wrapper_checks(rng):
    _, q = _both(rng, (1, 96, 4, 32), "float32")
    _, k = _both(rng, (1, 96, 2, 32), "float32")
    with pytest.raises(ValueError, match="not divisible by chunks"):
        layers.flash_attention(q, k, k, causal=True, chunk_q=64, chunk_k=64)
    with pytest.raises(ValueError, match="not divisible by chunks"):
        ref_layers.flash_attention(jnp.asarray(q.numpy()),
                                   jnp.asarray(k.numpy()),
                                   jnp.asarray(k.numpy()), causal=True,
                                   chunk_q=64, chunk_k=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_fwd(q, k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            k)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(torch.zeros(1, 8, 3, 32), k[:, :8], k[:, :8])
    with pytest.raises(ValueError, match="exceed"):
        flash_attention_fwd(torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 160))
    qd = q[:, 0]
    with pytest.raises(TypeError, match="int32"):
        decode_attention_fwd(qd, k, k, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="kv head exceed"):
        decode_attention_fwd(torch.zeros(1, 65, 8), torch.zeros(1, 4, 1, 8),
                             torch.zeros(1, 4, 1, 8),
                             torch.zeros(1, dtype=torch.int32))
    before = (flash_attention_fwd.launches, decode_attention_fwd.launches)
    flash_attention_fwd(q, k, k)
    decode_attention_fwd(qd, k, k, torch.zeros(1, dtype=torch.int32))
    assert (flash_attention_fwd.launches,
            decode_attention_fwd.launches) == before   # CPU: no launch


@pytest.mark.parametrize("dtype,D,Dv,route", [
    (torch.bfloat16, 128, 128, "wgmma"),  # yi-9b, moonshot, jamba
    (torch.bfloat16, 80, 80, "wgmma"),    # stablelm-3b
    (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 64, 32, "wgmma"),
    (torch.bfloat16, 16, 128, "wgmma"),
    (torch.float32, 128, 128, "simt"),    # TF32 is another function
    (torch.float32, 80, 80, "simt"),
    (torch.bfloat16, 256, 128, "simt"),   # head dim above 128
    (torch.bfloat16, 128, 144, "simt"),
    (torch.bfloat16, 72, 72, "simt"),     # not a multiple of 16
])
def test_flash_route(dtype, D, Dv, route):
    assert _flash_route(dtype, D, Dv) == route


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,D,Dv,causal", FLASH_SHAPES + [
    (1, 2048, 2048, 2, 1, 128, 128, True)])
def test_wgmma_rounding_keeps_the_bf16_limit(B, Sq, Sk, H, Kh, D, Dv,
                                             causal, rng):
    """p as three bf16 parts (``emulate_flash``: the rounding of p only)
    keeps the card's bf16 limit against the plain version, which keeps p
    in float32 (a plain bf16 p does not: PERF.md)."""
    q, k, v = (_both(rng, s, "bfloat16")[1] for s in (
        (B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, Dv)))
    _close_plain(emulate_flash(q, k, v, causal, bk=64),
                 flash_attention_ref(q, k, v, causal=causal), "bfloat16")


# the served models' heads (H, Kh, D): yi-9b, stablelm-3b, moonshot, jamba
SERVED_HEADS = [(32, 4, 128), (32, 32, 80), (16, 16, 128), (64, 8, 128)]


@pytest.mark.parametrize("H,Kh,D", SERVED_HEADS)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_decode_plan_covers_every_kept_position(H, Kh, D, B, itemsize):
    """The decode kernel's plan at the served heads, Sk 8192, on 132 SMs:
    the grid is one wave ``_CTAS_PER_SM`` deep or 4 CTAs a sequence per
    kv head, whichever is more, the scores fit,
    each SM keeps at least 32 KB of cache rows in flight, the CTA fits;
    and for kept positions from 1 to Sk (ragged, equal, one long and the
    rest short) the splits of each sequence cover its kept positions
    exactly once, in order, none longer than KC, none longer than the
    balanced share max(cmin, ceil(R / (nx - B)) in whole tiles)."""
    Sk, n_sm = 8192, 132
    plan = decode_kernel.decode_plan(B, Kh, Sk, H // Kh, D, D, itemsize,
                                     n_sm)
    assert plan.nx >= 4 * B
    assert n_sm <= plan.nx * Kh <= max(decode_kernel._CTAS_PER_SM * n_sm,
                                       4 * B * Kh)
    assert (H // Kh) * plan.kc <= decode_kernel._SCORES_MAX
    assert plan.in_flight >= 32 * 1024 and plan.ctas_per_sm >= 2
    assert plan.smem <= 227 * 1024
    rng = np.random.default_rng(B * 1000 + H + itemsize)
    cases = [[Sk] * B, [1] * B, [Sk] + [1] * (B - 1),
             [1] * (B - 1) + [Sk], [plan.cmin + 1] * B]
    cases += [rng.integers(1, Sk + 1, B).tolist() for _ in range(40)]
    for n_kept in cases:
        splits = decode_kernel.split_ranges(n_kept, plan.nx, plan.cmin,
                                             plan.kt)
        assert len(splits) == plan.nx
        per = -(-sum(n_kept) // (plan.nx - B))        # ceil(R / (nx - B))
        share = max(plan.cmin, -(-per // plan.kt) * plan.kt)
        at = [0] * B
        for sp in splits:
            if sp is None:
                continue
            b, start, end = sp
            assert start == at[b] and start < end <= n_kept[b]
            assert end - start <= min(plan.kc, share)
            at[b] = end
        assert at == n_kept
