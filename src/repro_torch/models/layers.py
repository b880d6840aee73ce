"""Shared building blocks: parameter defs, norms, RoPE, attention.

The port's counterpart of ``repro/models/layers.py``, for the dense
decoder.  Parameters are declared as :class:`PDef` (shape + logical axes
+ initializer) in a nested tree of dicts and tuples; :func:`init_params`
materializes one from a ``torch.Generator``.

The cast points follow the reference line for line: ``rms_norm`` and
``apply_rope`` work in float32 and cast back to the input's dtype, the
matmuls run in the activations' dtype (weights cast to it at use), and
attention scores, softmax and P.V run in float32 with one cast of the
output.  The two attention functions dispatch to the port's hand-written
kernels: :func:`flash_attention` (prefill and training) to
``kernels/flash_attention`` and :func:`attention_decode` (decode) to
``kernels/decode_attention``; on CPU tensors those wrappers run their
plain PyTorch versions.  Under autograd, :func:`flash_attention` goes
through :class:`FlashAttention`, the counterpart of the reference's custom
VJP (``_flash`` / ``_flash_fwd`` / ``_flash_bwd``): the forward kernel
with its log-sum-exp, and the backward kernel.  The loss,
:func:`chunked_cross_entropy`, forms the logits a sequence chunk at a
time under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``).  The reference's ``_act`` sharding constraint is a
no-op on one device and is left out.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention import decode_attention_fwd
from ..kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Parameter definition trees
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PDef:
    """A parameter leaf: shape, logical axes, initializer and dtype.

    ``read_f32`` marks a leaf the model reads in float32 (the reference
    casts it with ``.astype(jnp.float32)`` at use, never to the
    activations' dtype): :func:`init_params` keeps it float32 when asked
    for a compute dtype, since a cast at load would round it and change
    the function."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"   # normal | zeros | ones | scaled | rwkv_decay |
    #                        mamba_A | mamba_dt
    dtype: str = "float32"
    read_f32: bool = False

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in :func:`tree_map`'s order (dict insertion
    order)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def stack_defs(defs, num: int):
    """Prepend a ('layers') dimension to every PDef in a tree."""
    return tree_map(
        lambda d: dataclasses.replace(d, shape=(num,) + d.shape,
                                      axes=("layers",) + d.axes), defs)


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string ("float32", ...)."""
    return getattr(torch, name)


def _init_one(d: PDef, generator: torch.Generator, dtype):
    dev = generator.device
    dt = dtype or dtype_of(d.dtype)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=dev)
    if d.init in ("normal", "scaled"):
        # stacked [layers, ...] leaves are drawn one layer at a time: a
        # float32 draw of a whole stack can pass 2^31 elements (yi-9b's
        # w_gate) and would double the peak memory of the cast; the draw
        # is scaled in place and freed before the next one is drawn (one
        # layer of deepseek-v3's expert stack is 15 GB in float32)
        out = torch.empty(d.shape, dtype=dt, device=dev)
        for part in (out if len(d.shape) >= 3 else [out]):
            x = torch.randn(part.shape, generator=generator,
                            dtype=torch.float32, device=dev)
            part.copy_(x.mul_(0.02) if d.init == "normal"
                       else x.div_(math.sqrt(fan_in)))
            del x
        return out
    if d.init == "rwkv_decay":     # U[-8, -4]
        x = torch.rand(d.shape, generator=generator, dtype=torch.float32,
                       device=dev)
        return (x * 4.0 - 8.0).to(dt)
    if d.init == "mamba_A":        # log(1..N) along the last axis (S4D-real)
        n = torch.arange(1, d.shape[-1] + 1, dtype=torch.float32, device=dev)
        return _xla_log(n).expand(d.shape).to(dt).contiguous()
    if d.init == "mamba_dt":       # softplus^-1(dt), dt = e^U[ln 1e-3, ln 0.1]
        x = torch.rand(d.shape, generator=generator, dtype=torch.float32,
                       device=dev)
        lo, hi = math.log(1e-3), math.log(1e-1)
        t = torch.exp(x * (hi - lo) + lo)
        return (t + torch.log(-torch.expm1(-t))).to(dt)
    raise ValueError(f"unknown init {d.init!r}")


def _xla_log(x):
    """float32 log as the reference's XLA CPU backend computes it (the
    Cephes polynomial, each operation rounded to float32), so that
    ``mamba_A`` equals the reference's init exactly: that log is not
    correctly rounded (log 7 lies one unit above ``torch.log``'s).  Checked
    equal to ``jnp.log`` on every integer 1..11 047."""
    f = torch.float32
    m, e = torch.frexp(x.to(f))
    e = e.to(f)
    low = m < 0.707106781186547524
    e = e - low.to(f)
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    p = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
         -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
         2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
    y = (p[0] * x + p[1]) * x + p[2]
    y1 = (p[3] * x + p[4]) * x + p[5]
    y2 = (p[6] * x + p[7]) * x + p[8]
    y = ((y * x3 + y1) * x3 + y2) * x3
    y = y + e * -2.12194440e-4
    x = x - x2 * 0.5
    return (x + y) + e * 0.693359375


def init_params(defs, generator: torch.Generator, *, dtype=None):
    """Materialize a PDef tree on the generator's device, leaf by leaf in
    tree order; ``dtype`` overrides the dtype of each PDef not marked
    ``read_f32`` (the cast happens per leaf, so a float32 copy of the
    whole tree never exists, and the draws do not depend on ``dtype``).
    The numbers differ from the reference's ``jax.random`` ones for the
    same seed: tests carry weights across with
    ``convert.params_from_jax``."""
    return tree_map(lambda d: _init_one(
        d, generator, None if d.read_f32 else dtype), defs)


# --------------------------------------------------------------------------
# Basic ops
# --------------------------------------------------------------------------


def rms_norm(x, gamma, eps: float):
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * gamma.float()).to(dt)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) ).  x: [B, S, D]."""
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


def rope_angles(positions, dim: int, theta: float):
    """positions [..., S] -> (sin, cos) of shape [..., S, dim/2]."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32,
                      device=positions.device)
    freqs = 1.0 / (theta ** (ar / dim))
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x [..., S, H, D]; sin/cos [..., S, D/2] broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """Flash attention with a flash backward: the forward kernel saves
    (q, k, v, o, lse), and the backward kernel recomputes the probability
    tiles from them (the reference's ``_flash_fwd`` / ``_flash_bwd``).  On
    CPU tensors the two wrappers run their plain versions, so the CPU
    tests reach the function the kernels are held to."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool, chunk_q: int, chunk_k: int):
    """Softmax attention with an online (max, sum) softmax: the
    hand-written flash-attention kernel on the card, its plain version on
    the CPU; under autograd :class:`FlashAttention`, whose backward is the
    backward kernel (serving, under ``torch.no_grad``, calls the forward
    wrapper alone).

    q: [B, Sq, H, D];  k: [B, Sk, Kh, D];  v: [B, Sk, Kh, Dv]; H % Kh == 0.
    Returns [B, Sq, H, Dv].  The kernel picks its own tiles; the chunk
    lengths keep the reference's contract that they divide the sequence
    lengths (``ValueError`` otherwise).
    """
    Sq, Sk = q.shape[1], v.shape[1]
    chunk_q = min(chunk_q, Sq)
    chunk_k = min(chunk_k, Sk)
    if Sq % chunk_q or Sk % chunk_k:
        raise ValueError(f"seq lengths ({Sq},{Sk}) not divisible by chunks "
                         f"({chunk_q},{chunk_k})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal=causal)


def attention_ref(q, k, v, *, causal: bool, q_offset: int = 0):
    """Naive O(S²)-memory attention in float32 — tests only."""
    B, Sq, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    G = H // Kh
    qr = q.reshape(B, Sq, Kh, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) / math.sqrt(D)
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        mask = qp[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhv->bhgqv", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def attention_decode(q, k_cache, v_cache, pos):
    """Single-token attention against a KV cache: the hand-written
    flash-decoding kernel on the card, its plain version on the CPU.

    q: [B, 1, H, Dq];  k_cache: [B, S, Kh, Dq];  v_cache: [B, S, Kh, Dv];
    pos: an int or a [B] int32 tensor — positions > pos are masked out.
    """
    B, _, H, Dq = q.shape
    Dv = v_cache.shape[-1]
    if not torch.is_tensor(pos):
        pos = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    o = decode_attention_fwd(q.reshape(B, H, Dq).contiguous(), k_cache,
                             v_cache, pos)
    return o.reshape(B, 1, H, Dv)


def cache_update(cache_kv, new, pos: int):
    """Write ``new`` [B, S_new, ...] into ``cache_kv`` [B, S_max, ...] at
    ``pos``, in place, and return the cache.  The start is placed as
    ``lax.dynamic_update_slice`` places it: a negative ``pos`` counts from
    the end, then the start is clamped to [0, S_max - S_new]."""
    n, s_max = new.shape[1], cache_kv.shape[1]
    pos = int(pos)
    start = min(max(pos + s_max if pos < 0 else pos, 0), s_max - n)
    cache_kv[:, start:start + n] = new.to(cache_kv.dtype)
    return cache_kv


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------


def _chunk_nll(xc, w_out, lc, pmask, vocab_mask):
    """Summed masked NLL of one chunk: the logits in x's dtype, cast to
    float32, the padded vocab masked, logsumexp minus the gold logit."""
    logits = (xc @ w_out.to(xc.dtype)).float()
    if vocab_mask is not None:
        logits = logits + vocab_mask
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return ((lse - gold) * pmask).sum()


def chunked_cross_entropy(x, w_out, labels, *, num_chunks: int,
                          valid_vocab: int = 0, mask_last: bool = False):
    """Cross-entropy over a padded vocab, computed in sequence chunks (the
    reference's ``layers.chunked_cross_entropy``).

    x: [B, S, d];  w_out: [d, V];  labels: [B, S] int.  The [B, S / n, V]
    logits are formed one chunk at a time, never for the whole sequence,
    and each chunk runs under ``torch.utils.checkpoint``, so its logits are
    recomputed in the backward instead of kept.  ``valid_vocab``: when V
    is padded, columns >= valid_vocab get NEG_INF before the logsumexp.
    ``mask_last``: drop the final sequence position (MTP's shifted
    labels).  Returns (mean_nll, token_count); the chunk sums add in
    order into a float32 zero, as the reference's scan does (its
    ``logit_dtype``, which no caller sets, is float32 here).
    """
    B, S, _ = x.shape
    V = w_out.shape[-1]
    if S % num_chunks:
        num_chunks = 1
    Sc = S // num_chunks
    vocab_mask = None
    if valid_vocab and valid_vocab < V:
        vocab_mask = (torch.arange(V, device=x.device) >= valid_vocab).to(
            torch.float32) * NEG_INF
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(num_chunks):
        sl = slice(c * Sc, (c + 1) * Sc)
        pmask = torch.ones(B, Sc, dtype=torch.float32, device=x.device)
        if mask_last and c == num_chunks - 1:
            pmask[:, -1] = 0.0
        total = total + checkpoint(_chunk_nll, x[:, sl], w_out,
                                   labels[:, sl], pmask, vocab_mask,
                                   use_reentrant=False)
    n_tok = B * S - (B if mask_last else 0)
    return total / n_tok, n_tok
