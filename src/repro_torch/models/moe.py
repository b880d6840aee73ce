"""Mixture-of-Experts FFN: top-k router + capacity-based scatter dispatch.

The port's counterpart of ``repro/models/moe.py`` (its single-device path,
``_moe_ffn_spmd``).  Routing, capacity and the drop rule are the
reference's: a float32 softmax router with top-k and renormalised combine
weights, the load-balance auxiliary loss ``E · Σ_e f_e · p_e``, and per
router chunk a capacity C per expert, with each (token, slot) pair placed
at the exclusive count of earlier pairs routed to its expert in
token-major order and dropped when that count reaches C.

The expert FFN is where the port differs in form, not in function.  The
reference computes it as three einsums over an [E, C, D] buffer; the port
lays the buffer out as ``kernels/moe_gmm``'s ``pad_groups`` does — rows
sorted by expert, each expert's C rows padded to a multiple of ``block_m``
— and sends the three products through the hand-written grouped matmul
``gmm``: gate, up, ``silu(g) * u``, down.  Its valid-row counts come from
each expert's real fill ``min(count_e, C)``, so blocks that no token
reached are skipped with their weight reads (at decode one token fills 6
of moonshot's 64 experts).  Empty rows of the buffer are zero and a
skipped block gives zeros, so the result is the reference's.

Expert parallelism over a mesh (the reference's ``_moe_ffn_shard_map``)
is not ported: the port runs on one card.  What one card of such a
deployment computes is: with ``MoECfg.experts_held = h`` (0: all) the
layer holds the weights of experts [expert0, expert0 + h) only ([h, d, f]
stacks), routes over all ``num_experts`` with the router at its full
width, computes the capacity with all of them, and returns the part of
the result its experts give: a pair routed to an absent expert adds
nothing, as if dropped.  The shares of all cards sum to the uncut layer.
No exchange between cards stands in for the absent ones.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm import gmm
from .config import ArchConfig, MoECfg
from .layers import PDef, dtype_of, swiglu


def moe_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    """Per-layer MoE params (stacked over layers by the caller)."""
    m = cfg.moe
    d, f, held = cfg.d_model, m.d_ff_expert, experts_held(m)
    defs: dict[str, Any] = {
        # read in float32 (route)
        "router": PDef((d, m.num_experts), (None, None), "scaled",
                       read_f32=True),
        "w_gate": PDef((held, d, f), ("expert", "fsdp", None), "scaled"),
        "w_up": PDef((held, d, f), ("expert", "fsdp", None), "scaled"),
        "w_down": PDef((held, f, d), ("expert", None, "fsdp"), "scaled"),
    }
    if m.num_shared:
        fs = f * m.num_shared
        defs["shared_gate"] = PDef((d, fs), ("fsdp", "tp"), "scaled")
        defs["shared_up"] = PDef((d, fs), ("fsdp", "tp"), "scaled")
        defs["shared_down"] = PDef((fs, d), ("tp", "fsdp"), "scaled")
    return defs


def experts_held(m: MoECfg) -> int:
    """The number of experts whose weights this card holds."""
    held = m.experts_held or m.num_experts
    if not 0 < held <= m.num_experts:
        raise ValueError(f"experts_held={m.experts_held} must lie in "
                         f"0..{m.num_experts}")
    return held


def _capacity(m: MoECfg, tokens: int) -> int:
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(m.top_k, (c + 3) // 4 * 4)  # pad to a multiple of 4


def route(x, router_w, m: MoECfg, *, with_aux: bool = True):
    """x: [T, D] -> (weights [T,k], experts [T,k] int32, aux_loss scalar,
    or None with ``with_aux=False``).

    Top-k is a stable descending sort, so tied probabilities keep the
    lower expert first, as ``jax.lax.top_k`` does (``torch.topk`` does not
    promise an order on ties)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, :m.top_k], idx[:, :m.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    if not with_aux:
        return weights, experts.to(torch.int32), None
    # load-balance loss:  E · Σ_e  f_e · p̄_e
    E = m.num_experts
    f_e = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, experts.reshape(-1), torch.ones(experts.numel(),
                                           dtype=torch.float32,
                                           device=x.device))
    f_e = f_e / (x.shape[0] * m.top_k)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e)
    return weights, experts.to(torch.int32), aux


def block_m_for(capacity: int) -> int:
    """The gmm row block for a capacity: the smallest of 16, 32, 64 that
    holds it, else 128 (16 at moonshot's decode, C = 6; 64 at a 512-token
    prefill, C = 60; 128 at 2048 tokens, C = 240)."""
    for bm in (16, 32, 64):
        if capacity <= bm:
            return bm
    return 128


def _positions(experts, E: int, C: int):
    """Each (token, slot) pair's expert and row in its expert's buffer, in
    token-major order: ``pos[j] = #{j' < j : e_j' == e_j}``.  Returns
    (flat_e [T*k] int64, pos [T*k] with drops at C, dropped [T*k] bool,
    counts [E] of pairs routed to each expert)."""
    flat_e = experts.reshape(-1).long()
    onehot = F.one_hot(flat_e, E)
    pos = torch.cumsum(onehot, dim=0) - onehot            # exclusive
    pos = pos.gather(1, flat_e[:, None])[:, 0]
    dropped = pos >= C
    return flat_e, torch.where(dropped, C, pos), dropped, onehot.sum(0)


def _fill_blocks(counts, C: int, block_m: int):
    """(block_expert, nvalid) of the padded buffer, one entry per row block
    of every expert, from the experts' real fill ``min(count_e, C)``."""
    E = counts.shape[0]
    Cp = (C + block_m - 1) // block_m * block_m
    nb = Cp // block_m
    fill = counts.clamp(max=C)
    start = torch.arange(nb, device=counts.device) * block_m
    nvalid = (fill[:, None] - start[None, :]).clamp(0, block_m)
    block_expert = torch.arange(E, dtype=torch.int32,
                                device=counts.device).repeat_interleave(nb)
    return block_expert, nvalid.reshape(-1).to(torch.int32)


def _dispatch_combine(xc, weights, experts, w_gate, w_up, w_down, m: MoECfg,
                      compute_dtype, expert0: int = 0):
    """One chunk: xc [T, D] -> [T, D] through capacity-C expert buffers of
    the held experts [expert0, expert0 + w_gate.shape[0])."""
    T, D = xc.shape
    E, k, H = m.num_experts, m.top_k, w_gate.shape[0]
    C = _capacity(m, T)
    bm = block_m_for(C)
    Cp = (C + bm - 1) // bm * bm
    flat_e, pos, dropped, counts = _positions(experts, E, C)
    local = flat_e - expert0
    # a pair adds nothing if dropped or routed to an expert not held here
    skip = dropped | (local < 0) | (local >= H)

    # scatter tokens -> [H*Cp + 1, D]; the last row collects skipped pairs
    # and is cut off (each kept (expert, pos) is written once)
    row = torch.where(skip, H * Cp, local * Cp + pos)
    src = xc.repeat_interleave(k, dim=0).to(compute_dtype)      # [T*k, D]
    buf = torch.zeros(H * Cp + 1, D, dtype=compute_dtype, device=xc.device)
    buf.index_put_((row,), src)
    buf = buf[:H * Cp]

    # expert SwiGLU: three gmm launches over the padded buffer [H*Cp, D]
    be, nv = _fill_blocks(counts[expert0:expert0 + H], C, bm)
    g = gmm(buf, w_gate.to(compute_dtype).contiguous(), be, nv, block_m=bm)
    u = gmm(buf, w_up.to(compute_dtype).contiguous(), be, nv, block_m=bm)
    y = gmm(F.silu(g) * u, w_down.to(compute_dtype).contiguous(), be, nv,
            block_m=bm)

    # gather back + weighted combine (skipped pairs add zero)
    out = torch.where(skip[:, None], 0.0,
                      y[local.clamp(0, H - 1) * Cp + pos.clamp(max=C - 1)])
    w = torch.where(skip, 0.0, weights.reshape(-1)).to(compute_dtype)
    return (out * w[:, None]).reshape(T, k, D).sum(dim=1)


def moe_ffn(x, params, cfg: ArchConfig, *, chunk: int = 4096,
            with_aux: bool = True, expert0: int = 0):
    """x: [B, S, D] -> ([B, S, D], aux_loss), the loss None with
    ``with_aux=False`` (the serving path, which reads none, so the router
    skips its work).  ``params`` hold the experts [expert0, expert0 +
    experts_held) (all of them by default; the module docstring says what
    a share computes).

    The router runs over chunks of ``chunk`` tokens (one chunk when the
    token count is not a multiple of it, as in the reference), each with
    its own capacity; the gmm row block follows the capacity
    (:func:`block_m_for`), and the result does not depend on it.
    """
    m = cfg.moe
    if not 0 <= expert0 <= m.num_experts - experts_held(m):
        raise ValueError(f"expert0={expert0}: the share of "
                         f"{experts_held(m)} experts must lie within "
                         f"{m.num_experts}")
    B, S, D = x.shape
    dt = dtype_of(cfg.compute_dtype)
    xf = x.reshape(B * S, D)
    T = B * S
    chunk = min(chunk, T)
    if T % chunk:
        chunk = T  # fall back to a single chunk (small smoke shapes)
    n = T // chunk
    aux = 0.0
    ys = []
    for xc in xf.split(chunk):
        w, e, a = route(xc, params["router"], m, with_aux=with_aux)
        ys.append(_dispatch_combine(xc, w, e, params["w_gate"],
                                    params["w_up"], params["w_down"], m, dt,
                                    expert0))
        if with_aux:
            aux = aux + a
    out = torch.cat(ys).reshape(B, S, D).to(x.dtype)
    if m.num_shared:
        out = out + swiglu(x, params["shared_gate"], params["shared_up"],
                           params["shared_down"])
    return out, aux / n if with_aux else None


def moe_active_params_per_layer(cfg: ArchConfig) -> int:
    """Per-token active expert params in one MoE layer (router + top-k +
    shared)."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    active = d * m.num_experts                       # router
    active += m.top_k * 3 * d * f                    # routed experts
    active += m.num_shared * 3 * d * f               # shared experts
    return active
