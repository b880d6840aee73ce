"""AdamW (+ global-norm clip, cosine schedule) over trees of tensors: the
port's copy of the reference's ``repro/optim/optimizer.py``.

The moment trees mirror the parameter tree and are float32 whatever the
parameter dtype (the reference's become float32 after its first update).
The arithmetic is the reference's, operation for operation, in float32:
the clip scales each gradient by min(1, max_norm / max(norm, 1e-9)), and
each leaf is updated as

    m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    p = p - lr (m / c1 / (sqrt(v / c2) + eps) + wd p)

with c1 = 1 - b1^step, c2 = 1 - b2^step, the decay inside the step (not
``torch.optim.AdamW``'s order).  Where the reference builds new trees, the
port updates gradients, moments and parameters in place, with the same
values: a whole-tree copy of the state would not fit beside a 2.8 B-param
model's 44.7 GB of float32 state on one card.  A stacked [layers, ...]
leaf is updated one layer at a time, so each temporary is a layer's size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an integer tensor) as a
    float32 0-d tensor: linear warm-up, then a cosine down to
    ``min_lr_ratio`` of ``lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params) -> dict[str, Any]:
    """Zero float32 moments beside each parameter, and an int32 step."""
    def zeros(tree):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), tree)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_axes(param_axes) -> dict[str, Any]:
    """The state tree's logical axes: the parameters' for each moment."""
    return {"mu": param_axes, "nu": param_axes, "step": ()}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient in place by min(1, max_norm / max(norm,
    1e-9)), norm the float32 global L2 norm (leaf sums added in tree
    order).  Returns (grads, norm)."""
    leaves = tree_leaves(grads)
    norm = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(torch.as_tensor(norm, dtype=torch.float32))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _update(cfg: AdamWConfig, lr, c1, c2, g, m, v, p) -> None:
    """One leaf (or one layer of a stacked leaf), in place."""
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float()
    m.mul_(b1).add_(gf * (1 - b1))
    t = gf * (1 - b2)
    v.mul_(b2).add_(t.mul_(gf))
    den = (v / c2).sqrt_().add_(cfg.eps)
    delta = (m / c1).div_(den)
    del den, t
    delta.add_(cfg.weight_decay * p.float())
    d = delta.to(p.dtype)
    if p.dtype == torch.float32:
        p.sub_(d.mul_(lr))
    else:
        p.copy_((p.float() - lr * d.float()).to(p.dtype))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params):
    """Clip, then one AdamW step.  Updates ``grads`` (clipped), the
    moments and ``params`` in place; returns (params, new_state, stats)
    with ``stats`` = {"grad_norm", "lr"} (float32 0-d tensors) and the
    new state's step one higher."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step).to(step.device)
    sf = step.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** sf
    c2 = 1.0 - cfg.b2 ** sf
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"]), tree_leaves(params)):
        if p.dim() >= 3:              # a stacked leaf: a layer at a time
            for i in range(p.shape[0]):
                _update(cfg, lr, c1, c2, g[i], m[i], v[i], p[i])
        else:
            _update(cfg, lr, c1, c2, g, m, v, p)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
