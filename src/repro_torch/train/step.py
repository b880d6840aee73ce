"""The train step: gradient accumulation over microbatches + AdamW (the
port's copy of the reference's ``repro/train/step.py``).

``make_train_step(cfg, opt_cfg, microbatches=M)`` returns

    step(params, opt_state, batch) -> (params, opt_state, metrics)

Where the reference's step is a pure jitted function, the port's runs
eagerly and updates ``params`` and ``opt_state`` in place (their leaves
are the same tensors afterwards; the state's ``step`` is a new one).  The
batch is cut into M microbatches along its first axis; each one's loss is
back-propagated on its own (each layer remats per the model's remat
policy), the float32 gradients add up in the parameters' ``.grad`` in
microbatch order and are divided by M, the loss is the mean and the
other metrics are the last microbatch's, as in the reference.
"""

from __future__ import annotations

import torch

from ..models.config import ArchConfig
from ..models.layers import dtype_of, tree_leaves, tree_map
from ..models.model import Model, train_inputs
from ..optim.optimizer import AdamWConfig, adamw_init, adamw_update


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    model = Model(cfg)
    M = microbatches

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                raise ValueError("train_step needs parameters with "
                                 "requires_grad (init_train_state makes "
                                 "them so)")
            p.grad = None
        if M == 1:
            loss, metrics = model.loss(params, batch)
            loss.backward()
            loss = loss.detach()
        else:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch {B} is not {M} equal microbatches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(M):
                mb = {k: v[i * (B // M):(i + 1) * (B // M)]
                      for k, v in batch.items()}
                l, metrics = model.loss(params, mb)
                l.backward()
                loss = loss + l.detach()
            loss = loss / M
            for p in leaves:
                if p.grad is not None:
                    p.grad.div_(M)
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        params, opt_state, stats = adamw_update(opt_cfg, grads, opt_state,
                                                params)
        for p in leaves:
            p.grad = None
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics.update(stats)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train_state_specs(cfg: ArchConfig, batch: int, seq: int):
    """(params, opt_state, batch) as trees of ``meta`` tensors: shapes and
    dtypes without memory (the reference's ``ShapeDtypeStruct`` trees)."""
    p = tree_map(lambda d: torch.empty(d.shape, dtype=dtype_of(d.dtype),
                                       device="meta"),
                 Model(cfg).param_defs())
    f32 = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                         device="meta"), p)
    opt = {"mu": f32, "nu": f32,
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    b = {k: torch.empty(shape, dtype=dt, device="meta")
         for k, (shape, dt) in train_inputs(cfg, batch, seq).items()}
    return p, opt, b


def init_train_state(cfg: ArchConfig, generator: torch.Generator):
    """Float32 parameters drawn on the generator's device, with
    ``requires_grad``, and a zero AdamW state beside them."""
    params = Model(cfg).init(generator)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, adamw_init(params)
