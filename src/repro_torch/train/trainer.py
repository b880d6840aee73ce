"""Training loop: the train step + checkpoint/restart + failure handling
(the port's copy of the reference's ``repro/train/trainer.py``).

The Trainer owns the train state, the deterministic data cursor and an
async CheckpointManager, and a restart path that (a) resumes from the
latest complete checkpoint and (b) resumes the exact batch stream from
the stored step.  The port trains on one device: ``device=`` takes the
place of the reference's ``mesh=``, and there is no re-sharding.
Parameters are float32 leaves with ``requires_grad``; the step updates
them and the AdamW state in place.

Failure handling is exercised by tests via ``FailureInjector`` — a hook
that raises at a chosen step; the driver catches, constructs a fresh
Trainer (as a restarted job would), and verifies bit-exact continuation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..checkpoint.ckpt import CheckpointManager
from ..data.pipeline import make_train_batches
from ..models.config import ArchConfig
from ..models.layers import tree_map
from ..models.model import Model
from ..optim.optimizer import AdamWConfig
from .step import init_train_state, make_train_step


class InjectedFailure(RuntimeError):
    """A deliberately injected failure (chaos tests, restart drills).

    Subclasses RuntimeError for backward compatibility, but restart
    harnesses catch *this* type: a genuine RuntimeError from the train
    step (NaN loss, OOM, shape bug) must propagate, not be retried into
    a restart loop that masks it.
    """


@dataclasses.dataclass
class FailureInjector:
    """Raises InjectedFailure right after ``at_step`` completes (tests)."""

    at_step: int = -1

    def check(self, step: int):
        if step == self.at_step:
            raise InjectedFailure(f"injected failure at step {step}")


def _as_like(like, got, device):
    """The restored tree in ``like``'s structure, as tensors on
    ``device``."""
    if isinstance(like, dict):
        return {k: _as_like(like[k], got[k], device) for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_as_like(a, b, device) for a, b in zip(like, got))
    return torch.as_tensor(got).to(device)


@dataclasses.dataclass
class Trainer:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    opt_cfg: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatches: int = 1
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    seed: int = 0
    log_every: int = 10
    on_metrics: Callable[[int, dict], None] | None = None
    device: str = "cuda"

    def __post_init__(self):
        self.model = Model(self.cfg)
        self.ckpt = CheckpointManager(self.ckpt_dir) if self.ckpt_dir \
            else None

    # -- state ----------------------------------------------------------------

    def init_state(self, generator: torch.Generator | None = None):
        """Fresh float32 params (drawn from ``seed`` on the device unless a
        generator is given) and a zero AdamW state."""
        gen = generator or torch.Generator(device=self.device).manual_seed(
            self.seed)
        return init_train_state(self.cfg, gen)

    def restore_or_init(self):
        """Restart path: latest checkpoint if present, else fresh init.
        Returns (params, opt_state, first step to run)."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            like_p = tree_map(lambda d: 0, self.model.param_defs())
            like_o = {"mu": like_p, "nu": like_p, "step": 0}
            (params, opt), step, _ = self.ckpt.restore((like_p, like_o))
            params = _as_like(like_p, params, self.device)
            opt = _as_like(like_o, opt, self.device)
            tree_map(lambda p: p.requires_grad_(True), params)
            return params, opt, step + 1
        params, opt = self.init_state()
        return params, opt, 0

    # -- loop -----------------------------------------------------------------

    def run(self, num_steps: int, *, params=None, opt_state=None,
            start_step: int | None = None,
            failure: FailureInjector | None = None) -> dict:
        """Train to ``num_steps`` TOTAL steps from the restart point (or
        from the given state at ``start_step``, default 0).  Returns the
        params, the optimizer state, the logged history (every
        ``log_every``-th step and the first) and ``steps_per_s``."""
        if params is None:
            params, opt_state, start_step = self.restore_or_init()
        elif start_step is None:
            start_step = 0
        step_fn = make_train_step(self.cfg, self.opt_cfg, self.microbatches)
        batches = make_train_batches(self.cfg, self.global_batch,
                                     self.seq_len, seed=self.seed,
                                     device=self.device)
        history = []
        t0 = time.time()
        try:
            for step, batch in batches:
                if step < start_step:     # the stream is a function of step
                    continue
                if step >= num_steps:     # num_steps = TOTAL training steps
                    break
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                if step % self.log_every == 0 or step == start_step:
                    m = {k: float(v) for k, v in metrics.items()
                         if np.ndim(v) == 0}
                    m["step"] = step
                    history.append(m)
                    if self.on_metrics:
                        self.on_metrics(step, m)
                if self.ckpt and step > 0 and step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, (params, opt_state),
                                         extra={"seed": self.seed})
                if failure:
                    failure.check(step)
        finally:
            # a checkpoint in flight is finished before the run ends, on a
            # failure too, so a restarted trainer finds it
            if self.ckpt:
                self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "history": history, "steps_per_s":
                (num_steps / max(time.time() - t0, 1e-9))}
