"""Serving engine: prefill/decode with Balanced-Splitting admission.

The port's counterpart of ``repro/serve/engine.py``.  Request classes are
(model, context bucket) pairs — each with a fixed chip need
(``kv_cache.chips_needed``) and a profiled service-time distribution,
i.e. *exactly* the multiserver-job classes of the paper.  The engine:

1. builds the BalancedMeshPartition over the fleet from the class demand
   estimates (eq. 2);
2. admits each request per BS-π: a free slot in its class slice, else the
   helper block under π=FCFS (GangScheduler);
3. on slot granting, ``run_request`` runs prefill once and then greedy
   decode steps of the model (dense, MoE, RWKV6 or hybrid), whose
   attention runs in the hand-written flash-attention and flash-decoding
   kernels, whose MoE expert products run in the hand-written grouped
   matmul, whose RWKV prefill runs its WKV recurrence in the hand-written
   chunked WKV kernel and whose Mamba prefill runs the hand-written
   selective-scan kernel on the card.

The engine runs on ``device`` ("cuda" unless the caller asks for the CPU).
As in the reference, where the backend is the CPU the models are the
``reduced()`` configs.  On the card every model runs at its full width on
the one card; the admission logic (the paper's contribution) is the same
either way.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

import numpy as np
import torch

from ..core.workload import Exp, JobClass
from ..models.config import ArchConfig
from ..models.layers import dtype_of, tree_leaves
from ..models.model import SOURCE_KEY, Model, init_cache
from ..sched.cluster import BalancedMeshPartition
from ..sched.gang import GangJob, GangScheduler


@dataclasses.dataclass
class Request:
    rid: int
    cls_name: str
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    arrival: float = 0.0
    output: list = dataclasses.field(default_factory=list)
    admitted_at: float | None = None
    finished_at: float | None = None
    # wall seconds of run_request: prompt to first token on the host, and
    # the greedy steps after it (each token is read back, so both end on
    # finished device work)
    prefill_s: float | None = None
    decode_s: float | None = None


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """(model, context bucket) — a multiserver-job class on the fleet."""

    name: str
    cfg: ArchConfig
    bucket: int                   # max context length
    chips: int                    # server need n_i
    mean_service_s: float         # profiled E[D_i]
    alpha: float                  # arrival mix


class ServingEngine:
    def __init__(self, classes: Sequence[RequestClass], fleet_chips: int,
                 *, batch_slots: int = 1, aux: str = "fcfs", seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        self.classes = list(classes)
        jc = tuple(JobClass(c.name, c.chips, Exp(c.mean_service_s), c.alpha)
                   for c in self.classes)
        self.partition = BalancedMeshPartition.build(fleet_chips, jc)
        self.sched = GangScheduler(self.partition, aux=aux)
        self.by_name = {c.name: i for i, c in enumerate(self.classes)}
        cpu = self.device.type == "cpu"
        self._models = {c.name: Model(c.cfg.reduced() if cpu else c.cfg)
                        for c in self.classes}
        self._params = {}
        self._jid = itertools.count()
        self._jobs: dict[int, Request] = {}
        self.seed = seed
        self.now = 0.0
        self.metrics = {"admitted_direct": 0, "via_helper": 0,
                        "completed": 0, "wait_sum": 0.0}

    def _model(self, cls_name: str) -> Model:
        return self._models[cls_name]

    def _get_params(self, cls_name: str):
        """The class's weights on the engine's device, made from ``seed``
        at first use (or placed in ``_params`` by the caller).

        A weight the reference casts to the activations' dtype at every
        use (``p["wq"].astype(x.dtype)``) is cast to the model's
        ``compute_dtype`` once, here at load, one layer of each stacked
        leaf at a time, which gives the same numbers and halves the card's
        memory (yi-9b: 17.7 GB instead of 35.3 GB; moonshot-v1-16b-a3b:
        56.1 GB, its expert stack ``w_gate`` alone [48, 64, 2048, 1408]).
        A leaf the reference reads in float32 stays float32: the rule is
        its ``PDef``'s ``read_f32`` flag, set beside the model code (the
        norm gains, the MoE router, RWKV's decay LoRA, decay bias, bonus
        and group-norm gain), since a cast at load would round it and
        change the function (RWKV's decay bias ~ U[-8, -4] rounds to
        steps of 2^-5 in bfloat16, moving each decay exp(bias) by up to
        ~1.6 %).  The model's functions still cast at use, a no-op on
        these."""
        if cls_name not in self._params:
            m = self._model(cls_name)
            g = torch.Generator(device=self.device).manual_seed(self.seed)
            self._params[cls_name] = m.init(
                g, dtype=dtype_of(m.cfg.compute_dtype))
        return self._params[cls_name]

    # -- request lifecycle ----------------------------------------------------

    def submit(self, req: Request, now: float | None = None) -> None:
        now = self.now if now is None else now
        self.now = max(self.now, now)
        i = self.by_name[req.cls_name]
        c = self.classes[i]
        jid = next(self._jid)
        job = GangJob(jid=jid, cls=i, need=c.chips, arrival=now,
                      service=c.mean_service_s)
        self._jobs[jid] = req
        before = self.sched.n_helper_served
        self.sched.arrive(job, now)
        req.admitted_at = job.start
        if job.start is not None:
            if self.sched.n_helper_served > before:
                self.metrics["via_helper"] += 1
            else:
                self.metrics["admitted_direct"] += 1

    def run_request(self, jid: int) -> Request:
        """Execute prefill + greedy decode for an admitted request."""
        req = self._jobs[jid]
        model = self._model(req.cls_name)
        cfg = model.cfg
        if cfg.family in SOURCE_KEY:
            # the prefill below, given only the tokens as the reference's
            # is, would fail on the missing input; raised before the
            # weights are made, so that a model no card holds is never
            # allocated for it
            raise KeyError(SOURCE_KEY[cfg.family])
        params = self._get_params(req.cls_name)
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.device)[None, :]
        S = prompt.shape[1]
        total = S + req.max_new_tokens
        t0 = time.perf_counter()
        caches = init_cache(cfg, 1, total, device=self.device)
        logits, pre = model.prefill(params, {"tokens": prompt})
        caches = _seed_caches(caches, pre, S)
        tok = torch.argmax(logits, -1)[:, None]
        req.output.append(int(tok[0, 0]))
        t1 = time.perf_counter()
        for t in range(S, S + req.max_new_tokens - 1):
            logits, caches = model.decode_step(params, caches, tok, t)
            tok = torch.argmax(logits, -1)[:, None]
            req.output.append(int(tok[0, 0]))
        req.prefill_s, req.decode_s = t1 - t0, time.perf_counter() - t1
        return req

    def complete(self, jid: int, now: float) -> None:
        self.now = max(self.now, now)
        req = self._jobs[jid]
        req.finished_at = now
        self.metrics["completed"] += 1
        self.metrics["wait_sum"] += req.admitted_at - req.arrival \
            if req.admitted_at is not None else 0.0
        self.sched.complete(jid, now)
        # newly granted jobs get their admission stamped
        for j in self.sched.running.values():
            r = self._jobs.get(j.jid)
            if r is not None and r.admitted_at is None and \
                    j.start is not None:
                r.admitted_at = j.start

    @property
    def p_helper(self) -> float:
        return self.sched.p_helper

    def mean_wait(self) -> float:
        return self.metrics["wait_sum"] / max(self.metrics["completed"], 1)


def _seed_caches(caches, prefill_caches, prompt_len: int):
    """Write the prefill KV (length S) into the serving cache (length
    S_max) along the sequence axis of each stacked [L, B, S, ...] leaf, in
    place; returns ``caches``."""
    def seed(dst, src):
        if dst.shape == src.shape:
            dst.copy_(src)
        elif (src.dim() == dst.dim() and dst.shape[:2] == src.shape[:2]
              and src.shape[2] <= dst.shape[2]
              and dst.shape[3:] == src.shape[3:]):
            dst[:, :, :src.shape[2]] = src

    for dst, src in zip(tree_leaves(caches), tree_leaves(prefill_caches)):
        seed(dst, src)
    return caches
