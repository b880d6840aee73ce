"""Cases of the training path that ``chip_smoke.py`` and
``tests/test_torch_card.py`` share: the flash backward kernel's limit
against its plain version, a few train steps of a config on a device from
one float32 start, and the restart drill.

Tolerances, with their reasons.

* ``BWD_TOLS`` (kernel against plain version, same device and inputs):
  both sum the same float32 products, in other orders (the plain version
  through cuBLAS, the kernel a tile at a time), so an element differs by
  float32 rounding of sums whose terms can be far larger than the element
  (dk and dv sum over every query of G heads): |kernel - plain| <=
  a max|plain| + r |plain|, with (a, r) = (1e-4, 1e-5) in float32 and
  (2^-8, 2^-6) in bf16, where each side rounds its float32 result once
  (one unit in the last place is 2^-8 relative).
* ``STEP_OPT``: the train steps held card == CPU use lr 1e-3 after one
  warm-up step and eps 1e-3.  With the default eps (1e-8) the first AdamW
  steps move each weight by lr g / (|g| + 1e-8), nearly lr sign(g), so a
  gradient element within float32 noise of zero can move its weight by up
  to 2 lr between two correct implementations; with eps 1e-3 the update
  is a smooth function of g and the parameters can be held tight.
  ``STEP_TOLS``: float32 compute, card against CPU (cuBLAS and the
  kernels against the CPU's plain versions, float32 throughout): loss and
  grad_norm within 1e-5 relative, every parameter within 1e-6 absolute
  (updates are ~lr = 1e-3; float32 rounding of the gradients moves them by
  far less).
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.pipeline import make_train_batches
from ..models.layers import tree_leaves, tree_map
from ..optim.optimizer import AdamWConfig, adamw_init
from ..train.step import make_train_step

BWD_TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -8, 2.0 ** -6)}
STEP_OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
STEP_TOLS = {"loss_rel": 1e-5, "grad_norm_rel": 1e-5, "param_abs": 1e-6}
SMALL = (4, 64)           # (global batch, sequence) of the reduced runs


def bwd_error(out, ref, dtype: str) -> tuple[float, float]:
    """(largest |out - ref| over its limit, largest |out - ref|) of one
    backward output against its plain version, at ``BWD_TOLS[dtype]``;
    within the limit when the first is <= 1."""
    a, r = out.float(), ref.float()
    s, rt = BWD_TOLS[dtype]
    d = (a - r).abs()
    limit = s * r.abs().max() + rt * r.abs()
    over = torch.where(d == 0, torch.zeros_like(d), d / limit)
    return over.max().item(), d.max().item()


def run_steps(cfg, params, steps: int, *, device):
    """``steps`` train steps of ``cfg`` at (B, S) = ``SMALL`` on
    ``device`` from a copy of ``params`` (float32 leaves anywhere), on
    ``make_train_batches``' stream, with ``STEP_OPT``.  Returns (params on
    the CPU, [metrics of each step as floats])."""
    p = tree_map(lambda t: t.detach().to(device).clone().requires_grad_(
        True), params)
    opt = adamw_init(p)
    step_fn = make_train_step(cfg, STEP_OPT)
    hist = []
    for step, b in make_train_batches(cfg, *SMALL, device=device):
        if step >= steps:
            break
        p, opt, met = step_fn(p, opt, b)
        hist.append({k: float(v) for k, v in met.items()})
    return tree_map(lambda t: t.detach().cpu(), p), hist


def steps_differ(a_hist, b_hist, a_params, b_params) -> dict:
    """The largest differences between two runs of ``run_steps``: loss and
    grad_norm relative, parameters absolute."""
    rel = lambda x, y: abs(x - y) / max(abs(y), 1e-30)  # noqa: E731
    return {
        "loss_rel": max(rel(a["loss"], b["loss"])
                        for a, b in zip(a_hist, b_hist)),
        "grad_norm_rel": max(rel(a["grad_norm"], b["grad_norm"])
                             for a, b in zip(a_hist, b_hist)),
        "param_abs": max((x - y).abs().max().item() for x, y in zip(
            tree_leaves(a_params), tree_leaves(b_params)))}


def within_step_tols(diff: dict) -> bool:
    return all(diff[k] <= STEP_TOLS[k] for k in STEP_TOLS)


def restart_drill(cfg, ckpt_dir: str, *, device):
    """``run_with_restarts`` to 6 steps at (B, S) = ``SMALL`` with an
    injected failure after step 3 and a checkpoint every 2 steps, and the
    same run uninterrupted.  Returns (restarts, whether every parameter
    and moment is bit-equal, the two final histories)."""
    from ..runtime.fault_tolerance import run_with_restarts
    from ..train.trainer import Trainer

    def make(ckpt):
        return lambda: Trainer(cfg, *SMALL, opt_cfg=STEP_OPT, ckpt_dir=ckpt,
                               ckpt_every=2, log_every=1, device=device)

    drill, restarts = run_with_restarts(make(ckpt_dir), 6,
                                        failure_steps=(3,))
    whole = make(None)().run(6)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((drill["params"], drill["opt_state"])),
        tree_leaves((whole["params"], whole["opt_state"]))))
    return restarts, same, drill["history"], whole["history"]


def reduced_float32(cfg):
    """A reduced config in float32 compute (the tight comparisons)."""
    return dataclasses.replace(cfg, compute_dtype="float32").reduced()


def rescale_attention(cfg, params):
    """Put ``wq`` / ``wk`` at fan-in d, in place (``tests/
    test_torch_models.py``'s conditioning): the reference's "scaled" init
    reads the head count as their fan-in, so attention scores come out
    with std ~30 and the softmax is nearly an argmax, where float32
    rounding alone moves the loss; the tight card == CPU runs rescale both
    sides' weights.  Returns ``params``."""
    H, Kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    with torch.no_grad():
        for stage in params["stages"]:
            for lay in stage.values():
                if "wq" in lay["attn"]:
                    lay["attn"]["wq"].mul_((H / d) ** 0.5)
                    lay["attn"]["wk"].mul_((Kh / d) ** 0.5)
    return params
