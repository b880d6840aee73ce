"""decode-vs-forward at full width, and flash attention on the served
layers' own inputs.

A decode step at token S, continuing ``prefill(S)`` through its cache, is
held against ``prefill(S + 1)`` in two ways:

* free running: the two passes' last logits (``free_running``);
* teacher forced (``layer_by_layer``): decode layer i is given the
  prefill's input to layer i at token S and its output is compared with
  the prefill's output of layer i at token S, relative to the largest
  element of that row.  Each layer is then held alone, so a wrong cache
  position, rotary offset or unseeded cache shows in the layer where it
  happens, and rounding differences between the prefill's and the
  decode's kernels (flash against decode attention, a GEMM of S + 1 rows
  against one) stay what they are in that layer instead of compounding
  through the depth.

At the reference's init the full-width models' attention is nearly an
argmax (``models/layers.py`` takes the q / k fan-in from the head count),
and free-running logits amplify a rounding difference of one bf16 unit in
one attention output into logit differences of several units.

The same prefill's flash calls are kept (``keep_flash_calls``) and each
layer's output is held to the plain version at the card's bf16 limit,
1e-5 + 2^-6 |ref|: with the flash kernel the wrapper picks, with the
CUDA-core kernel, and with ``emulate_flash`` (plain PyTorch: the plain
version's scores, p rounded to 1, 2 or 3 bf16 parts for P.V), which shows
what the rounding of p alone does on these inputs.

One JSON line per prompt::

    PYTHONPATH=src python -m repro_torch.bench.decode_vs_forward \\
        --arch stablelm_3b yi_9b --prompts 8

Weights come from ``--seed`` as ``ServingEngine`` makes them; prompt p is
``--prompt`` + 1 tokens drawn with numpy from seed 100 + p.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import layers, transformer
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model, init_cache
from repro_torch.serve.engine import _seed_caches

# The teacher-forced bound, relative to the row's largest element: four
# bf16 units of it.  A decode step one position off or an unseeded cache
# moves some layer by 64 % to 133 % (``main`` on an H100, yi-9b and
# stablelm-3b)
LAYER_TOL = 2.0 ** -6
BF16_LIMIT = (1e-5, 2.0 ** -6)     # chip_smoke's ATTN_TOLS["bfloat16"]


class TeacherForcedLayers:
    """Wraps ``transformer.apply_layer`` while active.  With ``record``
    set, a prefill keeps each layer's input and output at token ``row``;
    a decode step then runs each layer on the kept input and appends its
    output's largest difference from the kept output, over the kept
    output's largest element, to ``rel``, and passes the kept output on
    to the next layer."""

    def __init__(self, row: int):
        self.row, self.record = row, False
        self.rows, self.rel = [], []

    def __enter__(self):
        self._apply_layer = transformer.apply_layer
        transformer.apply_layer = self._apply
        return self

    def __exit__(self, *exc):
        transformer.apply_layer = self._apply_layer

    def _apply(self, cfg, spec, p, x, ctx, cache):
        if ctx["mode"] == "decode":
            x0, y0 = self.rows[len(self.rel)]
            y, c = self._apply_layer(cfg, spec, p, x0, ctx, cache)
            y0f = y0.float()
            self.rel.append(((y.float() - y0f).abs().max()
                             / y0f.abs().max()).item())
            return y0, c
        y, c = self._apply_layer(cfg, spec, p, x, ctx, cache)
        if self.record:
            self.rows.append((x[:, self.row:self.row + 1].clone(),
                              y[:, self.row:self.row + 1].clone()))
        return y, c


@contextlib.contextmanager
def keep_flash_calls(kept: list):
    """While active, every flash_attention call of the model code appends
    (q, k, v, out, route) to ``kept`` (route None on the CPU)."""
    def keeping(q, k, v, *, causal=True):
        out = flash_attention_fwd(q, k, v, causal=causal)
        kept.append((q, k, v, out, getattr(flash_attention_fwd, "last_route",
                                           None) if q.is_cuda else None))
        return out

    layers.flash_attention_fwd = keeping
    try:
        yield kept
    finally:
        layers.flash_attention_fwd = flash_attention_fwd


def err_over_limit(out, ref) -> float:
    """Largest |out - ref| / (1e-5 + 2^-6 |ref|)."""
    ref = ref.float()
    atol, rtol = BF16_LIMIT
    return ((out.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def emulate_flash(q, k, v, causal: bool, *, bk: int = 128, parts: int = 3):
    """The tensor-core flash kernel's rounding of p in plain PyTorch: q.k
    summed in float32 times the float32 scale (as the plain version), the
    masks, an online softmax over tiles of ``bk`` keys, p split into
    ``parts`` bf16 parts (hi = bf16(p), then bf16 of what is left), each
    tile's P.V of the parts summed in float32 and added to O as
    O corr + P.V, one division by max(l, 1e-30) and one rounding to q's
    dtype.  It does not model how the card sums q.k or P.V."""
    B, Sq, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    dev = q.device
    qf = q.float().reshape(B, Sq, Kh, H // Kh, D)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32, device=dev)
    m = torch.full((B, Kh, H // Kh, Sq), flash_kernel.NEG_INF, device=dev)
    l = torch.zeros(B, Kh, H // Kh, Sq, device=dev)
    o = torch.zeros(B, Kh, H // Kh, Sq, Dv, device=dev)
    qi = torch.arange(Sq, device=dev)[:, None]
    for k0 in range(0, Sk, bk):
        if causal and k0 > Sq - 1:     # above the diagonal for every row
            break
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k0 + bk]) * scale
        if causal:
            s = torch.where(torch.arange(k0, min(k0 + bk, Sk), device=dev)
                            [None, :] > qi, flash_kernel.NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        pv, rest = 0, p
        for _ in range(parts):
            part = rest.bfloat16().float()
            pv = pv + torch.einsum("bhgqk,bkhv->bhgqv", part,
                                   vf[:, k0:k0 + bk])
            rest = rest - part
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + pv
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def _decode_caches(model, params, toks, S, seed_cache: bool):
    _, pre = model.prefill(params, {"tokens": toks[None, :S]})
    caches = init_cache(model.cfg, 1, S + 8, device=toks.device)
    return _seed_caches(caches, pre, S) if seed_cache else caches


def layer_by_layer(model, params, toks, S: int, *, pos: int | None = None,
                   seed_cache: bool = True) -> list[float]:
    """Teacher-forced decode at token S (``pos`` overrides the position
    the step is given): each layer's relative difference from the
    prefill of S + 1 tokens."""
    with TeacherForcedLayers(S) as tf:
        tf.record = True
        model.prefill(params, {"tokens": toks[None, :S + 1]})
        tf.record = False
        caches = _decode_caches(model, params, toks, S, seed_cache)
        model.decode_step(params, caches, toks[None, S:S + 1],
                          S if pos is None else pos)
    return tf.rel


def free_running(model, params, toks, S: int) -> float:
    """Largest |difference| of the last logits of prefill(S) + decode and
    prefill(S + 1)."""
    full, _ = model.prefill(params, {"tokens": toks[None, :S + 1]})
    caches = _decode_caches(model, params, toks, S, True)
    step, _ = model.decode_step(params, caches, toks[None, S:S + 1], S)
    return (full.float() - step.float()).abs().max().item()


def flash_on_layers(model, params, toks, S: int) -> dict:
    """Each layer's flash call in prefill(S + 1), held to the plain
    version: the largest err/limit over the layers of the routed kernel,
    the CUDA-core kernel and the emulated 1, 2 and 3-part p."""
    kept = []
    with keep_flash_calls(kept):
        model.prefill(params, {"tokens": toks[None, :S + 1]})
    worst = {}
    for q, k, v, out, route in kept:
        ref = flash_attention_ref(q, k, v, causal=True)
        outs = {"routed": out, "simt": flash_kernel._launch(q, k, v, True,
                                                            "simt")}
        outs.update({f"emulated p in {n} bf16 parts": emulate_flash(
            q, k, v, True, parts=n) for n in (1, 2, 3)})
        for name, o in outs.items():
            worst[name] = max(worst.get(name, 0.0), err_over_limit(o, ref))
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", nargs="+", default=["stablelm_3b", "yi_9b"])
    p.add_argument("--prompt", type=int, default=511)
    p.add_argument("--prompts", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_vs_forward: no CUDA device")
    dev = torch.device("cuda", 0)
    routed = flash_kernel._flash_route
    for arch in a.arch:
        cfg = get_config(arch)
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(a.seed),
                            dtype=dtype_of(cfg.compute_dtype))
        S = a.prompt
        for i in range(a.prompts):
            toks = torch.tensor(np.random.default_rng(100 + i).integers(
                1, cfg.vocab_size, S + 1), device=dev)
            row = {"arch": arch, "prompt": i, "S": S,
                   "device": torch.cuda.get_device_name(dev)}
            for kernel in ("routed", "simt"):
                if kernel == "simt":
                    flash_kernel._flash_route = lambda *_, **__: "simt"
                try:
                    row[kernel] = {
                        "free_running_logits": free_running(
                            model, params, toks, S),
                        "layer_by_layer_max": max(layer_by_layer(
                            model, params, toks, S))}
                finally:
                    flash_kernel._flash_route = routed
            row["fault_pos_minus_1"] = max(layer_by_layer(
                model, params, toks, S, pos=S - 1))
            row["fault_unseeded_cache"] = max(layer_by_layer(
                model, params, toks, S, seed_cache=False))
            row["flash_err_over_limit"] = flash_on_layers(model, params,
                                                          toks, S)
            print(json.dumps(row), flush=True)
        del model, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
