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

Both checks take every family's decoder layers: self-attention, MLA,
cross-attention (a vlm's xattn layers, an encdec decoder's cross
sublayers, whose static cache decode reads at S_src - 1) and the
recurrent ones.  A vlm or encdec prompt comes with its stub frontend's
input (``extra``: image_emb, or frames of ``frame_rows`` rows, and the
decode cache gets as many, so that no zero row of the cross cache enters
decode);
the encdec encoder runs once per prompt (``source_once``), and its
layers, which decode never runs, are neither recorded nor compared.

The same prefill's flash calls are kept (``keep_flash_calls``: the
encoder's non-causal ones, cross-attention's non-causal Sq != Sk ones and
MLA's at head dims nope + rope and v too) and each call's output is held
to the plain version at the card's bf16 limit,
1e-5 + 2^-6 |ref|: with the flash kernel the wrapper picks, with the
CUDA-core kernel, and with ``emulate_flash`` (plain PyTorch: the plain
version's scores, p rounded to 1, 2 or 3 bf16 parts for P.V), which shows
what the rounding of p alone does on these inputs.

One JSON line per prompt::

    PYTHONPATH=src python -m repro_torch.bench.decode_vs_forward \\
        --arch stablelm_3b yi_9b --prompts 8

(``--arch seamless_m4t_large_v2`` fits the card at full size; the vlm
and deepseek-v3 do not, and ``chip_smoke.py`` runs these checks on its
cuts of them.)

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
from repro_torch.models import model as model_mod
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model, init_cache
from repro_torch.serve.engine import _seed_caches

# The teacher-forced bound, relative to the row's largest element: four
# bf16 units of it.  A decode step one position off or an unseeded cache
# moves some layer by 64 % to 133 % (``main`` on an H100, yi-9b and
# stablelm-3b)
LAYER_TOL = 2.0 ** -6
BF16_LIMIT = (1e-5, 2.0 ** -6)     # chip_smoke's ATTN_TOLS["bfloat16"]
PAD = 8                            # the decode cache holds S + PAD rows


class TeacherForcedLayers:
    """Wraps ``transformer.apply_layer`` while active.  With ``record``
    set, a prefill keeps each decoder layer's input and output at token
    ``row`` (the encoder's layers, mode "train", pass through);
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
        if self.record and ctx["mode"] == "prefill":
            self.rows.append((x[:, self.row:self.row + 1].clone(),
                              y[:, self.row:self.row + 1].clone()))
        return y, c


@contextlib.contextmanager
def source_once():
    """While active, the model's cross-attention source (the encdec
    encoder's output over the frames, or the image embeddings) is made
    once per input tensor and reused by later prefills of the same
    prompt."""
    source, memo = model_mod._source, {}

    def once(cfg, params, batch):
        key = tuple((k, id(v)) for k, v in sorted(batch.items())
                    if k != "tokens")
        if key not in memo:
            memo[key] = (batch, source(cfg, params, batch))
        return memo[key][1]

    model_mod._source = once
    try:
        yield
    finally:
        model_mod._source = source


@contextlib.contextmanager
def keep_flash_calls(kept: list):
    """While active, every flash_attention call of the model code appends
    (q, k, v, out, route, causal) to ``kept`` (route None on the CPU)."""
    def keeping(q, k, v, *, causal=True):
        out = flash_attention_fwd(q, k, v, causal=causal)
        kept.append((q, k, v, out, getattr(flash_attention_fwd, "last_route",
                                           None) if q.is_cuda else None,
                     causal))
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


def frame_rows(cfg, n: int) -> int:
    """The frames a prompt needs for a cache of at least ``n`` rows: n, or
    n rounded up to whole ``attn_chunk`` blocks past one (the flash
    contract: a sequence longer than the chunk is whole chunks)."""
    c = cfg.attn_chunk
    return n if n <= c else -(-n // c) * c


def stub_inputs(cfg, frames: int, seed: int, device) -> dict:
    """A prompt's stub frontend input, made with numpy from ``seed`` as
    ``tests/test_models.py:make_batch`` makes it (normal x 0.05, rounded
    to bfloat16): vlm image_emb [1, num_image_tokens, d]; encdec frames
    [1, frames, d] (``frame_rows`` of the decode cache's rows); {} for
    the other families."""
    if cfg.family == "vlm":
        key, rows = "image_emb", cfg.num_image_tokens
    elif cfg.family == "encdec":
        key, rows = "frames", frames
    else:
        return {}
    x = np.random.default_rng(seed).normal(size=(1, rows, cfg.d_model))
    return {key: torch.tensor(x * 0.05).to(device=device,
                                           dtype=torch.bfloat16)}


def _decode_caches(model, params, toks, S, seed_cache: bool, extra):
    """Caches of prefill(S): S + ``PAD`` rows, or as many as the frames."""
    _, pre = model.prefill(params, {"tokens": toks[None, :S], **extra})
    rows = extra["frames"].shape[1] if "frames" in extra else S + PAD
    caches = init_cache(model.cfg, 1, rows, device=toks.device)
    return _seed_caches(caches, pre, S) if seed_cache else caches


def layer_by_layer(model, params, toks, S: int, *, pos: int | None = None,
                   seed_cache: bool = True, extra=None) -> list[float]:
    """Teacher-forced decode at token S (``pos`` overrides the position
    the step is given): each decoder layer's relative difference from the
    prefill of S + 1 tokens.  ``extra``: the prompt's image_emb or frames
    (at least S + ``PAD`` rows: ``frame_rows``)."""
    extra = extra or {}
    with TeacherForcedLayers(S) as tf, source_once():
        tf.record = True
        model.prefill(params, {"tokens": toks[None, :S + 1], **extra})
        tf.record = False
        caches = _decode_caches(model, params, toks, S, seed_cache, extra)
        model.decode_step(params, caches, toks[None, S:S + 1],
                          S if pos is None else pos)
    return tf.rel


def free_running(model, params, toks, S: int, *, extra=None) -> float:
    """Largest |difference| of the last logits of prefill(S) + decode and
    prefill(S + 1)."""
    extra = extra or {}
    with source_once():
        full, _ = model.prefill(params, {"tokens": toks[None, :S + 1],
                                         **extra})
        caches = _decode_caches(model, params, toks, S, True, extra)
    step, _ = model.decode_step(params, caches, toks[None, S:S + 1], S)
    return (full.float() - step.float()).abs().max().item()


def flash_on_layers(model, params, toks, S: int, *, extra=None) -> dict:
    """Each flash call in prefill(S + 1) (the encoder's too), held to the
    plain version: the largest err/limit over the calls of the routed
    kernel, the CUDA-core kernel and the emulated 1, 2 and 3-part p."""
    kept = []
    with keep_flash_calls(kept):
        model.prefill(params, {"tokens": toks[None, :S + 1],
                               **(extra or {})})
    worst = {}
    for q, k, v, out, route, causal in kept:
        ref = flash_attention_ref(q, k, v, causal=causal)
        outs = {"routed": out, "simt": flash_kernel._launch(q, k, v, causal,
                                                            "simt")}
        outs.update({f"emulated p in {n} bf16 parts": emulate_flash(
            q, k, v, causal, parts=n) for n in (1, 2, 3)})
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
            extra = stub_inputs(cfg, frame_rows(cfg, S + PAD), 200 + i, dev)
            row = {"arch": arch, "prompt": i, "S": S,
                   "device": torch.cuda.get_device_name(dev)}
            for kernel in ("routed", "simt"):
                if kernel == "simt":
                    flash_kernel._flash_route = lambda *_, **__: "simt"
                try:
                    row[kernel] = {
                        "free_running_logits": free_running(
                            model, params, toks, S, extra=extra),
                        "layer_by_layer_max": max(layer_by_layer(
                            model, params, toks, S, extra=extra))}
                finally:
                    flash_kernel._flash_route = routed
            row["fault_pos_minus_1"] = max(layer_by_layer(
                model, params, toks, S, pos=S - 1, extra=extra))
            row["fault_unseeded_cache"] = max(layer_by_layer(
                model, params, toks, S, seed_cache=False, extra=extra))
            row["flash_err_over_limit"] = flash_on_layers(
                model, params, toks, S, extra=extra)
            print(json.dumps(row), flush=True)
        del model, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
