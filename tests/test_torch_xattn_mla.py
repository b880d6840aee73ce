"""The port's cross-attention, MLA and encoder modules against the JAX
reference's, one layer at a time, and the reference's R6 fault.

Inputs are made with numpy from a seed and go to both sides: a layer's
weights (normal / sqrt(fan-in) along the model dimension, so that the
scores stay of order one; the vlm gate at 0.5), activations x and the
cross-attention source (normal, the source x 0.05 as
``tests/test_models.py:make_batch`` makes frames and image embeddings).

* ``xattn_apply`` (vlm: the tanh-gated cross-attention layer; encdec: the
  decoder's cross sublayer, no gate): prefill projects K and V from the
  source and runs non-causal flash attention with Sq != Sk; decode reads
  the static cache at S_src - 1.
* ``mla_apply`` (deepseek-v3's MLA): prefill expands the latent and runs
  causal flash attention at head dims nope + rope and v; decode runs the
  absorbed form against the latent cache, written in place at ``pos``.
* ``_encode``: the seamless encoder (non-causal, RoPE over the frames,
  its own final norm).
* R6: frames of 33 rows against a serving cache of 40, the shapes of
  ``tests/test_models.py``: the reference's cross cache has
  ``num_frame_tokens or seq`` = 40 rows, and its decode attends over the
  7 zero rows after the frames, so prefill(32) + decode differs from
  prefill(33).  The port keeps that function: its decode equals the
  reference's.

Tolerances: float32 1e-5 (float32 sums in another order, ~1e-6
measured); bfloat16 two units in the last place of each element plus
1e-2 absolute for the layer outputs (each side rounds its projections,
norms and attention output to bfloat16 and sums in another order, so an
element can round one unit apart; an output's sum of H x D products then
moves by a few units of its inputs' scale, ~1e-2 at these widths).  The
encoder is two layers deep, each with its bfloat16 residual sums, and
its bfloat16 output (after its norm, of scale ~1.5) is held to
``tests/test_torch_models.py``'s bfloat16 limit, 5e-2 (about three units
in the last place at 2; 3.1e-2 measured); so is the model-level R6
check.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import _torch_jaxref  # noqa: F401  (the R1 alias, before any repro import)

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models import transformer as ref_T

from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import model as port_model
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import init_cache
from repro_torch.serve.engine import _seed_caches

from test_torch_models import _pair, _ref_seed

TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-2, 2.0 ** -7)}


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_get_config(arch),
                                compute_dtype=dtype).reduced(),
            dataclasses.replace(get_config(arch),
                                compute_dtype=dtype).reduced())


def _weights(defs, rng):
    """numpy weights for a PDef tree: normal / sqrt(d) on the model
    dimension (the first axis of a projection), ones for norms, 0.5 for
    the gate."""
    def make(d):
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        if not d.shape:
            return np.float32(0.5)
        return (rng.normal(size=d.shape) / math.sqrt(d.shape[0])).astype(
            np.float32)
    return layers.tree_map(make, defs)


def _both(tree, dtype):
    """(jax tree, torch tree) of the same numpy leaves in ``dtype``."""
    jt = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    return jt, params_from_jax(jax.tree.map(np.asarray, jt), device="cpu")


def _close(got, want, dtype, what, tol=None):
    atol, rtol = tol or TOL[dtype]
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    err = np.abs(got - want)
    assert (err <= atol + rtol * np.abs(want)).all(), (what, err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama_3_2_vision_90b",
                                  "seamless_m4t_large_v2"])
def test_xattn_apply_matches_reference(arch, dtype):
    """Prefill (non-causal flash, Sq 24 against S_src 40 or 16) and decode
    (the static cache at S_src - 1) of one cross-attention layer."""
    rcfg, pcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(0)
    defs = T.xattn_param_defs(pcfg)
    assert ("gate" in defs) == (pcfg.family == "vlm")
    S, S_src, d = 24, (pcfg.num_image_tokens if pcfg.family == "vlm"
                       else 40), pcfg.d_model
    (jp, tp) = _both(_weights(defs, rng), dtype)
    (jx, tx) = _both(rng.normal(size=(1, S, d)), dtype)
    (js, ts) = _both(rng.normal(size=(1, S_src, d)) * 0.05, "bfloat16")
    r_out, r_cache = ref_T.xattn_apply(
        rcfg, jp, jx, {"mode": "prefill", "src": js}, None,
        ref_T.LayerSpec("xattn"))
    p_out, p_cache = T.xattn_apply(
        pcfg, tp, tx, {"mode": "prefill", "src": ts}, None,
        T.LayerSpec("xattn"))
    _close(p_out, r_out, dtype, "prefill out")
    for name in ("k", "v"):
        assert p_cache[name].shape == (1, S_src, pcfg.num_kv_heads,
                                       pcfg.head_dim)
        _close(p_cache[name], r_cache[name], dtype, name)
    # decode one token against the reference's own cache on both sides
    (jq, tq) = _both(rng.normal(size=(1, 1, d)), dtype)
    r_out, r_new = ref_T.xattn_apply(rcfg, jp, jq, {"mode": "decode"},
                                     r_cache, ref_T.LayerSpec("xattn"))
    cache = {n: torch.from_numpy(np.asarray(r_cache[n], np.float32)).to(
        p_cache[n].dtype) for n in ("k", "v")}
    ctx = port_model._make_ctx(pcfg, "decode", torch.tensor([S]), S, 1,
                               src_len=S_src)
    assert ctx["src_pos_b"].tolist() == [S_src - 1]
    p_out, p_new = T.xattn_apply(pcfg, tp, tq, ctx, cache,
                                 T.LayerSpec("xattn"))
    assert p_new is cache                       # static across decode
    _close(p_out, r_out, dtype, "decode out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_reference(dtype):
    """deepseek-v3's MLA at the reduced widths: prefill (flash at head
    dims 48 and 32, causal) with its latent caches, then decode in the
    absorbed form at pos = S against a cache of S + 4 rows, the latent
    written in place."""
    rcfg, pcfg = _cfgs("deepseek_v3_671b", dtype)
    m = pcfg.mla
    rng = np.random.default_rng(1)
    S, d = 24, pcfg.d_model
    (jp, tp) = _both(_weights(T.mla_param_defs(pcfg), rng), dtype)
    (jx, tx) = _both(rng.normal(size=(1, S + 1, d)), dtype)
    spec_r, spec_p = ref_T.LayerSpec("mla"), T.LayerSpec("mla")
    rctx = ref_model._make_ctx(rcfg, "prefill", jnp.arange(S))
    pctx = port_model._make_ctx(pcfg, "prefill", torch.arange(S))
    r_out, r_cache = ref_T.mla_apply(rcfg, jp, jx[:, :S], rctx, None, spec_r)
    p_out, p_cache = T.mla_apply(pcfg, tp, tx[:, :S], pctx, None, spec_p)
    _close(p_out, r_out, dtype, "prefill out")
    assert p_cache["c_kv"].shape == (1, S, m.kv_lora_rank)
    assert p_cache["k_rope"].shape == (1, S, m.rope_dim)
    for name in ("c_kv", "k_rope"):
        _close(p_cache[name], r_cache[name], dtype, name)
    # decode token S against the reference's prefill latent, seeded into
    # caches of S + 4 rows on both sides
    r_full = {n: jnp.zeros((1, S + 4) + r_cache[n].shape[2:],
                           r_cache[n].dtype).at[:, :S].set(r_cache[n])
              for n in r_cache}
    p_full = {n: torch.from_numpy(np.asarray(r_full[n], np.float32)).to(
        p_cache[n].dtype) for n in r_full}
    rctx = ref_model._make_ctx(rcfg, "decode", jnp.asarray(S)[None], pos=S)
    pctx = port_model._make_ctx(pcfg, "decode", torch.tensor([S]), S, 1)
    r_out, r_new = ref_T.mla_apply(rcfg, jp, jx[:, S:], rctx, r_full, spec_r)
    c_kv = p_full["c_kv"]
    p_out, p_new = T.mla_apply(pcfg, tp, tx[:, S:], pctx, p_full, spec_p)
    assert p_new["c_kv"] is c_kv               # updated in place
    _close(p_out, r_out, dtype, "decode out")
    for name in ("c_kv", "k_rope"):
        _close(p_new[name], r_new[name], dtype, name + " after decode")
    assert p_new["c_kv"][:, S + 1:].eq(0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype):
    """The seamless encoder (2 reduced layers, non-causal) over 40 frames,
    weights carried from the reference's init (attention rescaled as in
    the model tests)."""
    rm, rp, pm, pp = _pair("seamless_m4t_large_v2", compute_dtype=dtype)
    rng = np.random.default_rng(2)
    (jf, tf) = _both(rng.normal(size=(1, 40, pm.cfg.d_model)) * 0.05,
                     "bfloat16")
    want = ref_model._encode(rm.cfg, rp, jf)
    got = port_model._encode(pm.cfg, pp, tf)
    assert got.dtype == layers.dtype_of(dtype) and got.shape == (
        1, 40, pm.cfg.d_model)
    _close(got, want, dtype, "encoder out",
           (5e-2, 0.0) if dtype == "bfloat16" else None)


def test_r6_encdec_decode_attends_over_zero_rows_like_the_reference():
    """Frames of 33 rows, a serving cache of 40 (``tests/test_models.py``'s
    shapes): prefill(32) + decode at token 32 attends over the cross
    cache's 7 zero rows on both sides, so it differs from prefill(33);
    the port's decode equals the reference's within the bfloat16 limit."""
    rm, rp, pm, pp = _pair("seamless_m4t_large_v2")
    cfg = pm.cfg
    rng = np.random.default_rng(2)
    S = 32
    toks = rng.integers(1, cfg.vocab_size, (1, S + 1))
    frames = np.asarray(jnp.asarray(rng.normal(size=(1, S + 1, cfg.d_model))
                                    * 0.05, jnp.bfloat16))
    jf, tf = jnp.asarray(frames), params_from_jax(frames, device="cpu")
    assert ref_model._src_len(rm.cfg, S + 8) == port_model._src_len(
        cfg, S + 8) == S + 8
    r_full, _ = rm.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32),
                                "frames": jf})
    _, r_pre = rm.prefill(rp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32),
                               "frames": jf})
    r_cache = _ref_seed(ref_model.init_cache(rm.cfg, 1, S + 8), r_pre)
    r_step, _ = rm.decode_step(rp, r_cache, jnp.asarray(toks[:, S:],
                                                        jnp.int32),
                               jnp.int32(S))
    _, p_pre = pm.prefill(pp, {"tokens": torch.tensor(toks[:, :S]),
                               "frames": tf})
    p_cache = _seed_caches(init_cache(cfg, 1, S + 8, device="cpu"), p_pre, S)
    assert p_cache[0]["l0"]["cross"]["k"].shape[2] == S + 8
    assert p_cache[0]["l0"]["cross"]["k"][:, :, S + 1:].eq(0).all()
    p_step, _ = pm.decode_step(pp, p_cache, torch.tensor(toks[:, S:]), S)
    r_step = np.asarray(r_step, np.float32)
    r6 = np.abs(r_step - np.asarray(r_full, np.float32)).max()
    err = np.abs(p_step.float().numpy() - r_step).max()
    assert r6 > 0.1, r6                          # the zero rows entered
    assert err < 5e-2, err
