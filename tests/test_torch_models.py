"""The port's dense, MoE, RWKV and hybrid decoders against the JAX
reference model.

Weights are carried across with ``convert.params_from_jax`` from the
reference's own random init, and the same token ids go to both sides, on
``yi_9b.reduced()`` (GQA, 4 layers, d = 128), ``stablelm_3b.reduced()``
(MHA), ``moonshot_v1_16b_a3b.reduced()`` (MoE: 8 experts, top-2, expert
d_ff 64, capacity factor 4, so prefill and decode drop no pair),
``rwkv6_7b.reduced()`` (RWKV6: 4 layers, d 128, H 4, N 32; prefill's WKV
in the kernel's plain version, decode's in ``wkv_step``) and
``jamba_1_5_large_398b.reduced()`` (hybrid: one block of 8 layers, Mamba
d_inner 256, d_state 8, scan chunk 16, attention at layer 4, MoE of 8
experts top-2 at capacity factor 4 on every 2nd layer; prefill's scan in
the kernel's plain version, decode's in ``mamba_decode``).

Conditioning.  The reference's "scaled" init divides by the fan-in it
reads off ``shape[-2]``, which for ``wq`` / ``wk`` [d, heads, Dh] is the
head count, not d: queries and keys come out sqrt(d / heads) too large
(std 5.6 here), attention scores have std ~30 and the softmax is nearly an
argmax.  At those weights the reference's own logits move by 0.34 (yi) and
1.4 (stablelm) in bfloat16 under a 1e-4 relative weight perturbation, and
its float32 logits differ from its float64 ones by 4.0e-4 (stablelm): no
bound below that noise can tell a right port from a wrong one.  So the
tight comparisons rescale ``wq`` and ``wk`` to fan-in d (both sides get
the same weights), and one test keeps the reference's exact init.  RWKV
has no attention, so its two inits are the same; jamba's one attention
layer (``l4``) is rescaled like the others.

Tolerances, stated with their reasons:

* float32 compute, rescaled weights: the greedy tokens are equal at every
  step and the logits agree to 1e-4 (float32 sums in another order:
  ~1e-6 measured).
* float32 compute, the reference's exact weights: the greedy tokens are
  equal and the logits agree to 1e-2, far above that init's rounding noise
  (above) and far below what a wrong attention does to the logits (O(1)).
* bfloat16 compute (the configs' own), rescaled weights, teacher-forced:
  logits within 5e-2.  Each side rounds activations to bfloat16 after
  every matmul and norm, and sums in another order, so a value can round
  one ulp apart (3.9e-3 relative); at logits of scale ~4 one ulp is
  1.6e-2, and 5e-2 allows about three.  RWKV6 is held to 5e-2 plus the
  reference's own bfloat16-vs-float32 distance on the same tokens at the
  same step: at the reference's init the reduced RWKV's WKV sums ~32
  barely decayed (r.k) v terms of scale ~100 ahead of a per-head group
  norm, and the reference's own bfloat16 logits lie 0.06-0.10 from its
  float32 ones (measured over four prompts), so 5e-2 alone is below its
  own rounding noise; the port's bfloat16 logits lie as far from the
  float32 ones as the reference's do.  The same holds for the reduced
  jamba: seven Mamba layers feed bfloat16-rounded activations through
  softplus and exp(dt A) decays, and the reference's own bfloat16 logits
  lie 0.27-0.53 from its float32 ones over four prompts (the port's
  0.22-0.55 from its own), so it is held to the same rule.  Its bfloat16
  test also zeroes the routers on both sides: at the reference's router
  weights bfloat16 rounding flips a token's top-2 experts in both
  packages alike (1-4 tokens per MoE layer against float32), a discrete
  jump that no tolerance separates from a fault; with all router logits
  0 every token goes to experts 0 and 1 with weight 0.5 on both sides
  (ties keep the lower expert, ``moe.route``), so the MoE path still
  runs.  The float32 tests keep the reference's routers.
* the port's own decode-vs-forward property at ``tests/test_models.py``'s
  bound: max abs < 0.25.
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

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (Model, active_param_count, init_cache,
                                      num_params)
from repro_torch.serve.engine import _seed_caches

ARCHS = ("yi_9b", "stablelm_3b", "moonshot_v1_16b_a3b", "rwkv6_7b",
         "jamba_1_5_large_398b")
PORTED = tuple(a for a in ARCH_IDS
               if get_config(a).family in ("dense", "ssm", "hybrid")
               or (get_config(a).family == "moe" and get_config(a).mla is None))
PROMPT, STEPS = 32, 5
# held to 5e-2 plus the reference's own bf16-vs-f32 distance (docstring)
BF16_NOISY = ("rwkv6_7b", "jamba_1_5_large_398b")
# bfloat16 test with the routers zeroed on both sides (docstring)
BF16_TIED_ROUTER = ("jamba_1_5_large_398b",)


def _pair(arch, *, rescale=True, tie_router=False, **over):
    """(reference model, reference params, port model, port params) on the
    reduced config with ``over`` replaced, weights carried across;
    ``rescale`` puts ``wq`` and ``wk`` at fan-in d and ``tie_router``
    zeroes the MoE routers (see the docstring)."""
    rcfg = dataclasses.replace(ref_get_config(arch), **over).reduced()
    pcfg = dataclasses.replace(get_config(arch), **over).reduced()
    rm = ref_model.Model(rcfg)
    rp = rm.init(jax.random.PRNGKey(1))
    for stage in rp["stages"]:
        for key, lay in stage.items():
            if tie_router and "router" in lay["ffn"]:
                lay["ffn"]["router"] = jnp.zeros_like(lay["ffn"]["router"])
            if rescale and "wq" in lay["attn"]:
                a = lay["attn"]
                d = rcfg.d_model
                stage[key]["attn"] = dict(
                    a, wq=a["wq"] * math.sqrt(rcfg.num_heads / d),
                    wk=a["wk"] * math.sqrt(rcfg.num_kv_heads / d))
    return rm, rp, Model(pcfg), params_from_jax(
        jax.tree.map(np.asarray, rp), device="cpu")


def _ref_seed(caches, pre):
    def f(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return jax.lax.dynamic_update_slice_in_dim(
            dst, src.astype(dst.dtype), 0, axis=2)
    return jax.tree.map(f, caches, pre)


def _prompt(cfg, n, seed=2):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (1, n))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    rm, rp, pm, pp = _pair(arch)
    ref_leaves = jax.tree_util.tree_leaves_with_path(rp)
    port_leaves = layers.tree_leaves(pp)
    assert len(ref_leaves) == len(port_leaves) == len(
        layers.tree_leaves(pm.param_defs()))
    for path, leaf in ref_leaves:
        node = pp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert torch.equal(node, torch.from_numpy(np.asarray(leaf))), path
    if pm.cfg.family == "ssm":
        assert pp["stages"][0]["l0"]["attn"]["w_r"].shape == (
            pm.cfg.num_layers, pm.cfg.d_model, pm.cfg.d_model)
    elif pm.cfg.family == "hybrid":           # one block: repeats 1
        assert pp["stages"][0]["l0"]["attn"]["in_proj"].shape == (
            1, pm.cfg.d_model, 4 * pm.cfg.d_model)
        assert pp["stages"][0]["l4"]["attn"]["wq"].shape == (
            1, pm.cfg.d_model, pm.cfg.num_heads, pm.cfg.head_dim)
    else:
        assert pp["stages"][0]["l0"]["attn"]["wq"].shape == (
            pm.cfg.num_layers, pm.cfg.d_model, pm.cfg.num_heads,
            pm.cfg.head_dim)
    bf = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), rp), device="cpu")
    assert torch.equal(bf["head"], pp["head"].to(torch.bfloat16))


def _greedy_pair(arch, rescale, atol):
    """Greedy decode on both sides in float32 compute: equal tokens and
    logits within ``atol`` at every step."""
    rm, rp, pm, pp = _pair(arch, rescale=rescale, compute_dtype="float32")
    cfg = pm.cfg
    toks = _prompt(cfg, PROMPT)
    r_logits, r_pre = rm.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)})
    p_logits, p_pre = pm.prefill(pp, {"tokens": torch.tensor(toks)})
    r_cache = _ref_seed(ref_model.init_cache(rm.cfg, 1, PROMPT + STEPS),
                        r_pre)
    p_cache = _seed_caches(init_cache(cfg, 1, PROMPT + STEPS, device="cpu"),
                           p_pre, PROMPT)
    for step in range(STEPS):
        r = np.asarray(r_logits)
        p = p_logits.numpy()
        assert p.shape == r.shape == (1, cfg.vocab_size)
        assert np.abs(p - r).max() <= atol, (step, np.abs(p - r).max())
        r_tok, p_tok = int(np.argmax(r)), int(p_logits.argmax())
        assert r_tok == p_tok, step
        pos = PROMPT + step
        r_logits, r_cache = rm.decode_step(
            rp, r_cache, jnp.asarray([[r_tok]], jnp.int32), jnp.int32(pos))
        p_logits, p_cache = pm.decode_step(pp, p_cache,
                                           torch.tensor([[p_tok]]), pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_greedy_decode_matches_reference(arch):
    _greedy_pair(arch, rescale=True, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_greedy_tokens_match_reference_at_its_own_init(arch):
    _greedy_pair(arch, rescale=False, atol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_teacher_forced_logits_match_reference(arch):
    tie = arch in BF16_TIED_ROUTER
    rm, rp, pm, pp = _pair(arch, tie_router=tie)
    assert pm.cfg.compute_dtype == "bfloat16"
    toks = _prompt(pm.cfg, PROMPT + STEPS)
    r_logits, r_pre = rm.prefill(
        rp, {"tokens": jnp.asarray(toks[:, :PROMPT], jnp.int32)})
    p_logits, p_pre = pm.prefill(pp, {"tokens": torch.tensor(
        toks[:, :PROMPT])})
    assert p_logits.dtype == torch.bfloat16
    r_cache = _ref_seed(ref_model.init_cache(rm.cfg, 1, PROMPT + STEPS),
                        r_pre)
    p_cache = _seed_caches(init_cache(pm.cfg, 1, PROMPT + STEPS,
                                      device="cpu"), p_pre, PROMPT)
    f_logits = None
    if arch in BF16_NOISY:
        fm, fp = _pair(arch, tie_router=tie, compute_dtype="float32")[:2]
        f_logits, f_pre = fm.prefill(
            fp, {"tokens": jnp.asarray(toks[:, :PROMPT], jnp.int32)})
        f_cache = _ref_seed(ref_model.init_cache(fm.cfg, 1, PROMPT + STEPS),
                            f_pre)
    for step in range(STEPS):
        r = np.asarray(r_logits, np.float32)
        err = np.abs(p_logits.float().numpy() - r).max()
        noise = (0.0 if f_logits is None
                 else np.abs(r - np.asarray(f_logits)).max())
        assert err < 5e-2 + noise, (step, err, noise)
        if step == STEPS - 1:
            break
        pos = PROMPT + step
        tok = toks[:, pos:pos + 1]
        r_logits, r_cache = rm.decode_step(rp, r_cache,
                                           jnp.asarray(tok, jnp.int32),
                                           jnp.int32(pos))
        p_logits, p_cache = pm.decode_step(pp, p_cache, torch.tensor(tok),
                                           pos)
        if f_logits is not None:
            f_logits, f_cache = fm.decode_step(
                fp, f_cache, jnp.asarray(tok, jnp.int32), jnp.int32(pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill(S) + decode(token S) == prefill(S + 1)'s last logits, on
    the port's own random weights (bfloat16 compute)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    S = 32
    toks = torch.tensor(_prompt(cfg, S + 1))
    full, _ = model.prefill(params, {"tokens": toks})
    _, pre = model.prefill(params, {"tokens": toks[:, :S]})
    caches = _seed_caches(init_cache(cfg, 1, S + 8, device="cpu"), pre, S)
    step, _ = model.decode_step(params, caches, toks[:, S:S + 1], S)
    a, b = full.float().numpy(), step.float().numpy()
    assert np.abs(a - b).max() < 0.25


def test_cache_update_clamps_like_dynamic_update_slice():
    cache = torch.zeros(1, 6, 1, 1)
    new = torch.ones(1, 2, 1, 1)
    for pos, start in ((-3, 3), (-9, 0), (2, 2), (5, 4), (99, 4)):
        got = layers.cache_update(cache.clone(), new, pos)
        want = jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros((1, 6, 1, 1)), jnp.ones((1, 2, 1, 1)), pos, axis=1)
        assert np.array_equal(got.numpy(), np.asarray(want)), pos
        assert got[0, start:start + 2].eq(1).all()


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_equal_reference(arch):
    assert num_params(get_config(arch)) == ref_model.num_params(
        ref_get_config(arch))
    assert get_config(arch).num_params() == num_params(get_config(arch))
    assert get_config(arch).active_params() == active_param_count(
        get_config(arch)) == ref_model.active_param_count(
            ref_get_config(arch))


def test_moonshot_full_config_counts_without_materialising():
    """moonshot-v1-16b-a3b at full width: 28.06 B params, 3.97 B active
    per token, counted from the defs (nothing is allocated)."""
    cfg = get_config("moonshot_v1_16b_a3b")
    assert num_params(cfg) == ref_model.num_params(ref_get_config(
        "moonshot_v1_16b_a3b")) == 28_057_995_264
    assert active_param_count(cfg) == 3_974_301_696
    defs = Model(cfg).param_defs()
    assert defs["stages"][0]["l0"]["ffn"]["w_gate"].shape == (
        48, 64, 2048, 1408)


def test_rwkv_full_config_counts_without_materialising():
    """rwkv6-7b at full width and depth: 7.53 B params, counted from the
    defs (nothing is allocated); the state cache is [L, B, H, N, N]
    float32 whatever the context length."""
    cfg = get_config("rwkv6_7b")
    assert num_params(cfg) == ref_model.num_params(ref_get_config(
        "rwkv6_7b")) == 7_534_546_944
    assert active_param_count(cfg) == num_params(cfg)
    defs = Model(cfg).param_defs()
    assert defs["stages"][0]["l0"]["attn"]["w_r"].shape == (32, 4096, 4096)
    assert defs["stages"][0]["l0"]["attn"]["bonus_u"].shape == (32, 64, 64)
    cache = init_cache(cfg, 1, 8192, device="meta")
    S = cache[0]["l0"]["attn"]["S"]
    assert S.shape == (32, 1, 64, 64, 64) and S.dtype == torch.float32
    assert cache[0]["l0"]["ffn"]["x_prev"].shape == (32, 1, 1, 4096)


def test_jamba_full_config_counts_and_cache_without_materialising():
    """jamba-1.5-large at full width and depth: 398.6 B params as the
    reference counts them, 9 blocks of [m m m m attn m m m] with MoE on
    every 2nd layer, counted from the defs (nothing is allocated); the
    cache holds KV for the 9 attention layers and, for the 63 Mamba
    layers, h [B, d_inner, N] float32 and conv [B, K-1, d_inner]."""
    cfg = get_config("jamba_1_5_large_398b")
    assert num_params(cfg) == ref_model.num_params(ref_get_config(
        "jamba_1_5_large_398b")) == 398_555_111_424
    defs = Model(cfg).param_defs()
    (stage,) = defs["stages"]
    assert sorted(stage) == [f"l{j}" for j in range(8)]
    assert stage["l4"]["attn"]["wq"].shape == (9, 8192, 64, 128)
    assert stage["l1"]["ffn"]["w_gate"].shape == (9, 16, 8192, 24576)
    assert stage["l0"]["ffn"]["w_gate"].shape == (9, 8192, 24576)
    assert stage["l0"]["attn"]["A_log"].shape == (9, 16384, 16)
    cache = init_cache(cfg, 1, 8192, device="meta")
    h, conv = cache[0]["l0"]["attn"]["h"], cache[0]["l0"]["attn"]["conv"]
    assert h.shape == (9, 1, 16384, 16) and h.dtype == torch.float32
    assert conv.shape == (9, 1, 3, 16384) and conv.dtype == torch.bfloat16
    assert cache[0]["l4"]["attn"]["k"].shape == (9, 1, 8192, 8, 128)


def test_other_families_raise_naming_the_roadmap():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert cfg == dataclasses.replace(cfg)          # configs are data
        if arch not in PORTED:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                Model(cfg).param_defs()
    assert "deepseek_v3_671b" not in PORTED             # MoE with MLA
    assert {get_config(a).family for a in ARCH_IDS if a not in PORTED} == {
        "vlm", "encdec", "moe"}
