"""The port's training path against the JAX reference on the CPU: the
loss, every gradient, the train step, AdamW and remat.

Weights are carried across with ``convert.params_from_jax`` from the
reference's own init, on ``stablelm_3b.reduced()`` (MHA) and
``yi_9b.reduced()`` (GQA, G = 4), each in float32 compute (tight) and at
the configs' own bfloat16 compute.  As in ``tests/test_torch_models.py``,
``wq`` / ``wk`` are rescaled to fan-in d on both sides: at the reference's
init the attention scores have std ~30 and float32 rounding alone moves
its loss, so no tight bound could tell a right port from a wrong one.
The reference's step is its jitted ``make_train_step`` outside a mesh
(its sharding constraints are no-ops there).

Tolerances, with their reasons:

* loss and metrics: float32 1e-5 (observed ~5e-7: float32 sums in
  other orders); bfloat16 2e-3 (observed ~4e-4: each side rounds
  activations to bf16 after every matmul and norm, in other orders).
* gradients, per leaf, against the leaf's largest |g|: float32 1e-4
  (observed <= 1e-6); bfloat16 2^-5 (observed <= 1.2e-2: one bf16 ulp of
  an activation is 2^-8 relative, and a leaf's gradient sums many).
* the train step uses ``train_cases.STEP_OPT`` (lr 1e-3 after one warm-up
  step, eps 1e-3): with the default eps 1e-8 the first AdamW step moves a
  weight by ~lr sign(g), so a gradient element within rounding noise of 0
  moves its weight by up to 2 lr between two correct implementations; with
  eps 1e-3 the update is smooth in g (its slope at most lr / eps = 1).
  Float32: ``mu`` 1e-4 and ``nu`` 2e-4 of the leaf's largest entry, the
  parameters 2e-6 absolute, grad_norm 1e-5 relative, lr 1e-6 relative,
  the step equal.  Bfloat16: ``mu`` 2^-5 and ``nu`` 2^-4 (g^2 doubles the
  relative error), the parameters 2 lr (the most any first step can differ
  by), grad_norm 2e-2 relative.
* AdamW and the schedule alone, on the same float32 inputs: 1e-6
  relative, 1e-7 absolute (the same operations, float32 pow and cos from
  two libraries).
* the three remat policies: bit for bit (remat changes what is kept, not
  a value).
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
from repro.optim import optimizer as ref_opt
from repro.train import step as ref_step

from repro_torch.bench.train_cases import STEP_OPT
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import Model, train_inputs
from repro_torch.optim import optimizer as port_opt
from repro_torch.train.step import make_train_step, train_state_specs

ARCHS = ("stablelm_3b", "yi_9b")
DTYPES = ("float32", "bfloat16")
B, S = 4, 64
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
REF_OPT = ref_opt.AdamWConfig(**dataclasses.asdict(STEP_OPT))


def _rescale(rcfg, rp):
    for stage in rp["stages"]:
        for lay in stage.values():
            a = dict(lay["attn"])
            if "wq" in a:
                a["wq"] = a["wq"] * math.sqrt(rcfg.num_heads / rcfg.d_model)
                a["wk"] = a["wk"] * math.sqrt(rcfg.num_kv_heads
                                              / rcfg.d_model)
            lay["attn"] = a
    return rp


def _pair(arch, dtype, *, rescale=True, **over):
    """(reference model, reference params, port model, port params with
    requires_grad) on the reduced config in ``dtype`` compute."""
    over = dict(compute_dtype=dtype, **over)
    rcfg = dataclasses.replace(ref_get_config(arch), **over).reduced()
    pcfg = dataclasses.replace(get_config(arch), **over).reduced()
    rm = ref_model.Model(rcfg)
    rp = rm.init(jax.random.PRNGKey(1))
    if rescale:
        rp = _rescale(rcfg, rp)
    pp = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu")
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    return rm, rp, Model(pcfg), pp


def _batch(cfg, step=0, b=B, s=S):
    """The synthetic stream's batch as numpy int32 arrays."""
    return SyntheticTokens(cfg.vocab_size, s, b, seed=3).batch(step)


def _ref_b(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def _port_b(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _walk(port_tree, path):
    node = port_tree
    for key in path:
        node = node[key.key if hasattr(key, "key") else key.idx]
    return node


def _leaves_close(ref_tree, port_tree, rel, what, *, atol=0.0):
    """Every leaf within ``rel`` of its largest |entry| (plus ``atol``)."""
    for path, r in jax.tree_util.tree_leaves_with_path(ref_tree):
        r = np.asarray(r, np.float32)
        p = _walk(port_tree, path).detach().float().numpy()
        assert p.shape == r.shape, (what, path)
        err = np.abs(p - r).max()
        assert err <= rel * np.abs(r).max() + atol, (
            what, jax.tree_util.keystr(path), err, np.abs(r).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_every_gradient_match_the_reference(arch, dtype):
    rm, rp, pm, pp = _pair(arch, dtype)
    nb = _batch(pm.cfg)
    (r_loss, r_met), r_g = jax.jit(jax.value_and_grad(
        rm.loss, has_aux=True))(rp, _ref_b(nb))
    loss, met = pm.loss(pp, _port_b(nb))
    assert sorted(met) == sorted(r_met) == ["loss", "nll", "tokens"]
    assert met["tokens"] == int(r_met["tokens"]) == B * S
    for k in ("loss", "nll"):
        assert abs(float(met[k].detach()) - float(r_met[k])) <= LOSS_TOL[
            dtype], k
    loss.backward()
    _leaves_close(r_g, tree_map(lambda p: p.grad, pp), GRAD_TOL[dtype],
                  "grad")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [1, 2])
def test_train_step_matches_the_reference_jitted_step(arch, dtype, M):
    rm, rp, pm, pp = _pair(arch, dtype)
    nb = _batch(pm.cfg, step=1)
    r_step = jax.jit(ref_step.make_train_step(rm.cfg, REF_OPT, M))
    r_p, r_o, r_m = r_step(rp, ref_opt.adamw_init(rp), _ref_b(nb))
    p, o, m = make_train_step(pm.cfg, STEP_OPT, M)(
        pp, port_opt.adamw_init(pp), _port_b(nb))
    f32 = dtype == "float32"
    assert int(o["step"]) == int(r_o["step"]) == 1
    assert float(m["lr"]) == pytest.approx(float(r_m["lr"]), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(
        float(r_m["grad_norm"]), rel=1e-5 if f32 else 2e-2)
    assert abs(float(m["loss"]) - float(r_m["loss"])) <= LOSS_TOL[dtype]
    assert abs(float(m["nll"]) - float(r_m["nll"])) <= LOSS_TOL[dtype]
    _leaves_close(r_o["mu"], o["mu"], 1e-4 if f32 else 2.0 ** -5, "mu")
    _leaves_close(r_o["nu"], o["nu"], 2e-4 if f32 else 2.0 ** -4, "nu")
    _leaves_close(r_p, p, 0.0, "params",
                  atol=2e-6 if f32 else 2 * STEP_OPT.lr + 1e-6)
    assert all(t.grad is None for t in tree_leaves(p))


def test_adamw_update_and_cosine_schedule_match_the_reference(rng):
    """Three AdamW steps on the same float32 tree (a stacked 3-D leaf, a
    matrix, a vector), the first two with the clip active, against the
    reference's jitted ``adamw_update``; the schedule over steps 0 ..
    total + 1."""
    cfg = port_opt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=12)
    rcfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
    shapes = {"stack": (3, 8, 5), "w": (7, 4), "b": (9,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    r_p = jax.tree.map(jnp.asarray, params)
    r_s = ref_opt.adamw_init(r_p)
    p = {k: torch.tensor(v) for k, v in params.items()}
    s = port_opt.adamw_init(p)
    r_upd = jax.jit(lambda g, st, pr: ref_opt.adamw_update(rcfg, g, st, pr))
    for step, scale in enumerate((30.0, 3.0, 0.01)):
        grads = {k: (rng.normal(size=sh) * scale).astype(np.float32)
                 for k, sh in shapes.items()}
        r_p, r_s, r_stats = r_upd(jax.tree.map(jnp.asarray, grads), r_s,
                                  r_p)
        p, s, stats = port_opt.adamw_update(
            cfg, {k: torch.tensor(v) for k, v in grads.items()}, s, p)
        assert int(s["step"]) == int(r_s["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            assert float(stats[k]) == pytest.approx(float(r_stats[k]),
                                                    rel=1e-6), k
        for tree, r_tree in ((p, r_p), (s["mu"], r_s["mu"]),
                             (s["nu"], r_s["nu"])):
            for k in shapes:
                np.testing.assert_allclose(tree[k].numpy(), r_tree[k],
                                           rtol=1e-6, atol=1e-7)
    steps = np.arange(cfg.total_steps + 2)
    np.testing.assert_allclose(
        [float(port_opt.cosine_schedule(cfg, int(t))) for t in steps],
        np.asarray(jax.vmap(lambda t: ref_opt.cosine_schedule(rcfg, t))(
            jnp.asarray(steps, jnp.int32))), rtol=1e-6)
    assert float(port_opt.cosine_schedule(cfg, 0)) == pytest.approx(
        cfg.lr / cfg.warmup_steps, rel=1e-6)


def test_the_three_remat_policies_give_equal_gradients():
    for arch in ARCHS:
        grads = []
        for policy in ("none", "full", "dots"):
            _, _, pm, pp = _pair(arch, "bfloat16", remat_policy=policy)
            loss, _ = pm.loss(pp, _port_b(_batch(pm.cfg)))
            loss.backward()
            grads.append([p.grad for p in tree_leaves(pp)])
        for g in grads[1:]:
            assert all(torch.equal(a, b) for a, b in zip(grads[0], g)), arch


def test_deepseek_loss_and_metrics_match_the_reference():
    """Reduced deepseek-v3 (MLA, MoE with a shared expert, the MTP head),
    float32 compute, forward only: loss, nll, the router's aux and the MTP
    nll at the float32 loss tolerance."""
    rcfg = dataclasses.replace(ref_get_config("deepseek_v3_671b"),
                               compute_dtype="float32").reduced()
    pcfg = dataclasses.replace(get_config("deepseek_v3_671b"),
                               compute_dtype="float32").reduced()
    rm = ref_model.Model(rcfg)
    rp = rm.init(jax.random.PRNGKey(1))
    pp = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu")
    nb = _batch(pcfg, b=2, s=32)
    _, r_met = jax.jit(rm.loss)(rp, _ref_b(nb))
    with torch.no_grad():
        _, met = Model(pcfg).loss(pp, _port_b(nb))
    assert sorted(met) == sorted(r_met) == ["loss", "moe_aux", "mtp_nll",
                                             "nll", "tokens"]
    for k in ("loss", "nll", "moe_aux", "mtp_nll"):
        assert float(met[k]) == pytest.approx(float(r_met[k]), rel=1e-5,
                                              abs=1e-5), k


def test_train_inputs_and_state_specs_match_the_reference():
    for arch in ("stablelm_3b", "llama_3_2_vision_90b",
                 "seamless_m4t_large_v2"):
        rcfg, pcfg = ref_get_config(arch).reduced(), get_config(
            arch).reduced()
        ref = ref_model.train_inputs(rcfg, 2, 16)
        port = train_inputs(pcfg, 2, 16)
        assert sorted(ref) == sorted(port)
        for k, (shape, dt) in port.items():
            assert shape == ref[k].shape, (arch, k)
            assert str(dt).removeprefix("torch.") == ref[k].dtype.name
    r_p, r_o, r_b = ref_step.train_state_specs(
        ref_get_config("yi_9b").reduced(), 2, 16)
    p, o, b = train_state_specs(get_config("yi_9b").reduced(), 2, 16)
    for ref_t, port_t in ((r_p, p), (r_o["mu"], o["mu"]), (r_b, b)):
        for path, r in jax.tree_util.tree_leaves_with_path(ref_t):
            t = _walk(port_t, path)
            assert tuple(t.shape) == r.shape and t.device.type == "meta"
    assert o["step"].dtype == torch.int32


@pytest.mark.parametrize("mask_last", [False, True])
def test_chunked_cross_entropy_masks_the_padded_vocab(rng, mask_last):
    """The loss over a padded head (columns >= valid_vocab masked, as
    stablelm-3b's 50 304 in 50 432) and its gradients against the
    reference's ``chunked_cross_entropy``, float32, at 1e-5; a chunk
    count that does not divide S falls back to one chunk as there."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 80)) * 0.3).astype(np.float32)
    lab = rng.integers(0, 70, (2, 24)).astype(np.int32)
    for chunks in (4, 5):
        def ref(x, w):
            return ref_layers.chunked_cross_entropy(
                x, w, jnp.asarray(lab), num_chunks=chunks, valid_vocab=70,
                mask_last=mask_last)[0]
        r_nll, r_g = jax.value_and_grad(ref, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
        xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
        nll, n_tok = layers.chunked_cross_entropy(
            xt, wt, torch.tensor(lab), num_chunks=chunks, valid_vocab=70,
            mask_last=mask_last)
        assert n_tok == 48 - (2 if mask_last else 0)
        assert float(nll.detach()) == pytest.approx(float(r_nll), abs=1e-5)
        nll.backward()
        for t, g in zip((xt, wt), r_g):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       atol=1e-5, rtol=1e-5)
        assert wt.grad[:, 70:].abs().max() == 0     # masked columns
