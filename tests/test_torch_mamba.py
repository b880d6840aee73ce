"""The port's selective-scan kernel wrappers, Mamba layer and expert share
against the JAX reference.

On this CPU the wrappers ``mamba_scan_fwd`` and ``mamba_scan_fused`` run
their plain versions (``mamba_scan_ref``, ``mamba_scan_fused_ref``: the
sequential recurrence in float32).  The same inputs, made with numpy from
a seed, go to both packages.  Tolerances, stated with their reasons:

* the scans: ``tests/test_kernels.py``'s atol = rtol = 1e-4, the ceiling
  for these tests (float32 sums of the same terms in another order: the
  Pallas kernel and the model's ``associative_scan`` combine steps in a
  tree, the port walks them in order; ~1e-6 measured); with bfloat16
  inputs y comes back in bfloat16 on both sides and may round one unit
  in the last place apart (each side rounds one float32 sum), so the
  limit adds two units (2^-7 |ref| each);
* the Mamba layer on ``jamba_1_5_large_398b.reduced()`` (d 128, d_inner
  256, d_state 8, chunk 16) in float32: outputs and states within 1e-4
  (the same float32 sums; ~1e-6 measured);
* the expert share: the two halves' sum equals the uncut layer within
  1e-6 (the same float32 products, one addition of two terms each in
  another order), and a share equals the reference's layer with the
  absent experts' weights zeroed within 1e-5 (float32 sums of up to 128
  products in another order);
* the two scan halves with h_T carried equal the whole scan exactly (the
  same operations in the same order);
* ``mamba_A`` equals the reference's init exactly.

The whole hybrid model is held to the reference in
``tests/test_torch_models.py`` and the serving engine in
``tests/test_torch_serve.py``.  The CUDA kernel is held to the same plain
versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_card.py``.
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
from repro.kernels.mamba_scan import mamba_scan as ref_mamba_scan
from repro.kernels.mamba_scan import mamba_scan_ref as ref_scan_oracle
from repro.kernels.mamba_scan.kernel import mamba_scan_fwd as ref_pallas
from repro.models import layers as ref_layers
from repro.models import mamba as ref_mamba
from repro.models import model as ref_model
from repro.models import moe as ref_moe

from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import (mamba_scan_fused,
                                            mamba_scan_fused_ref,
                                            mamba_scan_fwd, mamba_scan_ref)
from repro_torch.models import mamba, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import PDef, init_params

ARCH = "jamba_1_5_large_398b"
TOL = 1e-4
# tests/test_kernels.py's shapes: B, S, d_in, N, chunk, block_d
SCAN_SHAPES = [(2, 128, 64, 16, 32, 32), (1, 64, 128, 8, 64, 64)]


def _scan_inputs(rng, B, S, d_in, N):
    """tests/test_kernels.py's inputs: a in [0.5, 0.99], b ~ 0.2 N(0, 1),
    c ~ N(0, 1), float32."""
    a = rng.uniform(0.5, 0.99, (B, S, d_in, N)).astype(np.float32)
    b = (rng.normal(size=(B, S, d_in, N)) * 0.2).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    return a, b, c


def _fused_inputs(rng, B, S, d_in, N, *, state=False):
    """dt from the model's init range (softplus^-1 of e^{U[ln 1e-3, ln
    0.1]} -> dt in [1e-3, 0.1], spread up to 0.5), A = -(1..N), Bm / C /
    u ~ N(0, 1), and a carried state."""
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(0.5), (B, S, d_in)))
    A = -np.tile(np.arange(1, N + 1), (d_in, 1))
    out = [dt, A, rng.normal(size=(B, S, N)), rng.normal(size=(B, S, d_in)),
           rng.normal(size=(B, S, N))]
    if state:
        out.append(rng.normal(size=(B, d_in, N)) * 0.5)
    return [x.astype(np.float32) for x in out]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(port, ref, *, bf16=False, tol=TOL):
    """|port - ref| <= tol + tol |ref| (+ two bfloat16 units); returns the
    largest difference measured."""
    p = port.float().numpy() if torch.is_tensor(port) else np.asarray(port)
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    assert p.shape == r.shape
    limit = tol + tol * np.abs(r)
    if bf16:   # two bfloat16 units in the last place of |ref|
        limit = limit + 2 * np.exp2(np.floor(np.log2(
            np.maximum(np.abs(r), 1e-30))) - 7)
    err = float(np.abs(p - r).max())
    print(f"max abs diff {err:.3g} (limit {tol:g} + {tol:g} |ref|"
          f"{' + 2 bf16 units' if bf16 else ''})")
    assert (np.abs(p - r) <= limit).all(), err
    return err


# --------------------------------------------------------------------------
# The reference kernel's entry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,d_in,N,chunk,bd", SCAN_SHAPES)
def test_mamba_scan_matches_pallas_kernel_and_oracle(B, S, d_in, N, chunk,
                                                     bd, rng):
    a, b, c = _scan_inputs(rng, B, S, d_in, N)
    before = mamba_scan_fwd.launches
    y = mamba_scan_fwd(*_t(a, b, c), chunk=chunk, block_d=bd)
    assert mamba_scan_fwd.launches == before             # CPU: no launch
    assert y.dtype == torch.float32 and y.shape == (B, S, d_in)
    ja, jb, jc = (jnp.asarray(x) for x in (a, b, c))
    _close(y, ref_pallas(ja, jb, jc, chunk=chunk, block_d=bd,
                         interpret=True))
    _close(y, ref_scan_oracle(ja, jb, jc))
    assert torch.equal(y, mamba_scan_ref(*_t(a, b, c)))


def test_mamba_scan_ragged_length(rng):
    """S = 40 with chunk 16: the Pallas kernel's last chunk is partial."""
    a, b, c = _scan_inputs(rng, 2, 40, 48, 16)
    y = mamba_scan_fwd(*_t(a, b, c), chunk=16, block_d=16)
    ja, jb, jc = (jnp.asarray(x) for x in (a, b, c))
    _close(y, ref_mamba_scan(ja, jb, jc, chunk=16, block_d=16))
    _close(y, ref_scan_oracle(ja, jb, jc))


@pytest.mark.parametrize("B,S,d_in,N,chunk,bd", SCAN_SHAPES)
def test_mamba_scan_bfloat16_inputs(B, S, d_in, N, chunk, bd, rng):
    a, b, c = _scan_inputs(rng, B, S, d_in, N)
    ta, tb = (torch.tensor(x).to(torch.bfloat16) for x in (a, b))
    y = mamba_scan_fwd(ta, tb, torch.tensor(c), chunk=chunk, block_d=bd)
    assert y.dtype == torch.bfloat16
    ja, jb = (jnp.asarray(x, jnp.bfloat16) for x in (a, b))
    ry = ref_pallas(ja, jb, jnp.asarray(c), chunk=chunk, block_d=bd,
                    interpret=True)
    assert ry.dtype == jnp.bfloat16
    _close(y, ry, bf16=True)
    _close(y, ref_scan_oracle(ja, jb, jnp.asarray(c)), bf16=True)


# --------------------------------------------------------------------------
# The model's fused entry
# --------------------------------------------------------------------------


def _discretise(dt, A, Bm, u):
    """The reference model's discretisation (``mamba_apply``), in jnp."""
    dt = jnp.asarray(dt)
    a = jnp.exp(dt[..., None] * jnp.asarray(A))
    b = (dt[..., None] * jnp.asarray(Bm)[:, :, None, :]) * \
        jnp.asarray(u, jnp.float32)[..., None]
    return a, b


@pytest.mark.parametrize("B,S,d_in,N", [(2, 64, 48, 16), (1, 40, 96, 8)])
def test_fused_scan_equals_discretise_then_scan(B, S, d_in, N, rng):
    dt, A, Bm, u, C = _fused_inputs(rng, B, S, d_in, N)
    y, h_T = mamba_scan_fused(*_t(dt, A, Bm, u, C))
    assert y.dtype == h_T.dtype == torch.float32
    assert h_T.shape == (B, d_in, N)
    a, b = _discretise(dt, A, Bm, u)
    _close(y, ref_scan_oracle(a, b, jnp.asarray(C)))
    # h_T: the last state of the reference's per-step recurrence
    h = jnp.zeros((B, d_in, N), jnp.float32)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
    _close(h_T, h)
    # the same with bfloat16 u (the model's compute dtype)
    ub = torch.tensor(u).to(torch.bfloat16)
    yb, _ = mamba_scan_fused(*_t(dt, A, Bm), ub, torch.tensor(C))
    a, b = _discretise(dt, A, Bm, jnp.asarray(u, jnp.bfloat16))
    _close(yb, ref_scan_oracle(a, b, jnp.asarray(C)))


def test_fused_scan_carries_its_state(rng):
    """Two halves with h_T carried equal the whole, exactly; h0 = None is
    the zero state."""
    dt, A, Bm, u, C, h0 = _fused_inputs(rng, 2, 50, 40, 16, state=True)
    whole = mamba_scan_fused(*_t(dt, A, Bm, u, C, h0))
    y1, h1 = mamba_scan_fused(*_t(dt[:, :21], A, Bm[:, :21], u[:, :21],
                                  C[:, :21], h0))
    y2, h2 = mamba_scan_fused(*_t(dt[:, 21:], A, Bm[:, 21:], u[:, 21:],
                                  C[:, 21:]), h1)
    assert torch.equal(torch.cat([y1, y2], 1), whole[0])
    assert torch.equal(h2, whole[1])
    zero = mamba_scan_fused(*_t(dt, A, Bm, u, C))
    also = mamba_scan_fused(*_t(dt, A, Bm, u, C, np.zeros_like(h0)))
    assert torch.equal(zero[0], also[0]) and torch.equal(zero[1], also[1])
    assert torch.equal(zero[0], mamba_scan_fused_ref(*_t(dt, A, Bm, u,
                                                         C))[0])


def test_scan_wrappers_check_their_inputs(rng):
    a, b, c = _t(*_scan_inputs(rng, 1, 8, 4, 16))
    with pytest.raises(TypeError, match="a and b"):
        mamba_scan_fwd(a, b.to(torch.bfloat16), c)
    with pytest.raises(ValueError, match="N <= 16"):
        big = torch.zeros(1, 2, 3, 17)
        mamba_scan_fwd(big, big, torch.zeros(1, 2, 17))
    with pytest.raises(ValueError, match="c must be"):
        mamba_scan_fwd(a, b, c[:, :4])
    dt, A, Bm, u, C, h0 = _t(*_fused_inputs(rng, 1, 8, 4, 16, state=True))
    with pytest.raises(TypeError, match="dt must be float32"):
        mamba_scan_fused(dt.to(torch.bfloat16), A, Bm, u, C)
    with pytest.raises(ValueError, match="h0"):
        mamba_scan_fused(dt, A, Bm, u, C, h0[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan_fused(dt, A, Bm, u.transpose(1, 2).contiguous()
                         .transpose(1, 2), C)


# --------------------------------------------------------------------------
# The Mamba layer at the reduced width
# --------------------------------------------------------------------------


def _layer(seed=3):
    """(ref cfg, port cfg, ref mamba params of layer 0, port ones): the
    reference's init, carried across."""
    rcfg = dataclasses.replace(ref_get_config(ARCH),
                               compute_dtype="float32").reduced()
    pcfg = dataclasses.replace(get_config(ARCH),
                               compute_dtype="float32").reduced()
    rp = ref_model.Model(rcfg).init(jax.random.PRNGKey(seed))
    lay = jax.tree.map(lambda x: np.asarray(x[0]),
                       rp["stages"][0]["l0"]["attn"])
    # a non-zero conv bias, so its cast and add are exercised
    lay["conv_b"] = np.linspace(-0.1, 0.1, lay["conv_b"].size,
                                dtype=np.float32)
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, lay),
            params_from_jax(lay, device="cpu"))


def _x(rng, cfg, S, B=2):
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _state_close(port, ref):
    assert port["h"].dtype == torch.float32
    for key in ("h", "conv"):
        _close(port[key], ref[key])


@pytest.mark.parametrize("S", [32, 40])
def test_mamba_apply_matches_reference_with_carried_state(S, rng):
    """S = 32 is two reference chunks of 16; S = 40 makes the reference
    take one chunk of 40.  A second segment starts from the first one's
    state."""
    rcfg, pcfg, jp, pp = _layer()
    x = _x(rng, pcfg, S)
    r_out, r_st = ref_mamba.mamba_apply(jp, jnp.asarray(x), rcfg)
    p_out, p_st = mamba.mamba_apply(pp, torch.tensor(x), pcfg)
    _close(p_out, r_out)
    _state_close(p_st, r_st)
    x2 = _x(rng, pcfg, 24)
    r_out, r_st = ref_mamba.mamba_apply(jp, jnp.asarray(x2), rcfg,
                                        state=r_st)
    p_out, p_st = mamba.mamba_apply(pp, torch.tensor(x2), pcfg, state=p_st)
    _close(p_out, r_out)
    _state_close(p_st, r_st)


def test_mamba_decode_matches_reference(rng):
    rcfg, pcfg, jp, pp = _layer()
    x = _x(rng, pcfg, 24)
    r_st = ref_mamba.mamba_apply(jp, jnp.asarray(x), rcfg)[1]
    p_st = mamba.mamba_apply(pp, torch.tensor(x), pcfg)[1]
    for _ in range(3):
        xt = _x(rng, pcfg, 1)
        before = {k: v.clone() for k, v in p_st.items()}
        r_out, r_st = ref_mamba.mamba_decode(jp, jnp.asarray(xt), rcfg, r_st)
        p_out, p_new = mamba.mamba_decode(pp, torch.tensor(xt), pcfg, p_st)
        assert all(torch.equal(before[k], p_st[k]) for k in before)
        _close(p_out, r_out)
        _state_close(p_new, r_st)
        p_st = p_new


def test_mamba_param_defs_and_state_match_reference():
    """The same leaves and shapes; the seven leaves the reference reads in
    float32 carry ``read_f32``; the zero state's shapes and dtypes."""
    for pcfg, rcfg in ((get_config(ARCH), ref_get_config(ARCH)),
                       (get_config(ARCH).reduced(),
                        ref_get_config(ARCH).reduced())):
        rdefs = ref_mamba.mamba_param_defs(rcfg)
        pdefs = mamba.mamba_param_defs(pcfg)
        assert list(pdefs) == list(rdefs)
        for k in pdefs:
            assert pdefs[k].shape == rdefs[k].shape, k
            assert pdefs[k].init == rdefs[k].init, k
        assert {k for k, d in pdefs.items() if d.read_f32} == {
            "x_dt", "dt_proj", "dt_bias", "x_B", "x_C", "A_log", "D_skip"}
    cfg_ = get_config(ARCH)
    st = mamba.init_mamba_state(cfg_, 2, torch.bfloat16, device="meta")
    assert st["h"].shape == (2, 16384, 16) and st["h"].dtype == torch.float32
    assert st["conv"].shape == (2, 3, 16384)
    assert st["conv"].dtype == torch.bfloat16


def test_mamba_inits():
    """``mamba_A`` equals the reference's init exactly (log 1..N, as its
    XLA log rounds it) and stays float32 in a bfloat16 tree; ``mamba_dt``
    draws dt_bias = softplus^-1(dt) with dt log-uniform in [1e-3, 0.1],
    as the reference does (the numbers themselves come from another
    generator)."""
    shape = (2, 300, 16)
    d = PDef(shape, ("layers", "tp", None), "mamba_A", read_f32=True)
    a = init_params(d, torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16)
    rd = ref_layers.PDef(shape, ("layers", "tp", None), "mamba_A")
    want = np.asarray(ref_layers._init_one(rd, jax.random.PRNGKey(0)))
    assert a.dtype == torch.float32
    assert np.array_equal(a.numpy(), want)
    big = np.arange(1, 257, dtype=np.float32)
    got = init_params(PDef((256,), (None,), "mamba_A"),
                      torch.Generator())
    assert np.array_equal(got.numpy(), np.asarray(jnp.log(big)))

    shape = (4, 4096)
    d = PDef(shape, (None, None), "mamba_dt", read_f32=True)
    bias = init_params(d, torch.Generator().manual_seed(1),
                       dtype=torch.bfloat16)
    assert bias.dtype == torch.float32
    ref_bias = np.asarray(ref_layers._init_one(
        ref_layers.PDef(shape, (None, None), "mamba_dt"),
        jax.random.PRNGKey(1)))
    for b in (bias.numpy(), ref_bias):
        dt = np.logaddexp(b, 0.0)
        assert 1e-3 * 0.999 <= dt.min() < 1.05e-3
        assert 0.095 < dt.max() <= 0.1 * 1.001
        # log-uniform: the mean of log dt is the middle of the range
        mid = 0.5 * (math.log(1e-3) + math.log(1e-1))
        assert abs(np.log(dt).mean() - mid) < 0.05


# --------------------------------------------------------------------------
# The held-expert share of an MoE layer
# --------------------------------------------------------------------------


def _moe_pair(rng):
    """A reduced jamba MoE layer at capacity factor 1.25 (so pairs drop),
    float32: (ref cfg, port cfg, ref params, port params, x)."""
    over = dict(compute_dtype="float32")
    rcfg = dataclasses.replace(ref_get_config(ARCH), **over).reduced()
    pcfg = dataclasses.replace(get_config(ARCH), **over).reduced()
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=1.25))
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, capacity_factor=1.25))
    rp = ref_layers.init_params(ref_moe.moe_param_defs(rcfg),
                                jax.random.PRNGKey(3))
    rp = jax.tree.map(np.asarray, rp)
    x = rng.normal(size=(2, 64, pcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, rp, params_from_jax(rp, device="cpu"), x


def test_expert_shares_sum_to_the_uncut_layer(rng):
    rcfg, pcfg, rp, pp, x = _moe_pair(rng)
    E = pcfg.moe.num_experts
    half = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, experts_held=E // 2))
    xt = torch.tensor(x)
    whole, _ = moe.moe_ffn(xt, pp, pcfg, with_aux=False)
    parts = []
    for e0 in (0, E // 2):
        share = {k: (v[e0:e0 + E // 2] if k.startswith("w_") else v)
                 for k, v in pp.items()}
        parts.append(moe.moe_ffn(xt, share, half, with_aux=False,
                                 expert0=e0)[0])
    _close(parts[0] + parts[1], whole.numpy(), tol=1e-6)
    # pairs dropped at C: the shares drop what the uncut layer drops
    T = x.shape[0] * x.shape[1]
    C = moe._capacity(pcfg.moe, T)
    _, e, _ = moe.route(xt.reshape(T, -1), pp["router"], pcfg.moe,
                        with_aux=False)
    assert int(moe._positions(e, E, C)[2].sum()) > 0
    # the uncut layer is the reference's
    _close(whole, ref_moe.moe_ffn(jnp.asarray(x), jax.tree.map(
        jnp.asarray, rp), rcfg)[0], tol=1e-5)
    with pytest.raises(ValueError, match="expert0"):
        moe.moe_ffn(xt, pp, half, expert0=E // 2 + 1)


def test_expert_share_equals_reference_with_absent_experts_zeroed(rng):
    rcfg, pcfg, rp, pp, x = _moe_pair(rng)
    E = pcfg.moe.num_experts
    held = 3
    share_cfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, experts_held=held))
    for e0 in (0, 2, E - held):
        share = {k: (v[e0:e0 + held] if k.startswith("w_") else v)
                 for k, v in pp.items()}
        got, _ = moe.moe_ffn(torch.tensor(x), share, share_cfg,
                             with_aux=False, expert0=e0)
        zeroed = dict(rp)
        for k in ("w_gate", "w_up", "w_down"):
            w = rp[k].copy()
            w[:e0] = 0.0
            w[e0 + held:] = 0.0
            zeroed[k] = w
        want, _ = ref_moe.moe_ffn(jnp.asarray(x), jax.tree.map(
            jnp.asarray, zeroed), rcfg)
        _close(got, want, tol=1e-5)
    assert moe.moe_param_defs(share_cfg)["w_gate"].shape == (
        held, pcfg.d_model, pcfg.moe.d_ff_expert)
    assert moe.moe_param_defs(share_cfg)["router"].shape == (
        pcfg.d_model, E)


def test_jamba_cut_counts_from_the_defs():
    """jamba-1.5-large: the uncut model's counts are the reference's; one
    block of 8 layers holding 8 of 16 experts is 25.9 B params (51.8 GB in
    bfloat16), counted from the defs without materialising anything."""
    from repro_torch.models.model import active_param_count, num_params
    from repro_torch.serve import kv_cache
    full = get_config(ARCH)
    assert num_params(full) == ref_model.num_params(ref_get_config(ARCH))
    cut = dataclasses.replace(full, num_layers=8, moe=dataclasses.replace(
        full.moe, experts_held=8))
    n = num_params(cut)
    assert 25.8e9 < n < 26.0e9
    block = dataclasses.replace(full, num_layers=8)
    inactive_expert = 3 * full.d_model * full.moe.d_ff_expert
    assert num_params(block) - n == 4 * 8 * inactive_expert
    assert active_param_count(cut) == n - 4 * 6 * inactive_expert
    assert kv_cache.chips_needed(cut, 1, 8192) == 8
    assert cut.reduced().moe.experts_held == 4
