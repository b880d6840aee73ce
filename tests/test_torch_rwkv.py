"""The port's WKV6 kernel wrapper and RWKV6 layers against the JAX reference.

On this CPU the wrapper ``wkv_fwd`` runs its plain version
``wkv_chunked_ref``.  The same inputs, made with numpy from a seed, go to
both packages.

* The plain WKV at ``tests/test_kernels.py``'s shapes, with its inputs
  (logw in [-1, -0.01], k scaled by 0.3, u by 0.1) and its tolerance,
  atol 5e-4 / rtol 1e-3 (float32 sums in another order; at these decays
  the chunked form multiplies factors up to e^{+-32} and loses a few
  digits, on both sides): against the reference's Pallas ``wkv_fwd`` in
  interpret mode (zero start), its oracle ``wkv_ref``, and the model's
  ``wkv_chunked`` with a non-zero carried state (y and s_T); with a
  ragged S (the last chunk shorter; the reference side is its oracle and
  ``wkv_chunked`` at a chunk that divides S); and with bfloat16 r / k /
  v, where y comes back in bfloat16 and may round one unit in the last
  place apart from the reference's (both round one float32 sum), so the
  limit adds two units (2^-7 |ref| each) to the float32 one.
* The model's parts on ``rwkv6_7b.reduced()`` (d 128, H 4, N 32) in
  float32, with the reference's init carried across and its zero
  ``decay_w2`` / ``bonus_u`` replaced by random values (so the decay LoRA
  and the bonus are exercised): ``wkv_step``, ``rwkv_time_mix``,
  ``rwkv_time_step`` and ``rwkv_channel_mix``, outputs and states within
  1e-4 (float32 sums in another order, ~1e-6 measured).

The whole model is held to the reference in ``tests/test_torch_models.py``
and the serving engine in ``tests/test_torch_serve.py``.  The CUDA kernel
is held to the same plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_card.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_jaxref  # noqa: F401  (the R1 alias, before any repro import)

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.kernels.rwkv6 import wkv_ref as ref_wkv_oracle
from repro.kernels.rwkv6.kernel import wkv_fwd as ref_wkv_pallas
from repro.models import model as ref_model
from repro.models import rwkv as ref_rwkv

from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import wkv_fwd, wkv_ref
from repro_torch.models import rwkv
from repro_torch.models.convert import params_from_jax

ARCH = "rwkv6_7b"
WKV_SHAPES = [(2, 128, 2, 32, 32), (1, 96, 4, 16, 32), (2, 64, 2, 64, 64)]
ATOL, RTOL = 5e-4, 1e-3


def _wkv_inputs(rng, B, S, H, N, *, state=False):
    """test_kernels.py's inputs as numpy float32, plus a carried state."""
    r = rng.normal(size=(B, S, H, N))
    k = rng.normal(size=(B, S, H, N)) * 0.3
    v = rng.normal(size=(B, S, H, N))
    logw = -rng.uniform(0.01, 1.0, (B, S, H, N))
    u = rng.normal(size=(H, N)) * 0.1
    out = [a.astype(np.float32) for a in (r, k, v, logw, u)]
    if state:
        out.append((rng.normal(size=(B, H, N, N)) * 0.5).astype(np.float32))
    return out


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(port, ref, *, bf16=False):
    p = port.float().numpy() if torch.is_tensor(port) else port
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    assert p.shape == r.shape
    limit = ATOL + RTOL * np.abs(r)
    if bf16:   # two bfloat16 units in the last place of |ref|
        limit = limit + 2 * np.exp2(np.floor(np.log2(
            np.maximum(np.abs(r), 1e-30))) - 7)
    assert (np.abs(p - r) <= limit).all(), np.abs(p - r).max()


@pytest.mark.parametrize("B,S,H,N,chunk", WKV_SHAPES)
def test_wkv_matches_pallas_kernel_and_oracle(B, S, H, N, chunk, rng):
    r, k, v, logw, u = _wkv_inputs(rng, B, S, H, N)
    before = wkv_fwd.launches
    y, s_T = wkv_fwd(*_t(r, k, v, logw, u), chunk=chunk)
    assert wkv_fwd.launches == before                   # CPU: no launch
    assert y.dtype == torch.float32 and y.shape == (B, S, H, N)
    assert s_T.dtype == torch.float32 and s_T.shape == (B, H, N, N)
    jin = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    _close(y, ref_wkv_pallas(*jin, chunk=chunk, interpret=True))
    _close(y, ref_wkv_oracle(*jin))
    y_seq, s_seq = wkv_ref(*_t(r, k, v, logw, u))
    _close(y, y_seq.numpy())
    _close(s_T, s_seq.numpy())


@pytest.mark.parametrize("B,S,H,N,chunk", WKV_SHAPES)
def test_wkv_carries_state_like_the_models_wkv_chunked(B, S, H, N, chunk,
                                                       rng):
    r, k, v, logw, u, s0 = _wkv_inputs(rng, B, S, H, N, state=True)
    y, s_T = wkv_fwd(*_t(r, k, v, logw, u, s0), chunk=chunk)
    ry, rs = ref_rwkv.wkv_chunked(*(jnp.asarray(a) for a in (
        r, k, v, logw, u, s0)), chunk=chunk)
    _close(y, ry)
    _close(s_T, rs)
    # s0 = None is the zero state
    y0, s0_T = wkv_fwd(*_t(r, k, v, logw, u), chunk=chunk)
    y1, s1_T = wkv_fwd(*_t(r, k, v, logw, u, np.zeros_like(s0)),
                       chunk=chunk)
    assert torch.equal(y0, y1) and torch.equal(s0_T, s1_T)


@pytest.mark.parametrize("S,chunk", [(100, 64), (97, 32), (5, 64)])
def test_wkv_ragged_last_chunk(S, chunk, rng):
    """S not a multiple of chunk: the last chunk is shorter.  The
    reference side is its oracle (y) and its ``wkv_chunked`` at a chunk
    that divides S (y and s_T); its own fallback for a ragged S, one chunk
    of length S, overflows float32 at these decays."""
    B, H, N = 2, 2, 32
    r, k, v, logw, u, s0 = _wkv_inputs(rng, B, S, H, N, state=True)
    y, s_T = wkv_fwd(*_t(r, k, v, logw, u, s0), chunk=chunk)
    assert y.shape == (B, S, H, N)
    div = max(c for c in range(1, 33) if S % c == 0)
    ry, rs = ref_rwkv.wkv_chunked(*(jnp.asarray(a) for a in (
        r, k, v, logw, u, s0)), chunk=div)
    _close(y, ry)
    _close(s_T, rs)
    y_z, _ = wkv_fwd(*_t(r, k, v, logw, u), chunk=chunk)
    _close(y_z, ref_wkv_oracle(*(jnp.asarray(a) for a in (
        r, k, v, logw, u))))


@pytest.mark.parametrize("B,S,H,N,chunk", WKV_SHAPES)
def test_wkv_bfloat16_inputs(B, S, H, N, chunk, rng):
    r, k, v, logw, u, s0 = _wkv_inputs(rng, B, S, H, N, state=True)
    tr, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (r, k, v))
    y, s_T = wkv_fwd(tr, tk, tv, *_t(logw, u, s0), chunk=chunk)
    assert y.dtype == torch.bfloat16 and s_T.dtype == torch.float32
    jr, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (r, k, v))
    ry, rs = ref_rwkv.wkv_chunked(jr, jk, jv, *(jnp.asarray(a) for a in (
        logw, u, s0)), chunk=chunk)
    assert ry.dtype == jnp.bfloat16
    _close(y, ry, bf16=True)
    _close(s_T, rs)


def test_wkv_checks_its_inputs(rng):
    r, k, v, logw, u, s0 = _t(*_wkv_inputs(rng, 1, 8, 2, 16, state=True))
    with pytest.raises(TypeError, match="logw"):
        wkv_fwd(r, k, v, logw.to(torch.bfloat16), u)
    with pytest.raises(TypeError, match="k must be"):
        wkv_fwd(r, k.to(torch.bfloat16), v, logw, u)
    with pytest.raises(ValueError, match="s0"):
        wkv_fwd(r, k, v, logw, u, s0[:, :1])
    with pytest.raises(ValueError, match="chunk"):
        wkv_fwd(r, k, v, logw, u, chunk=65)
    with pytest.raises(ValueError, match="N <= 64"):
        big = torch.zeros(1, 2, 1, 65)
        wkv_fwd(big, big, big, big, torch.zeros(1, 65))
    with pytest.raises(ValueError, match="contiguous"):
        wkv_fwd(r, k, v.transpose(1, 2).contiguous().transpose(1, 2),
                logw, u)


# --------------------------------------------------------------------------
# A plain model of the CUDA kernels' chunk-parallel split
# --------------------------------------------------------------------------


def _wkv_split_model(r, k, v, logw, u, s0, *, chunk):
    """``csrc/wkv.cu``'s three kernels in plain PyTorch, in their order of
    stages and with their zero padding: each chunk padded to 64 rows, the
    cumulative log decay c as running sums of four 16-row segments plus the
    sums of the segments above, c_prev = c - logw; (1) every chunk's state
    increment dS_c = (k e^{-c} e^{c_T})ᵀ v and e^{c_T}; (2) the walk S_{c+1} =
    e^{c_T} S_c + dS_c, keeping S_c, the state before chunk c; (3) every
    chunk's y = (r e^{c_prev}) S_c + tril_strict((r e^{c_prev})
    (k e^{-c})ᵀ) v + diag(r · u · k) v.  Returns (y, s_T) in float32."""
    B, S, H, N = r.shape
    C, T = -(-S // chunk), 64

    def tiles(x):      # [B, S, H, N] -> [B, C, 64, H, N], zero padded
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, C * chunk - S))
        x = x.reshape(B, C, chunk, H, N)
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, T - chunk))

    rt, kt, vt, wt = (tiles(x) for x in (r, k, v, logw))
    run = torch.cumsum(wt.reshape(B, C, 4, 16, H, N), dim=3)
    seg = run[:, :, :, -1]                               # [B, C, 4, H, N]
    above = torch.zeros_like(seg)
    for s in range(1, 4):
        above[:, :, s] = above[:, :, s - 1] + seg[:, :, s - 1]
    c = (run + above[:, :, :, None]).reshape(B, C, T, H, N)
    c_prev = c - wt
    e_T = torch.exp(above[:, :, 3] + seg[:, :, 3])       # [B, C, H, N]
    # (1) the state increments
    kd = kt * torch.exp(-c) * e_T[:, :, None]
    dS = torch.einsum("bcthn,bcthm->bchnm", kd, vt)
    # (2) the walk
    St = (torch.zeros(B, H, N, N) if s0 is None else s0.float().clone())
    Sc = []
    for ci in range(C):
        Sc.append(St)
        St = e_T[:, ci, :, :, None] * St + dS[:, ci]
    Sc = torch.stack(Sc, 1)                              # [B, C, H, N, N]
    # (3) every chunk's y
    rd, kdec = rt * torch.exp(c_prev), kt * torch.exp(-c)
    y = torch.einsum("bcihn,bchnm->bcihm", rd, Sc)
    scores = torch.einsum("bcihn,bcjhn->bchij", rd, kdec)
    ii = torch.arange(T)
    scores = torch.where(ii[:, None] > ii[None, :], scores, 0.0)
    diag = torch.einsum("bcihn,hn,bcihn->bchi", rt, u.float(), kt)
    scores = scores + torch.diag_embed(diag)
    y = y + torch.einsum("bchij,bcjhm->bcihm", scores, vt)
    y = y[:, :, :chunk].reshape(B, C * chunk, H, N)[:, :S]
    return y, St


# (B, S, H, N, chunk): a full chunk, a ragged last chunk at N = 48, S below
# the chunk, chunks shorter than 64 (ragged too), S = 1
SPLIT_CASES = [(2, 128, 2, 64, 64), (2, 100, 2, 48, 64), (1, 40, 2, 32, 64),
               (2, 96, 3, 48, 32), (2, 70, 2, 16, 16), (1, 1, 2, 8, 64)]


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("B,S,H,N,chunk", SPLIT_CASES)
def test_wkv_kernel_split_matches_plain_version_and_reference(
        B, S, H, N, chunk, carried, rng):
    """The kernels' decomposition against the plain version and the
    reference: from zero state, the reference's oracle ``wkv_ref`` and
    (where the chunk divides S) its interpret-mode Pallas ``wkv_fwd``;
    with a carried state, its ``wkv_chunked`` at a chunk that divides S
    (y and s_T)."""
    r, k, v, logw, u, s0 = _wkv_inputs(rng, B, S, H, N, state=True)
    st = s0 if carried else None
    ym, sm = _wkv_split_model(*_t(r, k, v, logw, u), None if st is None
                              else torch.tensor(st), chunk=chunk)
    yp, sp = wkv_fwd(*_t(r, k, v, logw, u), None if st is None
                     else torch.tensor(st), chunk=chunk)
    _close(ym, yp.numpy())
    _close(sm, sp.numpy())
    jin = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    if carried:
        div = max(c for c in range(1, 33) if S % c == 0)
        ry, rs = ref_rwkv.wkv_chunked(*jin, jnp.asarray(s0), chunk=div)
        _close(ym, ry)
        _close(sm, rs)
    else:
        _close(ym, ref_wkv_oracle(*jin))
        if S % chunk == 0:
            _close(ym, ref_wkv_pallas(*jin, chunk=chunk, interpret=True))


# --------------------------------------------------------------------------
# The model's parts at the reduced width
# --------------------------------------------------------------------------


def _layer(rng):
    """(ref cfg, port cfg, ref time-mix / channel-mix params of layer 0,
    port ones): the reference's init with random decay_w2 and bonus_u."""
    rcfg = dataclasses.replace(ref_get_config(ARCH),
                               compute_dtype="float32").reduced()
    pcfg = dataclasses.replace(get_config(ARCH),
                               compute_dtype="float32").reduced()
    rp = ref_model.Model(rcfg).init(jax.random.PRNGKey(3))
    lay = jax.tree.map(lambda a: np.asarray(a[0]), rp["stages"][0]["l0"])
    lay["attn"]["decay_w2"] = (rng.normal(
        size=lay["attn"]["decay_w2"].shape) * 0.1).astype(np.float32)
    lay["attn"]["bonus_u"] = (rng.normal(
        size=lay["attn"]["bonus_u"].shape) * 0.3).astype(np.float32)
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"):
        lay["attn"][name] = rng.uniform(0, 1, lay["attn"][name].shape
                                        ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, lay)
    return rcfg, pcfg, jp, params_from_jax(lay, device="cpu")


def _x(rng, cfg, S, B=2):
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _tree_close(port, ref, atol=1e-4):
    for key in ref:
        p, r = port[key], np.asarray(ref[key])
        assert p.shape == r.shape, key
        np.testing.assert_allclose(p.numpy(), r, atol=atol, rtol=atol,
                                   err_msg=key)


def test_time_mix_matches_reference_with_carried_state(rng):
    rcfg, pcfg, jp, pp = _layer(rng)
    x = _x(rng, pcfg, 96)
    # from zeros, then a second segment from the first one's state
    r_out, r_st = ref_rwkv.rwkv_time_mix(jp["attn"], jnp.asarray(x), rcfg)
    p_out, p_st = rwkv.rwkv_time_mix(pp["attn"], torch.tensor(x), pcfg)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), atol=1e-4,
                               rtol=1e-4)
    _tree_close(p_st, r_st)
    x2 = _x(rng, pcfg, 40)
    r_out, r_st = ref_rwkv.rwkv_time_mix(jp["attn"], jnp.asarray(x2), rcfg,
                                         state=r_st)
    p_out, p_st = rwkv.rwkv_time_mix(pp["attn"], torch.tensor(x2), pcfg,
                                     state=p_st)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), atol=1e-4,
                               rtol=1e-4)
    _tree_close(p_st, r_st)


def test_time_step_and_wkv_step_match_reference(rng):
    rcfg, pcfg, jp, pp = _layer(rng)
    x = _x(rng, pcfg, 24)
    r_st = ref_rwkv.rwkv_time_mix(jp["attn"], jnp.asarray(x), rcfg)[1]
    p_st = rwkv.rwkv_time_mix(pp["attn"], torch.tensor(x), pcfg)[1]
    for _ in range(3):
        xt = _x(rng, pcfg, 1)
        before = {k: v.clone() for k, v in p_st.items()}
        r_out, r_st = ref_rwkv.rwkv_time_step(jp["attn"], jnp.asarray(xt),
                                              rcfg, r_st)
        p_out, p_new = rwkv.rwkv_time_step(pp["attn"], torch.tensor(xt),
                                           pcfg, p_st)
        assert all(torch.equal(before[k], p_st[k]) for k in before)
        np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out),
                                   atol=1e-4, rtol=1e-4)
        _tree_close(p_new, r_st)
        p_st = p_new
    H, N = rwkv._dims(pcfg)
    r, k, v, logw = (rng.normal(size=(2, H, N)).astype(np.float32)
                     for _ in range(4))
    logw = -np.abs(logw)
    u = pp["attn"]["bonus_u"].numpy()
    S = rng.normal(size=(2, H, N, N)).astype(np.float32)
    ry, rS = ref_rwkv.wkv_step(*(jnp.asarray(a) for a in (r, k, v, logw, u,
                                                          S)))
    py, pS = rwkv.wkv_step(*_t(r, k, v, logw, u, S))
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pS.numpy(), np.asarray(rS), atol=1e-5,
                               rtol=1e-5)


def test_channel_mix_matches_reference(rng):
    rcfg, pcfg, jp, pp = _layer(rng)
    x = _x(rng, pcfg, 16)
    prev = _x(rng, pcfg, 1)
    for state in (None, {"x_prev": prev}):
        r_out, r_st = ref_rwkv.rwkv_channel_mix(
            jp["ffn"], jnp.asarray(x), rcfg,
            state=None if state is None else jax.tree.map(jnp.asarray,
                                                          state))
        p_out, p_st = rwkv.rwkv_channel_mix(
            pp["ffn"], torch.tensor(x), pcfg,
            state=None if state is None else {"x_prev": torch.tensor(prev)})
        np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out),
                                   atol=1e-4, rtol=1e-4)
        _tree_close(p_st, r_st)


def test_rwkv_decay_init_range():
    """The port's ``rwkv_decay`` init draws U[-8, -4] from the generator
    (the reference's ``layers.py`` rule), in float32 whatever the compute
    dtype."""
    from repro_torch.models.layers import PDef, init_params
    d = PDef((4, 4096), ("layers", "tp"), "rwkv_decay", read_f32=True)
    a = init_params(d, torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16)
    assert a.dtype == torch.float32
    assert -8.0 <= a.min() < -7.9 and -4.1 < a.max() < -4.0
    assert abs(a.mean().item() + 6.0) < 0.05
    b = init_params(d, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
