"""The port's grouped matmul and MoE layer against the JAX reference.

On this CPU the wrapper ``gmm`` runs its plain version ``gmm_ref``.  The
same inputs, made with numpy, go to both packages:

* ``gmm_ref`` against the reference's Pallas ``gmm`` in interpret mode
  (as ``tests/test_kernels.py`` runs it) and against its oracle
  ``ref.gmm_ref``, at that file's two shapes: float32 at its 2e-4
  (atol = rtol); bfloat16 within two bfloat16 units in the last place of
  the reference, plus 1e-6 of the output's scale for float32 sums taken
  in another order (both sides round one float32 sum to bfloat16);
* ``pad_groups`` exactly; junk in the padding rows (computed, as the
  Pallas kernel computes them) and in ``nvalid == 0`` blocks (zeros);
* ``route`` in float32: experts equal, a constructed three-way tie
  included; weights and aux within 1e-6;
* ``moe_ffn`` on ``moonshot_v1_16b_a3b.reduced()`` in float32 compute:
  dropless, over several router chunks, with drops (capacity_factor 0.5)
  and with a shared expert, within 1e-4 (float32 sums in another order);
  the fill-based valid-row counts against ``pad_groups``' static ones,
  and two ``block_m``, give the same output.

``gmm`` picks one of three CUDA kernels with the pure function
``_gmm_route``, whose cases are pinned here, and the decode route
(``"mma"``) cuts K by ``dec_splits`` / ``dec_split_range``, whose
coverage of K is held here, as is its order of sums (64-deep slices added
in float32, splits added in order) against ``gmm_ref``.

The whole model (moonshot reduced) is held to the reference in
``tests/test_torch_models.py`` and the serving engine in
``tests/test_torch_serve.py``.  The CUDA kernel is held to the same plain
version on the card by ``chip_smoke.py`` and by
``tests/test_torch_card.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_jaxref  # noqa: F401  (the R1 alias, before any repro import)

import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.kernels.moe_gmm import gmm as ref_gmm
from repro.kernels.moe_gmm import gmm_ref as ref_gmm_oracle
from repro.kernels.moe_gmm import pad_groups as ref_pad_groups
from repro.models import moe as ref_moe

from repro_torch.configs import get_config
from repro_torch.kernels.moe_gmm import gmm, gmm_ref, pad_groups
from repro_torch.kernels.moe_gmm.kernel import (_gmm_route, dec_split_range,
                                                 dec_splits)
from repro_torch.models import moe

ARCH = "moonshot_v1_16b_a3b"
GMM_SHAPES = [(4, 96, 64, 128, 32), (8, 64, 128, 64, 64)]  # E, C, K, N, bm
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype="float32"):
    """A numpy array as a jax and a torch array of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, dtype):
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    if dtype == "float32":
        np.testing.assert_allclose(p, r, atol=2e-4, rtol=2e-4)
        return
    # two bfloat16 units in the last place of |ref| (8 significant bits),
    # plus the float32 sums' own difference
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
    limit = 2 * ulp + 1e-6 * np.abs(r).max()
    assert (np.abs(p - r) <= limit).all(), np.abs(p - r).max()


def _gmm_inputs(rng, E, C, K, N, bm, dtype):
    xg = rng.normal(size=(E, C, K))
    w = rng.normal(size=(E, K, N))
    jx, tx = _both(xg, dtype)
    jw, tw = _both(w, dtype)
    return (jx, jw), (tx, tw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,K,N,bm", GMM_SHAPES)
def test_gmm_matches_reference_kernel_and_oracle(E, C, K, N, bm, dtype, rng):
    (jx, jw), (tx, tw) = _gmm_inputs(rng, E, C, K, N, bm, dtype)
    jxx, jbe, jnv = ref_pad_groups(jx, bm)
    x, be, nv = pad_groups(tx, bm)
    before = gmm.launches
    out = gmm(x, tw, be, nv, block_m=bm)
    assert gmm.launches == before                    # CPU: no launch
    assert out.dtype == tx.dtype and out.shape == (x.shape[0], N)
    _close(out, ref_gmm(jxx, jw, jbe, jnv, block_m=bm, block_n=64,
                        block_k=32), dtype)
    _close(out, ref_gmm_oracle(jxx, jw, jbe, jnv, block_m=bm), dtype)
    assert torch.equal(out, gmm_ref(x, tw, be, nv, block_m=bm))


@pytest.mark.parametrize("E,C,K,N,bm", GMM_SHAPES + [(3, 5, 24, 40, 16)])
def test_pad_groups_equals_reference(E, C, K, N, bm, rng):
    jx, tx = _both(rng.normal(size=(E, C, K)))
    for a, b in zip(ref_pad_groups(jx, bm), pad_groups(tx, bm)):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert b.dtype == (torch.int32 if b.dim() == 1 else torch.float32)


def test_gmm_junk_padding_rows_and_empty_blocks(rng):
    """Padding rows of a valid block are computed (x's junk @ w), a block
    with nvalid == 0 gives exact zeros whatever its rows hold, and expert
    ids need not be sorted or distinct.  (K and N are multiples of the
    reference kernel's blocks: its interpret mode reads past a ragged edge
    as NaN.)"""
    E, K, N, bm = 4, 64, 128, 16
    nb = 6
    x = rng.normal(size=(nb * bm, K))                 # junk everywhere
    w = rng.normal(size=(E, K, N))
    be = np.array([2, 0, 0, 3, 1, 2], np.int32)
    nv = np.array([16, 3, 0, 1, 0, 16], np.int32)
    jx, tx = _both(x)
    jw, tw = _both(w)
    out = gmm(tx, tw, torch.tensor(be), torch.tensor(nv), block_m=bm)
    ref = ref_gmm(jx, jw, jnp.asarray(be), jnp.asarray(nv), block_m=bm,
                  block_n=64, block_k=32)
    _close(out, ref, "float32")
    ob = out.reshape(nb, bm, N)
    assert (ob[nv == 0] == 0).all()
    assert (ob[1, 3:] != 0).any()                     # padding rows computed
    np.testing.assert_allclose(ob[1].numpy(), x[bm:2 * bm] @ w[0],
                               rtol=1e-5, atol=1e-4)


def test_gmm_checks_its_inputs():
    x = torch.zeros(32, 8)
    w = torch.zeros(2, 8, 4)
    be = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_m"):
        gmm(x, w, be, be, block_m=12)
    with pytest.raises(ValueError, match="int32"):
        gmm(x, w, be.long(), be, block_m=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm(x, w.double(), be, be, block_m=16)
    with pytest.raises(ValueError, match="do not match"):
        gmm(x, torch.zeros(2, 9, 4), be, be, block_m=16)


def _cfg(over=None, **moe_over):
    """The reduced moonshot config on both sides, float32 compute."""
    over = dict(over or {}, compute_dtype="float32")
    out = []
    for get in (ref_get_config, get_config):
        cfg = dataclasses.replace(get(ARCH), **over).reduced()
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over)))
    return out


def _moe_params(rng, cfg):
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    p = {"router": rng.normal(size=(d, m.num_experts)) / np.sqrt(d),
         "w_gate": rng.normal(size=(m.num_experts, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(m.num_experts, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(m.num_experts, f, d)) / np.sqrt(f)}
    if m.num_shared:
        fs = f * m.num_shared
        p.update(shared_gate=rng.normal(size=(d, fs)) / np.sqrt(d),
                 shared_up=rng.normal(size=(d, fs)) / np.sqrt(d),
                 shared_down=rng.normal(size=(fs, d)) / np.sqrt(fs))
    return ({k: _both(v)[0] for k, v in p.items()},
            {k: _both(v)[1] for k, v in p.items()})


def test_route_matches_reference_with_ties(rng):
    rcfg, pcfg = _cfg()
    m = pcfg.moe
    d = pcfg.d_model
    router = rng.normal(size=(d, m.num_experts)) / np.sqrt(d)
    router[:, [2, 5, 6]] = 4 * rng.normal(size=(d, 1)) / np.sqrt(d)
    jx, tx = _both(rng.normal(size=(64, d)))
    jr, tr = _both(router)
    rw, re, ra = ref_moe.route(jx, jr, rcfg.moe)
    pw, pe, pa = moe.route(tx, tr, m)
    assert pe.dtype == torch.int32 and pw.dtype == torch.float32
    assert np.array_equal(np.asarray(re), pe.numpy())
    tied = (pe[:, 0] == 2).numpy()
    assert tied.any() and (pe[tied, 1] == 5).all()   # lower index first
    np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=0, atol=1e-6)
    assert abs(float(pa) - float(ra)) <= 1e-6


@pytest.mark.parametrize("case,chunk", [("dropless", 4096), ("dropless", 16),
                                        ("drops", 4096), ("shared", 4096)])
def test_moe_ffn_matches_reference(case, chunk, rng):
    moe_over = {"drops": {"capacity_factor": 0.5},
                "shared": {"num_shared": 1}}.get(case, {})
    rcfg, pcfg = _cfg(**moe_over)
    rp, pp = _moe_params(rng, pcfg)
    jx, tx = _both(rng.normal(size=(2, 32, pcfg.d_model)))
    ry, ra = ref_moe.moe_ffn(jx, rp, rcfg, chunk=chunk)
    py, pa = moe.moe_ffn(tx, pp, pcfg, chunk=chunk)
    drops = _dropped_pairs(tx, pp["router"], pcfg.moe, chunk)
    assert py.shape == tx.shape and py.dtype == tx.dtype
    assert (drops > 0) == (case == "drops"), drops
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=0,
                               atol=1e-4)
    assert abs(float(pa) - float(ra)) <= 1e-6
    # the serving path skips the loss and computes the same output
    py_serve, none = moe.moe_ffn(tx, pp, pcfg, chunk=chunk, with_aux=False)
    assert none is None and torch.equal(py_serve, py)


def _dropped_pairs(x, router_w, m, chunk):
    """(token, slot) pairs over capacity, router chunk by router chunk as
    moe_ffn splits them."""
    xf = x.reshape(-1, x.shape[-1])
    T = xf.shape[0]
    chunk = min(chunk, T)
    chunk = T if T % chunk else chunk
    n = 0
    for xc in xf.split(chunk):
        _, e, _ = moe.route(xc, router_w, m)
        n += int(moe._positions(e, m.num_experts,
                                moe._capacity(m, chunk))[2].sum())
    return n


def test_fill_counts_and_block_m_do_not_change_the_output(rng, monkeypatch):
    """Valid-row counts from each expert's real fill give the output that
    pad_groups' static "C rows per expert" counts give (empty rows are
    zero, and a skipped block is zero), and the gmm row block does not
    change it either."""
    _, pcfg = _cfg(capacity_factor=0.5)            # full and empty experts
    _, pp = _moe_params(rng, pcfg)
    tx = torch.tensor(rng.normal(size=(1, 48, pcfg.d_model)),
                      dtype=torch.float32)
    seen = []
    fill_blocks = moe._fill_blocks

    def record(counts, C, block_m):
        be, nv = fill_blocks(counts, C, block_m)
        _, sbe, snv = pad_groups(torch.zeros(counts.shape[0], C, 1), block_m)
        seen.append((nv, snv, counts.clamp(max=C)))
        assert torch.equal(be, sbe)
        return be, nv

    monkeypatch.setattr(moe, "_fill_blocks", record)
    y_fill, _ = moe.moe_ffn(tx, pp, pcfg)
    nv, snv, fill = seen[0]
    assert (nv <= snv).all() and (nv < snv).any()
    assert (nv.reshape(len(fill), -1).sum(1) == fill).all()

    def static(counts, C, block_m):
        _, be, nv = pad_groups(torch.zeros(counts.shape[0], C, 1), block_m)
        return be, nv

    monkeypatch.setattr(moe, "_fill_blocks", static)
    y_static, _ = moe.moe_ffn(tx, pp, pcfg)
    assert torch.equal(y_fill, y_static)
    monkeypatch.setattr(moe, "_fill_blocks", fill_blocks)
    for bm in (16, 32, 64, 128):
        monkeypatch.setattr(moe, "block_m_for", lambda C, bm=bm: bm)
        y, _ = moe.moe_ffn(tx, pp, pcfg)
        np.testing.assert_allclose(y.numpy(), y_fill.numpy(), rtol=0,
                                   atol=1e-6)


def test_capacity_and_block_m_choice():
    m = get_config(ARCH).moe
    assert [moe._capacity(m, t) for t in (1, 511, 512, 2048)] == [
        6, 60, 60, 240]
    assert [moe._capacity(m, t) for t in (1, 512, 2048)] == [
        ref_moe._capacity(m, t) for t in (1, 512, 2048)]
    assert [moe.block_m_for(c) for c in (6, 16, 17, 60, 64, 240)] == [
        16, 16, 32, 64, 64, 128]


@pytest.mark.parametrize("dtype,bm,K,N,route", [
    (torch.bfloat16, 128, 2048, 1408, "wgmma"),   # moonshot prefill
    (torch.bfloat16, 64, 2048, 1408, "wgmma"),    # its 512 tokens
    (torch.bfloat16, 128, 8192, 24576, "wgmma"),  # the jamba cut
    (torch.bfloat16, 128, 24576, 8192, "wgmma"),  # its down product
    (torch.bfloat16, 192, 200, 136, "wgmma"),
    (torch.bfloat16, 16, 2048, 1408, "mma"),      # moonshot decode
    (torch.bfloat16, 32, 2048, 1408, "mma"),
    (torch.bfloat16, 16, 1408, 2048, "mma"),      # its down product
    (torch.bfloat16, 16, 8192, 24576, "mma"),     # the jamba cut's decode
    (torch.bfloat16, 16, 24576, 8192, "mma"),
    (torch.bfloat16, 32, 8192, 24576, "mma"),
    (torch.float32, 16, 2048, 1408, "simt"),
    (torch.bfloat16, 16, 2048, 1412, "simt"),     # rows not 16 bytes
    (torch.bfloat16, 48, 2048, 1408, "simt"),
    (torch.float32, 128, 2048, 1408, "simt"),
    (torch.bfloat16, 128, 33, 7, "simt"),         # rows not 16 bytes
    (torch.bfloat16, 128, 2048, 1412, "simt"),
])
def test_gmm_route(dtype, bm, K, N, route):
    assert _gmm_route(dtype, bm, K, N) == route


# the "mma" route's shapes: (K, N, valid blocks): moonshot's decode gate/up
# and down (6 of 64 blocks), the jamba cut's (1 of 8), ragged and busy ones
DEC_SHAPES = [(2048, 1408, 6), (1408, 2048, 6), (8192, 24576, 1),
              (24576, 8192, 1), (200, 136, 3), (24, 8, 1), (2048, 1408, 64),
              (2048, 1408, 0)]


@pytest.mark.parametrize("K,N,nvb", DEC_SHAPES)
@pytest.mark.parametrize("grid", [396, 264, 1])
def test_mma_route_split_plan_covers_k(K, N, nvb, grid):
    """The K splits of the decode route: the 64-deep tiles of each split
    are non-empty and together cover K exactly once, in order; split K
    fills the grid without passing it."""
    S = dec_splits(nvb, K, N, grid)
    nk, nt = -(-K // 64), -(-N // 128)
    assert 1 <= S <= min(16, nk)
    if S > 1:
        assert nvb * nt * S <= grid < nvb * nt * (S + 1) or S == min(16, nk)
    edges = [dec_split_range(K, S, s) for s in range(S)]
    assert edges[0][0] == 0 and edges[-1][1] == nk
    assert all(k0 < k1 for k0, k1 in edges)
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))


@pytest.mark.parametrize("K,N,nvb", [s for s in DEC_SHAPES[:4]])
def test_mma_route_sums_keep_the_bf16_limit(K, N, nvb, rng):
    """The decode route's order of sums in plain PyTorch: each 64-deep
    slice of K summed from zero (float32 here; the tensor cores on the
    card), added into its split's float32 sum in order, the splits added in
    split order, one rounding to bf16; against ``gmm_ref`` within the
    card's bf16 limit, 1e-5 + 2^-6 |ref|, at moonshot's and the jamba
    cut's decode K (N cut to 128 columns; the split count is the served
    N's)."""
    S = dec_splits(nvb, K, N, 396)
    x = torch.tensor(rng.normal(size=(16, K)), dtype=torch.bfloat16)
    w = torch.tensor(rng.normal(size=(1, K, 128)) / np.sqrt(K),
                     dtype=torch.bfloat16)
    xf, wf = x.float(), w[0].float()
    total = None
    for s in range(S):
        k0, k1 = dec_split_range(K, S, s)
        acc = torch.zeros(16, 128)
        for kt in range(k0, k1):
            sl = slice(64 * kt, min(64 * kt + 64, K))
            acc = acc + xf[:, sl] @ wf[sl]
        total = acc if total is None else total + acc
    ref = gmm_ref(x, w, torch.zeros(1, dtype=torch.int32),
                  torch.ones(1, dtype=torch.int32), block_m=16).float()
    torch.testing.assert_close(total.to(torch.bfloat16).float(), ref,
                               atol=1e-5, rtol=2.0 ** -6)
