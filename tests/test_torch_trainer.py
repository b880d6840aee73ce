"""The port's training loop against the JAX reference on the CPU: the
synthetic stream, the Trainer, restarts, the gradient compressors and the
launcher.

* ``SyntheticTokens`` / ``make_train_batches``: bit for bit, the vlm's
  ``image_emb`` and the encdec's ``frames`` (bfloat16) included.
* The Trainer's history over 6 steps (reduced stablelm-3b, float32
  compute, ``wq`` / ``wk`` at fan-in d as in ``tests/test_torch_train.py``,
  ``train_cases.STEP_OPT``) against a loop of the reference's jitted
  ``make_train_step`` over its ``make_train_batches``, from the same
  weights: loss and nll within 1e-4 absolute, grad_norm 1e-4 relative (the
  float32 differences of one step, ~1e-6, carried through six updates),
  lr 1e-6 relative, tokens and steps equal.  The reference's own Trainer
  needs a mesh (ROADMAP.md Queue 3, R2), so its loop stands in for it.
* ``run_with_restarts``: a run killed after step 3 and restarted from its
  step-2 checkpoint ends bit-equal to the run never killed; a plain
  ``RuntimeError`` propagates at once.
* The compressors: the int8 payload and residuals equal to float32
  rounding, top-k's indices equal (ties to the lower index, as
  ``jax.lax.top_k``), over two rounds of error feedback.
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
from repro.data import pipeline as ref_pipeline
from repro.models import model as ref_model
from repro.optim import compression as ref_comp
from repro.optim import optimizer as ref_opt
from repro.train import step as ref_step

from repro_torch.bench import train_cases
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens, make_train_batches
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import compression as port_comp
from repro_torch.optim.optimizer import adamw_init
from repro_torch.runtime import run_with_restarts
from repro_torch.train.trainer import Trainer

STEPS = 6


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("arch", ["stablelm_3b", "llama_3_2_vision_90b",
                                  "seamless_m4t_large_v2"])
def test_synthetic_stream_and_batches_are_the_reference_bit_for_bit(arch):
    for seed, step in ((0, 0), (7, 3)):
        a = SyntheticTokens(512, 32, 3, seed=seed).batch(step)
        b = ref_pipeline.SyntheticTokens(512, 32, 3, seed=seed).batch(step)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                   for k in b)
    cfg = get_config(arch).reduced()
    port = make_train_batches(cfg, 2, 16, seed=5, device="cpu")
    ref = ref_pipeline.make_train_batches(ref_get_config(arch).reduced(), 2,
                                          16, seed=5)
    for _ in range(2):
        (ps, pb), (rs, rb) = next(port), next(ref)
        assert ps == rs and sorted(pb) == sorted(rb)
        for k, v in rb.items():
            want = np.asarray(v)
            if want.dtype.name == "bfloat16":
                want = want.view(np.int16)
            assert pb[k].device.type == "cpu"
            assert np.array_equal(_bits(pb[k]), want), (arch, k)


def test_trainer_history_matches_a_loop_of_the_reference_step():
    over = dict(compute_dtype="float32")
    rcfg = dataclasses.replace(ref_get_config("stablelm_3b"),
                               **over).reduced()
    pcfg = dataclasses.replace(get_config("stablelm_3b"), **over).reduced()
    rp = ref_model.Model(rcfg).init(jax.random.PRNGKey(1))
    for lay in rp["stages"][0].values():
        a = dict(lay["attn"])
        a["wq"] = a["wq"] * math.sqrt(rcfg.num_heads / rcfg.d_model)
        a["wk"] = a["wk"] * math.sqrt(rcfg.num_kv_heads / rcfg.d_model)
        lay["attn"] = a
    pp = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu")
    for p in jax.tree.leaves(pp):
        p.requires_grad_(True)
    r_step = jax.jit(ref_step.make_train_step(rcfg, ref_opt.AdamWConfig(
        **dataclasses.asdict(train_cases.STEP_OPT))))
    r_state, ref_hist = ref_opt.adamw_init(rp), []
    for step, b in ref_pipeline.make_train_batches(rcfg, 4, 32, seed=2):
        if step >= STEPS:
            break
        rp, r_state, m = r_step(rp, r_state, b)
        ref_hist.append({k: float(v) for k, v in m.items()})
    seen = []
    out = Trainer(pcfg, 4, 32, opt_cfg=train_cases.STEP_OPT, seed=2,
                  log_every=1, device="cpu",
                  on_metrics=lambda s, m: seen.append(s)).run(
        STEPS, params=pp, opt_state=adamw_init(pp))
    hist = out["history"]
    assert [h["step"] for h in hist] == seen == list(range(STEPS))
    assert out["steps_per_s"] > 0
    for h, r in zip(hist, ref_hist):
        assert h["tokens"] == r["tokens"]
        for k in ("loss", "nll"):
            assert h[k] == pytest.approx(r[k], abs=1e-4), (h["step"], k)
        assert h["grad_norm"] == pytest.approx(r["grad_norm"], rel=1e-4)
        assert h["lr"] == pytest.approx(r["lr"], rel=1e-6)


def test_run_with_restarts_is_bit_exact_and_real_errors_propagate(tmp_path):
    restarts, same, drill, whole = train_cases.restart_drill(
        get_config("stablelm_3b").reduced(), str(tmp_path), device="cpu")
    assert restarts == 1 and same
    assert [h["step"] for h in drill] == [3, 4, 5]   # resumed after step 2
    assert [h["loss"] for h in drill] == [h["loss"] for h in whole[3:]]

    class Broken:
        def run(self, num_steps, failure=None):
            raise RuntimeError("loss is nan")

    built = []
    with pytest.raises(RuntimeError, match="nan"):
        run_with_restarts(lambda: built.append(1) or Broken(), 5,
                          failure_steps=(1,))
    assert len(built) == 1


def test_compressors_match_the_reference(rng):
    shapes = {"w": (6, 10), "stack": (2, 3, 4), "b": (5,)}
    # magnitudes from a few values: top-k cuts through ties
    grads = [{k: (rng.choice([-2.0, -1.0, 1.0, 2.0, 0.5], size=s)
                  * 1e-3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    for port_c, ref_c in ((port_comp.Int8Compressor(),
                           ref_comp.Int8Compressor()),
                          (port_comp.TopKCompressor(0.25),
                           ref_comp.TopKCompressor(0.25))):
        p_res = port_c.init({k: torch.tensor(v) for k, v in grads[0].items()})
        r_res = ref_c.init(jax.tree.map(jnp.asarray, grads[0]))
        for g in grads:
            p_pay, p_res = port_c.compress(
                {k: torch.tensor(v) for k, v in g.items()}, p_res)
            r_pay, r_res = ref_c.compress(jax.tree.map(jnp.asarray, g),
                                          r_res)
            p_dec, r_dec = port_c.decompress(p_pay), ref_c.decompress(r_pay)
            for k in shapes:
                if isinstance(port_c, port_comp.TopKCompressor):
                    assert np.array_equal(p_pay[k][1].numpy(),
                                          np.asarray(r_pay[k][1])), k
                    assert p_pay[k][1].dtype == torch.int32
                    np.testing.assert_array_equal(p_pay[k][0].numpy(),
                                                  np.asarray(r_pay[k][0]))
                    assert p_pay[k][2] == tuple(r_pay[k][2])
                else:
                    np.testing.assert_array_equal(p_pay[k][0].numpy(),
                                                  np.asarray(r_pay[k][0]))
                    assert float(p_pay[k][1]) == pytest.approx(
                        float(r_pay[k][1]), rel=1e-7)
                np.testing.assert_allclose(p_res[k].numpy(), r_res[k],
                                           rtol=1e-6, atol=1e-10)
                np.testing.assert_allclose(p_dec[k].numpy(), r_dec[k],
                                           rtol=1e-6, atol=1e-10)
        assert port_c.wire_bytes(p_res) == ref_c.wire_bytes(r_res)


def test_launcher_prints_the_reference_lines_and_needs_a_card(capsys):
    res = launch_train.main(["--arch", "stablelm_3b", "--reduced",
                             "--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "32"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step     0  loss ")
    assert "  lr " in lines[0] and "  gnorm " in lines[0]
    assert lines[1].startswith("done: 1 log points, ")
    assert lines[1].endswith(" steps/s")
    first = res["history"][0]["loss"]
    assert lines[2] == f"loss {first:.4f} -> {first:.4f}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            launch_train.main(["--arch", "stablelm_3b", "--reduced",
                               "--steps", "1"])
        assert capsys.readouterr().out == ""
