"""The port's serving engine against the JAX reference engine.

The scenario of ``tests/test_substrate.py``'s serving test — stablelm-3b
requests (2 chips) and yi-9b requests (8 chips) on a 64-chip fleet, 20
arrivals — runs through both engines on the CPU (where both serve the
``reduced()`` configs).  Admission is pure bookkeeping, so everything is
held equal: the partition, the metrics, the placement and start of every
job, p_helper, and the pull-backs after completions.  Then ``run_request``
runs one job of each class with the reference's weights carried into both
engines' ``_params``; in float32 compute the outputs are equal token for
token (``tests/test_torch_models.py`` states why the logits are compared
there, not here).  The same two checks run with moonshot-v1-16b-a3b
(MoE), with rwkv6-7b (RWKV6, at its own chip need) and with
jamba-1.5-large (hybrid, at the chip need of the one-block cut that
``chip_smoke.py`` serves) and with deepseek-v3 (MoE with MLA, at the
chip need of the five-layer cut that ``chip_smoke.py`` serves) in place
of yi-9b.  A vlm or encdec request fails in both engines alike: their
``run_request`` prefills the prompt's tokens only, and the model's
prefill needs the image embeddings or the frames (ROADMAP Queue 3, R7).
``chips_needed`` and ``cache_bytes`` equal the reference's for every
config.  A bfloat16 engine keeps in float32 exactly the
leaves the reference reads in float32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_jaxref  # noqa: F401  (the R1 alias, before any repro import)

import jax
from repro.configs import get_config as ref_get_config
from repro.serve import engine as ref_engine
from repro.serve import kv_cache as ref_kv

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine, kv_cache

PORTED = ARCH_IDS
# (name, arch, bucket, chips, mean service s, arrival mix): test_substrate's
CLASSES = (("small", "stablelm_3b", 8192, 2, 1.0, 0.8),
           ("big", "yi_9b", 8192, 8, 4.0, 0.2))
MOE_CLASSES = (CLASSES[0], ("big", "moonshot_v1_16b_a3b", 8192, 8, 4.0, 0.2))
# rwkv6-7b at its own chip need at bucket 8192 (2 chips)
RWKV_CLASSES = (CLASSES[0], ("big", "rwkv6_7b", 8192, 2, 4.0, 0.2))
# jamba-1.5-large at the chip need of its one-block, 8-of-16-experts cut
JAMBA_CLASSES = (CLASSES[0], ("big", "jamba_1_5_large_398b", 8192, 8, 4.0,
                              0.2))
# deepseek-v3 at the chip need of its five-layer cut (serve.cuts.mla_cut)
MLA_CLASSES = (CLASSES[0], ("big", "deepseek_v3_671b", 8192, 8, 4.0, 0.2))


def _engines(classes_=CLASSES, **over):
    """The reference's and the port's engine on the CPU, same classes."""
    def classes(mod, get):
        return [mod.RequestClass(n, dataclasses.replace(get(a), **over), b,
                                 c, s, al) for n, a, b, c, s, al in classes_]
    ref = ref_engine.ServingEngine(classes(ref_engine, ref_get_config),
                                   fleet_chips=64, seed=0)
    port = engine.ServingEngine(classes(engine, get_config), fleet_chips=64,
                                seed=0, device="cpu")
    return ref, port


def _submit(eng, mod, n=20, max_new_tokens=4):
    rng = np.random.default_rng(0)
    for i in range(n):
        eng.submit(mod.Request(rid=i, cls_name="small" if i % 5 else "big",
                               prompt=rng.integers(1, 100, 8),
                               max_new_tokens=max_new_tokens),
                   now=float(i) * 0.01)


def _state(eng):
    s = eng.sched
    jobs = {jid: (r.rid, r.cls_name, r.admitted_at)
            for jid, r in eng._jobs.items()}
    running = {jid: (j.cls, j.need, j.arrival, j.start, j.placement)
               for jid, j in s.running.items()}
    return (dict(eng.metrics), jobs, running, [j.jid for j in s.helper_wait],
            [list(f) for f in s.free_slots], s.helper_free,
            dict(s.helper_used), s.n_arrivals, s.n_helper_served,
            eng.p_helper, eng.mean_wait())


def test_admission_equals_reference_event_for_event():
    _admission_event_for_event(CLASSES)


def test_moe_admission_equals_reference_event_for_event():
    _admission_event_for_event(MOE_CLASSES)


def test_rwkv_admission_equals_reference_event_for_event():
    assert RWKV_CLASSES[1][3] == kv_cache.chips_needed(
        get_config("rwkv6_7b"), 1, 8192) == ref_kv.chips_needed(
            ref_get_config("rwkv6_7b"), 1, 8192) == 2
    _admission_event_for_event(RWKV_CLASSES)


def test_hybrid_admission_equals_reference_event_for_event():
    _admission_event_for_event(JAMBA_CLASSES)


def test_mla_admission_equals_reference_event_for_event():
    _admission_event_for_event(MLA_CLASSES)


def _admission_event_for_event(classes):
    ref, port = _engines(classes)
    assert port.device.type == "cpu"
    for a, b in zip(ref.partition.slices + (ref.partition.helper,),
                    port.partition.slices + (port.partition.helper,)):
        assert (a.name, a.start, a.size, a.need) == (b.name, b.start,
                                                     b.size, b.need)
    assert ref.partition.psi == port.partition.psi
    port.partition.validate()
    _submit(ref, ref_engine)
    _submit(port, engine)
    assert port.metrics["admitted_direct"] > 0
    assert _state(ref) == _state(port)
    # completions in a fixed order: slots freed, rule-3 pull-backs and
    # helper FCFS decisions must agree after every event
    t = 1.0
    while ref.sched.running:
        jid = min(ref.sched.running)
        t += 0.25
        ref.complete(jid, t)
        port.complete(jid, t)
        assert _state(ref) == _state(port), jid
    assert port.metrics["completed"] == 20 and not port.sched.helper_wait


def test_run_request_equals_reference_token_for_token():
    _token_for_token(CLASSES)


def test_moe_run_request_equals_reference_token_for_token():
    port = _token_for_token(MOE_CLASSES)
    assert port._model("big").cfg.family == "moe"


def test_rwkv_run_request_equals_reference_token_for_token():
    port = _token_for_token(RWKV_CLASSES)
    assert port._model("big").cfg.family == "ssm"


def test_hybrid_run_request_equals_reference_token_for_token():
    port = _token_for_token(JAMBA_CLASSES)
    assert port._model("big").cfg.family == "hybrid"


def test_mla_run_request_equals_reference_token_for_token():
    port = _token_for_token(MLA_CLASSES)
    assert port._model("big").cfg.mla is not None


@pytest.mark.parametrize("arch", ["llama_3_2_vision_90b",
                                  "seamless_m4t_large_v2"])
def test_run_request_of_a_cross_attention_class_fails_in_both(arch):
    """R7: the engines prefill ``{"tokens": prompt}`` only, so a vlm or
    encdec request finds no image embeddings or frames, in the reference
    and in the port alike (``KeyError``)."""
    ref, port = _engines((CLASSES[0], ("big", arch, 8192, 8, 4.0, 0.2)),
                         compute_dtype="float32")
    _submit(ref, ref_engine, n=10, max_new_tokens=2)
    _submit(port, engine, n=10, max_new_tokens=2)
    jid = next(j for j in sorted(port.sched.running)
               if port._jobs[j].cls_name == "big")
    for eng in (ref, port):
        with pytest.raises(KeyError):
            eng.run_request(jid)


def _token_for_token(classes):
    ref, port = _engines(classes, compute_dtype="float32")
    _submit(ref, ref_engine, n=10, max_new_tokens=4)
    _submit(port, engine, n=10, max_new_tokens=4)
    ran = set()
    for jid, job in sorted(port.sched.running.items()):
        name = port._jobs[jid].cls_name
        if name in ran:
            continue
        ran.add(name)
        port._params[name] = params_from_jax(
            jax.tree.map(np.asarray, ref._get_params(name)), device="cpu")
        out_ref = ref.run_request(jid).output
        out_port = port.run_request(jid).output
        assert len(out_port) == 4
        assert out_port == out_ref, name
        assert all(0 <= t < port._model(name).cfg.vocab_size
                   for t in out_port)
        req = port._jobs[jid]
        assert req.prefill_s > 0 and req.decode_s > 0
    assert ran == {"small", "big"}
    return port


def test_run_request_on_the_engines_own_weights():
    """The port's engine makes its own weights from ``seed`` (bfloat16 on
    load, the configs' compute dtype) and serves the test_substrate
    request: four tokens in the vocabulary."""
    _, port = _engines()
    _submit(port, engine)
    jid = next(iter(port.sched.running))
    out = port.run_request(jid)
    assert len(out.output) == 4
    name = out.cls_name
    assert port._params[name]["head"].dtype == torch.bfloat16
    assert all(0 <= t < port._model(name).cfg.vocab_size
               for t in out.output)


# the leaves the reference reads in float32 (layers.py:115's norm gains,
# moe.py's router, rwkv.py's decay LoRA, decay bias, bonus and ln_x,
# mamba.py's dt / B / C projections, dt bias, A_log and D_skip), by family
NORMS = {"norm_attn", "norm_ffn", "final_norm"}
F32_LEAVES = {
    "moe": NORMS | {"router"},
    "ssm": NORMS | {"ln_x", "decay_w1", "decay_w2", "decay_bias",
                    "bonus_u"},
    "hybrid": NORMS | {"router", "x_dt", "dt_proj", "dt_bias", "x_B", "x_C",
                       "A_log", "D_skip"},
    # MLA's latent norms and the MTP head's two norms (rms_norm)
    "mla": NORMS | {"router", "q_norm", "kv_norm", "norm_h", "norm_e"},
}


@pytest.mark.parametrize("classes", [MOE_CLASSES, RWKV_CLASSES,
                                     JAMBA_CLASSES, MLA_CLASSES])
def test_bfloat16_engine_keeps_float32_read_leaves(classes):
    """A bfloat16 engine (the configs' own compute dtype) on the CPU keeps
    exactly the leaves the reference reads in float32 in float32, equal
    to the same seed's float32 init, and casts every other leaf to
    bfloat16 (the float32 init rounded)."""
    _, port = _engines(classes)
    _, port32 = _engines(classes, compute_dtype="float32")
    name = "big"
    got, want = port._get_params(name), port32._get_params(name)
    assert port._model(name).cfg.compute_dtype == "bfloat16"

    def walk(a, b, path=()):
        if isinstance(a, dict):
            for key in a:
                yield from walk(a[key], b[key], path + (key,))
        elif isinstance(a, (tuple, list)):
            for i, (x, y) in enumerate(zip(a, b)):
                yield from walk(x, y, path + (i,))
        else:
            yield path, a, b

    cfg = port._model(name).cfg
    family = "mla" if cfg.mla is not None else cfg.family
    seen = set()
    for path, a, b in walk(got, want):
        leaf = path[-1]
        assert b.dtype == torch.float32, path
        if leaf in F32_LEAVES[family]:
            seen.add(leaf)
            assert a.dtype == torch.float32, path
            assert torch.equal(a, b), path
        else:
            assert a.dtype == torch.bfloat16, path
            assert torch.equal(a, b.to(torch.bfloat16)), path
    assert seen == F32_LEAVES[family], seen


@pytest.mark.parametrize("arch", PORTED)
def test_chips_needed_and_cache_bytes_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for batch, seq in ((1, 8192), (8, 8192), (8, 131072)):
        assert kv_cache.cache_bytes(cfg, batch, seq) == ref_kv.cache_bytes(
            rcfg, batch, seq)
        assert kv_cache.chips_needed(cfg, batch, seq) == ref_kv.chips_needed(
            rcfg, batch, seq)
    for seq in (1, 2048, 2049, 10**6):
        assert kv_cache.context_bucket(seq) == ref_kv.context_bucket(seq)


@pytest.mark.parametrize("arch", ["yi_9b", "moonshot_v1_16b_a3b",
                                  "rwkv6_7b", "jamba_1_5_large_398b"])
def test_decode_step_bench_runs_on_the_cpu(arch):
    """bench/decode_step.run (the prefill and per-step decode timer) on a
    reduced float32 config, asked for the CPU."""
    from repro_torch.bench import decode_step
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    r = decode_step.run(cfg, 16, 3, 0, device="cpu")
    assert r["arch"] == cfg.name and r["device"] == "cpu"
    assert len(r["decode_ms"]) == 3 and r["prefill_ms"] > 0
    assert min(r["decode_ms"]) == r["decode_ms_min"] > 0


@pytest.mark.parametrize("arch", ["stablelm_3b", "yi_9b", "deepseek_v3_671b",
                                  "llama_3_2_vision_90b",
                                  "seamless_m4t_large_v2"])
def test_layer_by_layer_decode_vs_forward_catches_cache_faults(arch):
    """bench/decode_vs_forward on a reduced float32 model on the CPU: the
    teacher-forced decode matches the prefill layer by layer within 1e-4
    of each row's largest element (float32 products of 1 row and of S + 1
    rows summed in other orders; LAYER_TOL is 156 times that),
    free-running logits agree, and a decode step at the wrong position or
    on an unseeded cache is beyond LAYER_TOL in some layer.  MLA's
    absorbed decode and expanded prefill, cross-attention's static cache
    and the encoder (run once per prompt, its layers not compared) are
    held alike; the vlm gate is set to 0.5 so that its cross layers add
    to the residual.  The reduced vlm is ten layers deep, twice the
    others, and at this init (``tests/test_torch_models.py``: attention
    nearly an argmax) its free-running logits keep 6.9e-3 of float32
    rounding after them, so its free-running bound is 1e-2; each of its
    layers meets the 1e-4 all the same."""
    from repro_torch.bench import decode_vs_forward as dvf
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    for stage in params["stages"]:
        for lay in stage.values():
            if "gate" in lay["attn"]:
                lay["attn"]["gate"].fill_(0.5)
    S = 31
    toks = torch.tensor(np.random.default_rng(3).integers(
        1, cfg.vocab_size, S + 1))
    extra = dvf.stub_inputs(cfg, dvf.frame_rows(cfg, S + dvf.PAD), 4, "cpu")
    rel = dvf.layer_by_layer(model, params, toks, S, extra=extra)
    assert len(rel) == cfg.num_layers and max(rel) < 1e-4
    free_tol = 1e-2 if cfg.num_layers > 4 else 1e-3
    assert dvf.free_running(model, params, toks, S, extra=extra) < free_tol
    assert max(dvf.layer_by_layer(model, params, toks, S, pos=S - 1,
                                  extra=extra)) > dvf.LAYER_TOL
    assert max(dvf.layer_by_layer(model, params, toks, S, seed_cache=False,
                                  extra=extra)) > dvf.LAYER_TOL
