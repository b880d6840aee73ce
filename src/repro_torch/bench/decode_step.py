"""Prefill and greedy decode step times of one model at full width.

Makes the model's weights from ``--seed`` on the card in its compute dtype
(as ``ServingEngine`` does), runs one prefill of ``--prompt`` random
tokens and ``--tokens`` greedy decode steps, and prints one JSON line: the
prefill's and each decode step's wall time on the host clock, each ending
in a synchronise, with the package's path and the card's name::

    PYTHONPATH=src python -m repro_torch.bench.decode_step --arch yi_9b

The file imports the port by absolute name, so running it as a script
with ``PYTHONPATH`` set to another checkout's ``src`` times that
checkout's package with the same timer (two versions compared in one
call, on one card)::

    PYTHONPATH=/path/to/other/src python src/repro_torch/bench/decode_step.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model, init_cache
from repro_torch.serve.engine import _seed_caches


def run(cfg, prompt: int, tokens: int, seed: int, device="cuda") -> dict:
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        dtype=dtype_of(cfg.compute_dtype))
    toks = torch.randint(1, cfg.vocab_size, (1, prompt), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 1))
    sync()
    t0 = time.perf_counter()
    logits, pre = model.prefill(params, {"tokens": toks})
    caches = _seed_caches(init_cache(cfg, 1, prompt + tokens, device=dev),
                          pre, prompt)
    tok = logits.argmax(-1)[:, None]
    sync()
    prefill_s = time.perf_counter() - t0
    steps = []
    for t in range(prompt, prompt + tokens):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, caches, tok, t)
        tok = logits.argmax(-1)[:, None]
        sync()
        steps.append(time.perf_counter() - t0)
    if not torch.isfinite(logits).all():
        raise RuntimeError(f"{cfg.name}: non-finite logits")
    ms = [s * 1e3 for s in steps]
    return {"arch": cfg.name, "package": repro_torch.__file__,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"), "prompt": prompt,
            "prefill_ms": prefill_s * 1e3, "decode_ms_median":
            statistics.median(ms), "decode_ms_mean": statistics.mean(ms),
            "decode_ms_min": min(ms), "decode_ms": ms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="yi_9b")
    p.add_argument("--prompt", type=int, default=512)
    p.add_argument("--tokens", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_step: no CUDA device")
    print(json.dumps(run(get_config(a.arch), a.prompt, a.tokens, a.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
