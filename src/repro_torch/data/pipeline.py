"""Deterministic synthetic token pipeline: the port's copy of the
reference's ``repro/data/pipeline.py``.

``SyntheticTokens`` is the reference's numpy stream, unchanged: batch
``i`` is a pure function of (seed, i), a seeded PRNG over a Zipfian
vocabulary with short-range structure (repeated n-grams) so the LM loss
actually decreases, so a restart from a checkpointed step resumes the
exact stream.  ``make_train_batches`` yields the same batches as tensors
on ``device`` (the card unless the caller asks for the CPU), with the
vlm's ``image_emb`` and the encdec's ``frames`` drawn as the reference
draws them and rounded once to bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram: int = 8            # repeat window that makes the stream learnable

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Global batch for ``step`` (callers slice their data shard)."""
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        # zipf over vocab, clipped
        raw = rng.zipf(self.zipf_a, size=(B, S + 1))
        tok = (raw - 1) % self.vocab_size
        # inject learnable structure: copy a window every `ngram` tokens
        k = self.ngram
        for off in range(k, S + 1, 2 * k):
            tok[:, off:off + k] = tok[:, off - k:off]
        tok = tok.astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def shard_batch(self, step: int, shard: int, num_shards: int
                    ) -> dict[str, np.ndarray]:
        b = self.batch(step)
        per = self.global_batch // num_shards
        sl = slice(shard * per, (shard + 1) * per)
        return {k: v[sl] for k, v in b.items()}


def make_train_batches(cfg, global_batch: int, seq_len: int, seed: int = 0,
                       *, device="cuda"):
    """Iterator of (step, batch) with the model's train inputs as tensors
    on ``device``: int32 tokens and labels, and for vlm / encdec the
    stub frontend's embeddings (normal x 0.02, float64 rounded to
    bfloat16, as the reference's ``jnp.asarray(..., jnp.bfloat16)``)."""
    src = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).to(device)

    step = 0
    while True:
        b = {k: torch.from_numpy(v).to(device)
             for k, v in src.batch(step).items()}
        if cfg.family == "vlm":
            rng = np.random.default_rng((seed, step, 7))
            b["image_emb"] = bf16(rng.normal(
                size=(global_batch, cfg.num_image_tokens, cfg.d_model))
                * 0.02)
        if cfg.family == "encdec":
            rng = np.random.default_rng((seed, step, 8))
            n_frames = cfg.num_frame_tokens or seq_len
            b["frames"] = bf16(rng.normal(
                size=(global_batch, n_frames, cfg.d_model)) * 0.02)
        yield step, b
        step += 1
