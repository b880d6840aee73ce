"""KV cache accounting and context buckets.

The port's counterpart of ``repro/serve/kv_cache.py``.  The cache
*structure* lives with the model (``models.model.init_cache`` mirrors the
stage tree); this module adds the serving-side views: byte accounting per
request class (the gang scheduler's chip-need estimates) and
context-bucket helpers.  Shapes come from a cache on PyTorch's ``meta``
device, which allocates nothing.
"""

from __future__ import annotations

import math

from ..models.config import ArchConfig
from ..models.layers import tree_leaves
from ..models.model import init_cache, num_params


def cache_bytes(cfg: ArchConfig, batch: int, seq: int) -> int:
    """Total cache bytes for (batch, context length)."""
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(init_cache(cfg, batch, seq,
                                               device="meta")))


def chips_needed(cfg: ArchConfig, batch: int, seq: int, *,
                 hbm_per_chip: float = 16e9, param_bytes: int = 2,
                 headroom: float = 0.8) -> int:
    """Minimum chips so params (bf16) + cache fit — the serving job class's
    server need in the multiserver-job sense.  Rounded up to a power of
    two.  ``hbm_per_chip`` is the reference's default; pass a card's
    memory to size a fleet of cards."""
    total = num_params(cfg) * param_bytes + cache_bytes(cfg, batch, seq)
    chips = max(1, math.ceil(total / (hbm_per_chip * headroom)))
    return 1 << (chips - 1).bit_length()


def context_bucket(seq: int, buckets=(2048, 8192, 32768, 131072, 524288)
                   ) -> int:
    """Smallest bucket holding ``seq`` (request classes = arch x bucket)."""
    for b in buckets:
        if seq <= b:
            return b
    return buckets[-1]
