"""Optimizer and gradient compression of the port's training path."""

from .compression import Int8Compressor, TopKCompressor
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, cosine_schedule, opt_state_axes)

__all__ = ["AdamWConfig", "Int8Compressor", "TopKCompressor", "adamw_init",
           "adamw_update", "clip_by_global_norm", "cosine_schedule",
           "opt_state_axes"]
