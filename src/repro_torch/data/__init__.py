"""Data sources of the port: SWF-like traces synthesized from Tables 2/3,
and the synthetic token stream of training."""

from .pipeline import SyntheticTokens, make_train_batches

__all__ = ["SyntheticTokens", "make_train_batches"]
