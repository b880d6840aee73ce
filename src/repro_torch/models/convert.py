"""Carry a reference parameter tree across to the port.

``params_from_jax(tree)`` takes the JAX package's params as numpy arrays
(the same nested dicts and tuples: ``embed``, ``stages[i]["l0"]`` stacked
over layers on axis 0, ``final_norm``, ``head``) and returns the port's
params: the same tree of tensors, with the same shapes and layouts
(``wq`` [L, d, H, Dh], ``wo`` [L, H, Dh, d], ...) and dtypes, so nothing is
transposed by hand.  It imports nothing of JAX; the caller turns the
reference's arrays into numpy (``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                       # a writable copy of its own
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, *, device="cuda"):
    """The reference's param tree (numpy leaves) as the port's (tensors on
    ``device``: the card unless the caller asks for the CPU, as the port's
    other entry points)."""
    return tree_map(lambda a: _tensor(a, device), tree)
