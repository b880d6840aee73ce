"""Hand-written CUDA kernels of the port, each beside its plain version."""

from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError`` where a kernel without a backward
    kernel would be launched on inputs that autograd tracks.

    A CUDA wrapper writes its output into a buffer through ``ctypes``, so
    that output has no ``grad_fn``: a loss computed through it would get
    zero or no gradient for everything upstream, without a word.  The
    wrappers call this on their CUDA branch only; on the CPU the plain
    versions are ordinary autograd graphs."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: its backward kernel is not yet ported (ROADMAP.md "
            f"Queue 2), so it cannot run on the card on inputs that "
            f"require grad; call it under torch.no_grad(), or on the CPU")
