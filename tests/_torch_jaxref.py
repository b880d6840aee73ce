"""The JAX reference package as the port's tests use it.

Importing this module installs the one shim the reference needs on the
installed JAX: ``jax.experimental.enable_x64`` is gone from JAX 0.9, and
``repro.core.sim_jax``, ``sim_batch``, ``shard`` and
``kernels/msj_scan/ops.py`` import it; ``jax.enable_x64`` is the same
context manager under its new name.  The ``tests/test_torch_*.py`` files
import this module before any ``repro.core`` module.  Nothing in
``src/repro`` or ``src/repro_torch`` changes for it.

It also carries data across: :func:`port_batch` turns a reference
``BatchTrace`` into the port's, array for array.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro.core import engines as ref_engines  # noqa: E402
from repro.core import workload as ref_workload  # noqa: E402

from repro_torch.core import workload as port_workload  # noqa: E402


def port_batch(ref_batch):
    """The port's ``BatchTrace`` holding a reference batch's arrays."""
    return port_workload.BatchTrace.from_arrays(
        ref_batch.arrival, ref_batch.cls, ref_batch.service, ref_batch.need,
        ref_batch.k, ref_batch.C)




def x64():
    """The reference's float64 mode (``jax.experimental.enable_x64``)."""
    return jax.experimental.enable_x64()


__all__ = ["port_batch", "ref_engines", "ref_workload", "x64"]
