"""Build and load the grouped-matmul CUDA library (nvcc, plain C interface,
ctypes).

The library is compiled at first use from ``csrc/moe_gmm.cu`` (CUDA
cores), ``csrc/moe_gmm_tc.cu`` (bf16 prefill blocks on wgmma) and
``csrc/moe_gmm_dec.cu`` (bf16 decode blocks on mma.sync), the last two
with ``kernels/csrc/hopper.cuh``, by
:class:`repro_torch.kernels._build.Library` into ``build/`` at the
repository root, under a directory named by a hash
of the sources, the header and the flags.  The kernels are held to a
tolerance of their plain version, not to bit identity, so nvcc may
contract multiplies and adds into FMAs (no ``--fmad=false``).  Nothing
here runs at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import ARCH, Library

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "moe_gmm.cu", _HERE / "csrc" / "moe_gmm_tc.cu",
           _HERE / "csrc" / "moe_gmm_dec.cu")
HEADERS = (_HERE.parent / "csrc" / "hopper.cuh",)
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("moe_gmm", SOURCES, NVCC_FLAGS, {
    # x, w, block_expert, nvalid, out, M, K, N, E, block_m, is_bf16, stream
    "moe_gmm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w, block_expert, nvalid, out, M, K, N, E, block_m, stream (bf16)
    "moe_gmm_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, block_expert, nvalid, out, scratch, counters, M, K, N, E,
    # block_m, grid_max, stream (bf16)
    "moe_gmm_dec": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}, error_fn="moe_gmm_error_string", headers=HEADERS)

__all__ = ["HEADERS", "LIBRARY", "NVCC_FLAGS", "SOURCES"]
