"""Build and load the WKV6 CUDA library (nvcc, plain C interface, ctypes).

The library is compiled at first use from ``csrc/wkv.cu`` by
:class:`repro_torch.kernels._build.Library` into ``build/`` at the
repository root, under a directory named by a hash of the source and the
flags.  The kernel is held to a tolerance of its plain version, not to bit
identity, so nvcc may contract multiplies and adds into FMAs (no
``--fmad=false``).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import ARCH, Library

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "wkv.cu",)
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("wkv", SOURCES, NVCC_FLAGS, {
    # r, k, v, logw, u, s0 (or NULL), y, s_T, scratch, B, S, H, N, chunk,
    # is_bf16, stream
    "wkv_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                _P],
}, error_fn="wkv_error_string")

__all__ = ["LIBRARY", "NVCC_FLAGS", "SOURCES"]
