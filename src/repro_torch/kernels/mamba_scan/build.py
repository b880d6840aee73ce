"""Build and load the selective-scan CUDA library (nvcc, plain C interface,
ctypes).

The library is compiled at first use from ``csrc/mamba_scan.cu`` by
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
SOURCES = (_HERE / "csrc" / "mamba_scan.cu",)
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("mamba_scan", SOURCES, NVCC_FLAGS, {
    # a, b, c, y, B, S, d_in, N, ab_bf16, c_bf16, stream
    "mamba_scan_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # dt, A, Bm, u, C, h0 (or NULL), y, h_T, B, S, d_in, N, u_bf16, stream
    "mamba_scan_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
}, error_fn="mamba_scan_error_string")

__all__ = ["LIBRARY", "NVCC_FLAGS", "SOURCES"]
