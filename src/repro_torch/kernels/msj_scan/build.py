"""Build and load the msj_scan CUDA library (nvcc, plain C interface, ctypes).

The library is compiled at first use from ``csrc/msj_scan.cu`` and
``csrc/srpt_scan.cu`` by :class:`repro_torch.kernels._build.Library`
(one ``nvcc -c`` per source, all started together, then one link) into
``build/`` at the repository root, under a directory named by a hash of
the sources and the flags.  ``--fmad=false`` keeps every float64
multiply and add separately rounded, as the reference's are: the kernels
are held bit-identical to it.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import ARCH, Library

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "msj_scan.cu", _HERE / "csrc" / "srpt_scan.cu")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library("msj_scan", SOURCES, NVCC_FLAGS, {
    "msj_fcfs_scan": [_P] * 5 + [_I] * 3 + [_P],
    "msj_modbs_scan": [_P] * 8 + [_I] * 5 + [_P],
    "msj_bs_scan": [_P] * 11 + [_I] * 6 + [_P],
    "msj_fcfs_fail_scan": [_P] * 7 + [_I] * 3 + [_P],
    "msj_modbs_fail_scan": [_P] * 10 + [_I] * 5 + [_P],
    "msj_bs_fail_scan": [_P] * 14 + [_I] * 8 + [_P],
    "msj_fcfs_stream": [_P] * 6 + [_I] * 3 + [_P],
    "msj_modbs_stream": [_P] * 9 + [_I] * 5 + [_P],
    "msj_bs_stream": [_P] * 19 + [_I] * 7 + [_P],
    "msj_srpt_scan": [_P] * 6 + [_I] + [_P] * 8 + [_I] * 4 + [_P],
    "msj_srpt_table_bytes": [_I, ctypes.POINTER(ctypes.c_longlong)],
    "msj_stable_sort": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
}, error_fn="msj_error_string")

__all__ = ["LIBRARY", "NVCC_FLAGS", "SOURCES"]
