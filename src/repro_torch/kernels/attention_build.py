"""The attention CUDA library: ``flash_attention/csrc/flash_attention.cu``
(CUDA cores), ``flash_attention/csrc/flash_attention_tc.cu`` (bf16 on the
tensor cores, with ``csrc/hopper.cuh``), the backward
``flash_attention/csrc/flash_attention_bwd.cu`` and
``decode_attention/csrc/decode_attention.cu``, built together at first use
by :class:`repro_torch.kernels._build.Library` into ``build/``.

The kernels are held to a tolerance of their plain versions, not to bit
identity, so nvcc may contract multiplies and adds into FMAs (no
``--fmad=false``, unlike the msj_scan library).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ._build import ARCH, Library

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "flash_attention" / "csrc" / "flash_attention.cu",
           _HERE / "flash_attention" / "csrc" / "flash_attention_tc.cu",
           _HERE / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
           _HERE / "decode_attention" / "csrc" / "decode_attention.cu")
HEADERS = (_HERE / "csrc" / "hopper.cuh",)
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = Library("attention", SOURCES, NVCC_FLAGS, {
    # q, k, v, o, lse (or None), B, Sq, Sk, H, Kh, D, Dv, scale, causal,
    # is_bf16, stream
    "attn_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                       _I, _I, _P],
    # q, k, v, o, lse (or None), B, Sq, Sk, H, Kh, D, Dv, scale, causal,
    # stream (bf16)
    "attn_flash_fwd_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _F, _I, _P],
    # q, k, v, o, lse, do, dq, dk, dv, delta, B, Sq, Sk, H, Kh, D, Dv,
    # scale, causal, is_bf16, stream
    "attn_flash_bwd": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P],
    # q, k, v, pos, part, o, B, Sk, H, Kh, D, Dv, KC, cmin, nx, kt,
    # stages, scale, is_bf16, stream
    "attn_decode_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _F, _I, _P],
}, error_fn="attn_error_string", headers=HEADERS)
