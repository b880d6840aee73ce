"""Build and load the msj_scan CUDA library (nvcc, plain C interface, ctypes).

The library is compiled at first use from ``csrc/msj_scan.cu`` and
``csrc/srpt_scan.cu`` (one ``nvcc -c`` per source, all started together,
then one link) into
``build/`` at the repository root, under a directory named by a hash of
the sources and the flags, so an edited source builds anew and an
unchanged one is loaded from the cache.  Nothing here runs at import:
the CPU-only test machines import this module without a CUDA toolkit.
A missing ``nvcc``, a failed compile or a failed load raises
``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "msj_scan.cu", _HERE / "csrc" / "srpt_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None


def build_dir() -> Path:
    """``build/`` at the repository root (``src/repro_torch/...`` up 4)."""
    return _HERE.parents[3] / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(/usr/local/cuda); the msj_scan kernels need the "
                       "CUDA toolkit to build")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return build_dir() / f"msj_scan-{h.hexdigest()[:16]}" / "libmsj_scan.so"


def build_library() -> Path:
    """Compile the library unless the cached build is current; its path.

    Each source compiles in its own ``nvcc -c`` process, all at once, and
    one ``nvcc -shared`` links the objects.  ``nvcc``'s output (with
    ``-Xptxas -v``: registers, shared memory and spills of each kernel) is
    kept beside the library as ``build.log``.
    """
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = []
    for c, p in zip(cmds, procs):
        o, e = p.communicate()
        results.append((c, p.returncode, o, e))
    tmp = out.with_name(f"{out.name}.{tag}")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    failed = [r for r in results if r[1] != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
        if proc.returncode != 0:
            failed = [results[-1]]
    (out.parent / "build.log").write_text("".join(
        " ".join(c) + "\n" + o + e for c, _, o, e in results))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        c, rc, _, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {c[-1]}:\n{err[-4000:]}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library (built at first use), with typed entry points."""
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "msj_fcfs_scan": [P, P, P, P, I, I, I, P],
        "msj_modbs_scan": [P, P, P, P, P, P, P, I, I, I, I, I, P],
        "msj_bs_scan": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        "msj_fcfs_fail_scan": [P, P, P, P, P, P, I, I, I, P],
        "msj_modbs_fail_scan": [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                P],
        "msj_bs_fail_scan": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                             I, I, I, I, P],
        "msj_srpt_scan": [P, P, P, P, P, I, P, P, P, P, P, P, P, P, I, I, I,
                          I, P],
        "msj_stable_sort": [P, P, P, P, P, P, I, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.msj_error_string.argtypes = [ctypes.c_int]
    lib.msj_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
