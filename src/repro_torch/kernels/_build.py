"""Build and load a CUDA library of the port (nvcc, plain C interface, ctypes).

A :class:`Library` is compiled at first use from its ``.cu`` sources (one
``nvcc -c`` per source, all started together, then one link) into
``build/`` at the repository root, under a directory named by a hash of
the sources, the headers they include and the flags, so an edited source
or header builds anew and an unchanged one is loaded from the cache.  Nothing here runs at import:
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

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")


def build_dir() -> Path:
    """``build/`` at the repository root (``src/repro_torch/kernels`` up 3)."""
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(/usr/local/cuda); the port's kernels need the "
                       "CUDA toolkit to build")


class Library:
    """One shared library: its sources, the headers of the repository they
    include, nvcc flags and C entry points.

    ``sigs`` maps each entry point to its ctypes argument types; every
    entry point returns an ``int`` (a ``cudaError_t``), and ``error_fn``
    names the entry point that turns one into its message.
    """

    def __init__(self, name: str, sources, flags, sigs: dict,
                 error_fn: str, headers=()):
        self.name = name
        self.sources = tuple(Path(s) for s in sources)
        self.headers = tuple(Path(h) for h in headers)
        self.flags = tuple(flags)
        self.sigs = sigs
        self.error_fn = error_fn
        self._lib: ctypes.CDLL | None = None

    def path(self) -> Path:
        """Where the library for the current sources, headers and flags
        lives."""
        h = hashlib.sha256(" ".join(self.flags).encode())
        for src in self.sources + self.headers:
            h.update(src.read_bytes())
        return (build_dir() / f"{self.name}-{h.hexdigest()[:16]}"
                / f"lib{self.name}.so")

    def build(self) -> Path:
        """Compile the library unless the cached build is current; its path.

        Each source compiles in its own ``nvcc -c`` process, all at once,
        and one ``nvcc -shared`` links the objects.  ``nvcc``'s output
        (with ``-Xptxas -v``: registers, shared memory and spills of each
        kernel) is kept beside the library as ``build.log``.
        """
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{os.getpid()}.tmp"
        objs = [out.parent / f"{src.stem}.{tag}.o" for src in self.sources]
        cmds = [[nvcc, *self.flags, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(self.sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        results = []
        for c, p in zip(cmds, procs):
            o, e = p.communicate()
            results.append((c, p.returncode, o, e))
        tmp = out.with_name(f"{out.name}.{tag}")
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
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
            raise RuntimeError(f"nvcc failed ({rc}) on {c[-1]}:\n"
                               f"{err[-4000:]}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library (built at first use), with typed entry
        points."""
        if self._lib is not None:
            return self._lib
        path = self.build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        for name, argtypes in self.sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, self.error_fn)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def raise_on(self, rc: int, kernel: str, shape: str) -> None:
        """Raise ``RuntimeError`` if an entry point returned an error."""
        if rc != 0:
            msg = getattr(self.load(), self.error_fn)(rc).decode()
            raise RuntimeError(f"{kernel} launch failed at {shape}: "
                               f"cudaError {rc} ({msg})")
