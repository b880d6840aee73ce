"""Atomic checkpoints of numpy / torch trees: the port's copy of the
reference's ``repro.checkpoint.ckpt``, without JAX.

Layout per step:  <dir>/step_<N>.tmp/ -> (atomic rename) -> step_<N>/
    manifest.json            tree paths, dtypes, shapes, step, extra
    arr_<i>.npy              one file per leaf

* atomicity — a crash mid-write leaves only a ``.tmp`` directory, which
  :func:`latest_step`, :func:`completed_steps` and restore ignore;
* async — :meth:`CheckpointManager.save_async` copies the tree to host
  RAM at once and writes it on a background thread;
* malformed ``step_*`` entries (``step_final``, editor droppings) are
  skipped with a warning, never parsed into a crash.

A tree is nested dicts, lists and tuples of leaves; dict keys are walked
in sorted order and each leaf's path is written the way the reference's
``jax.tree_util`` writes it (``['sim']/['carry']/[0]``), so a manifest
reads the same on both sides.  A leaf is a numpy array, a torch tensor
(copied to the host) or a Python scalar.  Dtypes numpy stores natively
(float, int, uint and bool) are stored as they are; a ``bfloat16`` tensor,
which numpy cannot hold, is stored as the reference's ``_encode`` stores
it, its bits in a ``uint16`` view with ``"bfloat16"`` in the manifest, and
restored as a ``torch.bfloat16`` tensor with the same bits; anything else
(an object array, complex) raises ``TypeError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import warnings
from typing import Any

import numpy as np
import torch

_NATIVE_KINDS = "fiub"
_BF16 = "bfloat16"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (the host numpy array to store, its logical dtype name);
    a bfloat16 tensor as its bits in a uint16 view; refuses other dtypes
    numpy cannot store."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        try:
            arr = t.numpy()
        except TypeError as e:
            raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor: "
                            f"numpy has no native {leaf.dtype}") from e
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind not in _NATIVE_KINDS:
        raise TypeError(f"cannot checkpoint dtype {arr.dtype}: only float, "
                        f"int, uint, bool and bfloat16 leaves are stored")
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, dtype_name: str, path: str):
    """A stored array as its logical dtype: a bfloat16 leaf's uint16 bits
    as a ``torch.bfloat16`` tensor, any other leaf as it was stored."""
    if arr.dtype.name == dtype_name:
        return arr
    if dtype_name == _BF16 and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise TypeError(f"checkpoint leaf {path} holds {arr.dtype}, its "
                    f"manifest says {dtype_name}")


def _snapshot(leaf):
    """A host copy of a leaf, taken now (a bfloat16 tensor stays one)."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return leaf.detach().cpu().clone()
    return _host(leaf)[0].copy()


def _flatten(tree, prefix=()):
    """(paths, leaves) of a tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return ["/".join(prefix)], [tree]
    paths, leaves = [], []
    for key, sub in items:
        p, lv = _flatten(sub, prefix + (key,))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order
    (dict keys sorted); each dict keeps ``like``'s key order."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: dict | None = None) -> str:
    """Synchronous save with atomic rename.  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    paths, leaves = _flatten(tree)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr, dtype_name = _host(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": p, "file": fname,
                                   "dtype": dtype_name,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic publish
    return final


def _step_entries(directory: str, *,
                  require_manifest: bool = True) -> list[tuple[int, str]]:
    """Well-formed finalized ``step_<N>`` entries as (step, dirname) pairs;
    a malformed name is skipped with a warning."""
    out = []
    for d in os.listdir(directory):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            s = int(d[len("step_"):])
        except ValueError:
            warnings.warn(f"ignoring malformed checkpoint entry {d!r} in "
                          f"{directory}", RuntimeWarning, stacklevel=3)
            continue
        if require_manifest and not os.path.exists(
                os.path.join(directory, d, "manifest.json")):
            continue
        out.append((s, d))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    """The largest finalized step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [s for s, _ in _step_entries(directory)]
    return max(steps) if steps else None


def completed_steps(directory: str) -> list[int]:
    """Sorted step ids with a finalized (manifest-bearing) checkpoint: the
    cells a resumed sweep restores instead of simulating."""
    if not os.path.isdir(directory):
        return []
    return [s for s, _ in _step_entries(directory)]


def require_layout(extra: dict, expected: dict, *, context: str = "") -> None:
    """Raise ``ValueError`` naming the first key of ``expected`` (policy,
    chunk_jobs, reps, k, ...) whose value differs from the checkpoint's
    manifest ``extra``: a run never resumes across a layout change."""
    for key in expected:
        got, want = extra.get(key), expected[key]
        if got != want:
            where = f" {context}" if context else ""
            raise ValueError(
                f"checkpoint{where} was written with {key}={got!r} but "
                f"this run is configured with {key}={want!r}; refusing to "
                f"resume across a layout change — stale ckpt_dir?")


def restore_checkpoint(directory: str, tree_like, *,
                       step: int | None = None) -> tuple[Any, int, dict]:
    """Restore step ``step`` (default: the latest) into the structure of
    ``tree_like``: ``(tree of numpy arrays, bfloat16 leaves as CPU
    tensors, step, extra)``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    paths, _ = _flatten(tree_like)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for p in paths:
        e = by_path[p]
        arr = np.load(os.path.join(path, e["file"]))
        out.append(_decode(arr, e["dtype"], p))
    return (_unflatten(tree_like, iter(out)), manifest["step"],
            manifest.get("extra", {}))


@dataclasses.dataclass
class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional background writes."""

    directory: str
    keep: int = 3

    def __post_init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, *, extra: dict | None = None):
        """Copy the tree to host RAM now, write it on a background
        thread."""
        self.wait()
        _, leaves = _flatten(tree)
        host_tree = _unflatten(tree, iter(
            [_snapshot(x) for x in leaves]))

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra)
                self._gc()
            except Exception as e:  # pragma: no cover
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, *, extra: dict | None = None) -> str:
        self.wait()
        out = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return out

    def restore(self, tree_like, *, step: int | None = None):
        self.wait()
        return restore_checkpoint(self.directory, tree_like, step=step)

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def _gc(self):
        entries = _step_entries(self.directory, require_manifest=False)
        for _, d in entries[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)
