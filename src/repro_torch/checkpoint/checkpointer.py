"""Checkpointing: async snapshot, manifest + content hashes, restore.

The port of the reference's ``repro.checkpoint.checkpointer``, writing
and reading the reference's format, so that a checkpoint written by either
package restores into the other:

* a ``step_%010d`` directory, written as ``step_%010d.tmp`` and renamed
  when complete (the rename is the completion marker);
* one ``.npy`` per leaf, a bfloat16 leaf as its ``uint16`` bits;
* ``manifest.json``: ``{"step", "shards": {path: {file, shape, dtype,
  sha256}}}``, keyed by the leaf's path as ``jax.tree_util`` names it
  (:func:`leaf_paths`).

``save`` copies the tensors to the host (blocking only for the copy) and
writes on a background thread; ``restore`` verifies every hash and shape
and puts each leaf on the device and in the dtype of the matching leaf of
``like``.  The newest *complete* step wins (``latest_complete``).  The
reference's ``shardings`` (a restore onto another mesh) has no counterpart
on one device.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch


def leaf_paths(tree: Any, prefix: tuple = ()) -> list:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order, each path as the
    reference's checkpointer joins ``tree_flatten_with_path``'s keys: a
    dict key as ``['k']`` (sorted keys), a named tuple's field as
    ``.field`` (field order), a list or tuple item as ``[i]``, joined by
    ``/``; e.g. ``['opt']/.mu/['layers']/['norm']``."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaf_paths(tree[k], prefix + (f"['{k}']",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for f in tree._fields
                for pair in leaf_paths(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, t in enumerate(tree)
                for pair in leaf_paths(t, prefix + (f"[{i}]",))]
    return [("/".join(prefix), tree)]


def _rebuild(like: Any, it) -> Any:
    """``like``'s structure with its leaves taken from ``it`` in
    :func:`leaf_paths` order."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), it)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, it) for t in like)
    return next(it)


def _sanitize(p: str) -> str:
    return p.replace("[", "_").replace("]", "").replace("'", "").replace("/", "__")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 as its ``uint16`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@dataclass
class Checkpointer:
    directory: str
    keep: int = 3

    def __post_init__(self):
        Path(self.directory).mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Snapshot ``tree`` (nested dicts and named tuples of tensors) to
        the host, then write it in the background (or now, with
        ``blocking``).  One save is in flight at a time."""
        self.wait()
        pairs = leaf_paths(tree)
        host = [(p, _dtype_name(t), _to_numpy(t)) for p, t in pairs]

        def write():
            d = Path(self.directory) / f"step_{step:010d}.tmp"
            d.mkdir(parents=True, exist_ok=True)
            manifest = {"step": step, "shards": {}}
            for p, dtype, arr in host:
                fn = _sanitize(p) + ".npy"
                np.save(d / fn, arr)
                h = hashlib.sha256((d / fn).read_bytes()).hexdigest()
                manifest["shards"][p] = {
                    "file": fn,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "sha256": h,
                }
            (d / "manifest.json").write_text(json.dumps(manifest))
            os.rename(d, Path(self.directory) / f"step_{step:010d}")
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        done = sorted(Path(self.directory).glob("step_??????????"))
        for old in done[: -self.keep]:
            for f in old.iterdir():
                f.unlink()
            old.rmdir()

    # -- restore --------------------------------------------------------------

    def latest_complete(self) -> int | None:
        steps = []
        for d in Path(self.directory).glob("step_??????????"):
            if (d / "manifest.json").exists():
                steps.append(int(d.name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``, each leaf on the device
        and in the dtype of ``like``'s.  Raises ``IOError`` on a hash
        mismatch and ``ValueError`` on a shape mismatch."""
        d = Path(self.directory) / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        out = []
        for p, leaf in leaf_paths(like):
            meta = manifest["shards"][p]
            fn = d / meta["file"]
            if hashlib.sha256(fn.read_bytes()).hexdigest() != meta["sha256"]:
                raise IOError(f"checkpoint shard corrupt: {p}")
            arr = np.load(fn)
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {p}: ckpt {arr.shape} vs model"
                    f" {tuple(leaf.shape)}")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return _rebuild(like, iter(out))
