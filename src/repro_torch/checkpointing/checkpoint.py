"""Checkpointing: atomic, keep-N, async; the reference's on-disk layout.

Layout (one directory per step), the same as ``repro.checkpointing``'s, so
a checkpoint written by either package loads in the other:

    <dir>/step_000000000042/
        manifest.json      {"step": 42, "leaves": {key: {file, shape, dtype}}}
        <leaf>.npy         full logical arrays

* **Keys** — a leaf's key is its path in the tree, the dict keys and list
  indices joined with ``/`` (what ``jax.tree_util.tree_flatten_with_path``
  gives for the same nested dict), and its file the key with ``/`` as
  ``__``.  Leaves are float32 or int32; any other type raises until a slice
  needs it.
* **Atomic publish** — written to ``step_X.tmp`` then ``os.rename``d, so a
  reader never sees a partial checkpoint and a killed writer leaves only a
  ``.tmp`` directory that is ignored (and removed by the next save).
* **Placement** — leaves are stored whole; ``load(..., device=...)`` puts
  them on the device the restarted job runs on (``device=None`` means the
  card, as at every entry point of the port).
* **Async** — ``AsyncCheckpointer`` copies the tree to the host on the
  caller's thread and writes the files on a background thread; a queue
  depth of 1 applies backpressure.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

_STEP_RE = re.compile(r"^step_(\d+)$")
DTYPES = ("float32", "int32")          # the leaf types a checkpoint holds


def _map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                    prefix: Tuple[str, ...] = (), sort: bool = False) -> Any:
    """``fn(key, leaf)`` over a tree of dicts and lists, keeping its
    structure and key order; ``sort`` visits dict keys in sorted order, as
    JAX flattens."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else list(tree)
        return {k: _map_with_paths(fn, tree[k], prefix + (str(k),), sort)
                for k in keys}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, prefix + (str(i),), sort)
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(key, leaf) in ``jax.tree_util.tree_flatten_with_path``'s order."""
    out: List[Tuple[str, Any]] = []
    _map_with_paths(lambda key, leaf: out.append((key, leaf)), tree,
                    sort=True)
    return out


def _host_array(key: str, leaf: Any) -> np.ndarray:
    # a copy: a host tensor updated in place later must not change it
    arr = (leaf.detach().to("cpu", copy=True).numpy()
           if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
    if str(arr.dtype) not in DTYPES:
        raise TypeError(f"leaf {key}: a checkpoint holds {DTYPES}, not "
                        f"{arr.dtype}")
    return arr


def save(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Blocking save with atomic publish; returns the final path.  Leaves
    are tensors (on any device) or numpy arrays."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:012d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for key, leaf in _flatten_with_paths(tree):
        arr = _host_array(key, leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    _garbage_collect(directory, keep)
    return final


def _garbage_collect(directory: str, keep: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:012d}"),
                      ignore_errors=True)
    for name in os.listdir(directory):          # stale tmp dirs
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def load(directory: str, step: int, target: Any,
         device: Union[None, str, torch.device] = None) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors or of
    :class:`repro_torch.models.common.LeafSpec`; only the leaves' shapes
    are read) as tensors on ``device``."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]

    def restore(key: str, leaf: Any) -> torch.Tensor:
        ent = manifest.get(key)
        if ent is None:
            raise KeyError(f"checkpoint {path} is missing leaf {key}")
        arr = np.load(os.path.join(path, ent["file"]))
        if str(arr.dtype) not in DTYPES:
            raise TypeError(f"leaf {key}: a checkpoint holds {DTYPES}, not "
                            f"{arr.dtype}")
        expect = tuple(leaf.shape)
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"leaf {key}: checkpoint shape {arr.shape} != {expect}")
        return torch.from_numpy(arr).to(dev)

    return _map_with_paths(restore, target)


def load_latest(directory: str, target: Any,
                device: Union[None, str, torch.device] = None
                ) -> Optional[Tuple[int, Any]]:
    steps = list_steps(directory)
    if not steps:
        return None
    step = steps[-1]
    return step, load(directory, step, target, device)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with queue depth 1."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None      # guarded-by: _lock
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any) -> None:
        host_tree = _map_with_paths(_host_array, tree)
        with self._lock:
            if self._pending is not None:
                self._pending.result()          # backpressure
            self._pending = self._pool.submit(
                save, self.directory, step, host_tree, self.keep)

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
