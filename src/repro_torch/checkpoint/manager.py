"""Checkpointing: atomic, async, keep-N.

Port of `repro.checkpoint.manager`, in the reference's format, so a
checkpoint written by either package restores in the other: one directory
per step holding `arrays.npz` (the leaves keyed by their path, dict keys
sorted and list indices, joined by '/': JAX's `tree_flatten_with_path`
keys) and `manifest.json` (step, keys, extra). Writes go to
`<dir>/.tmp.<name>` and then `os.replace`, so a crash leaves the last
checkpoint whole. The data stream's state (a small dict) rides in the
manifest, so a resumed job continues the stream where it stopped.

numpy has no bfloat16, so a bfloat16 leaf is written as float32 (exact);
`restore` casts every array to its target leaf's dtype and shape, as the
reference does, and places it on the target leaf's device. The snapshot to
the host that an async save takes before its thread starts goes through
`obs.host_copy`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as T


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return obs.host_copy(leaf.float() if leaf.dtype == torch.bfloat16 else leaf)
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {T.key(path): _host(leaf) for path, leaf in T.walk(tree)}


def save(path: str, tree, step: int, extra: Optional[dict] = None) -> None:
    """Atomic checkpoint write of a tree of tensors or numpy arrays."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp.{os.path.basename(path)}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": list(arrays.keys()), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`arr` as a tensor of `like`'s dtype, shape and device. A bfloat16
    array of the reference (ml_dtypes, or raw 2-byte records where numpy
    does not know the type) goes over by its bits."""
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(like.dtype).reshape(like.shape).to(like.device)


def restore(path: str, target_tree):
    """The checkpoint at `path` in the structure of `target_tree` (nested
    dicts and lists of tensors): each leaf cast to its target's dtype and
    shape, on its target's device."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = [_tensor(z[T.key(p)], leaf) for p, leaf in T.walk(target_tree)]
    return T.unflatten(target_tree, leaves)


def manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """keep-N rotation + async save + latest-step discovery."""

    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dirs(self) -> list[tuple[int, str]]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, d)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}")

    def save(self, step: int, tree, extra: Optional[dict] = None, block: bool = False):
        # snapshot to the host now: the train loop overwrites the leaves in place
        host_tree = T.map_leaves(_host, tree)

        def _do():
            save(self.path(step), host_tree, step, extra)
            self._gc()

        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, target_tree):
        step = self.latest_step()
        if step is None:
            return None, None
        p = self.path(step)
        return restore(p, target_tree), manifest(p)

    def _gc(self):
        dirs = self._step_dirs()
        for _, d in dirs[: -self.keep_n]:
            shutil.rmtree(d, ignore_errors=True)
