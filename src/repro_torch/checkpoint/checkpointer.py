"""Async, atomic checkpointing with keep-k retention (counterpart of
`repro.checkpoint.checkpointer`; the port has no mesh, so no sharded restore).

- Atomic: a save writes `<dir>/tmp.<step>`, then `os.replace`s it to
  `<dir>/step_<N>`: a crash mid-save never corrupts the latest checkpoint.
- Async: `save()` copies the tree to host memory at once and writes it in a
  background thread (one writer, one save in flight), overlapping the next
  steps.
- keep-k retention with a `latest` pointer file.
- The npz keys are the reference's tree paths ("params/embed",
  "opt/step", "opt/m/groups/sub0/mix/wq", ...): a NamedTuple field by name, a
  dict entry by key. A checkpoint written by the JAX package's manager from
  its `TrainState` restores into the port's `TrainState`, and back.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_paths


def _unflatten_like(like, leaves: dict, prefix: str = ""):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_like(getattr(like, f), leaves,
                                            f"{prefix}/{f}" if prefix else f)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    return leaves[prefix]


def _to_numpy(x) -> np.ndarray:
    """A tensor as a host copy (never a view: the train step updates its
    tensors in place while the background writer runs); an array as it is."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # npz has no bf16: store widened
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


def save_tree(tree, directory, extra: Optional[dict] = None):
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in tree_paths(tree)}
    np.savez(d / "arrays.npz", **arrays)
    (d / "meta.json").write_text(json.dumps(extra or {}))


def restore_tree(like_tree, directory):
    """Restore into the structure of `like_tree`: each leaf takes the like
    leaf's dtype and device."""
    d = pathlib.Path(directory)
    leaves = {}
    with np.load(d / "arrays.npz") as z:
        for key, like in tree_paths(like_tree):
            arr = torch.from_numpy(np.array(z[key]))
            if isinstance(like, torch.Tensor):
                arr = arr.to(device=like.device, dtype=like.dtype)
            leaves[key] = arr
    return _unflatten_like(like_tree, leaves)


def load_meta(directory) -> dict:
    p = pathlib.Path(directory) / "meta.json"
    return json.loads(p.read_text()) if p.exists() else {}


class CheckpointManager:
    def __init__(self, root, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # ---- save ----------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None, block: bool = False):
        """Snapshot to host memory now; write + commit in the background."""
        snapshot = {k: _to_numpy(v) for k, v in tree_paths(tree)}
        meta = dict(extra or {}, step=int(step))
        self.wait()  # one in-flight save at a time

        def _write():
            tmp = self.root / f"tmp.{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            save_tree(snapshot, tmp, meta)  # flat keys: the paths themselves
            final = self.root / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            (self.root / "latest").write_text(final.name)
            self._gc()

        with self._lock:
            self._pending = self._pool.submit(_write)
        if block:
            self.wait()

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self):
        """Finish the save in flight and stop the writer thread."""
        self.wait()
        self._pool.shutdown(wait=True)

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # ---- restore -------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for p in self.root.glob("step_*"):
            m = re.match(r"step_(\d+)$", p.name)
            if m and (p / "arrays.npz").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: Optional[int] = None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self.root / f"step_{step:08d}"
        return restore_tree(like_tree, d), load_meta(d)
