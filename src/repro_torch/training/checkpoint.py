"""Checkpoints of the single-device trainer: atomic, keep-k, exact.

Twin of ``src/repro/training/checkpoint.py`` for one device. Layout:
``<dir>/step_<n>/arrays.npz`` (the flattened key path of every tensor ->
its host array; bf16 stored as its int16 bits) and ``meta.json`` (step,
the caller's extra data). A save writes a temporary directory and renames
it, so a preemption mid-save never corrupts the latest checkpoint;
``restore`` rebuilds the template's structure with each leaf in the
template's dtype and on its device, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _items(tree: Any, prefix: str = ""):
    """(key path, leaf) pairs of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree: Any, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return flat[prefix[:-1]]


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: Any,
             extra: Optional[Dict] = None) -> str:
        items = list(_items(state))
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_save_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{k: _to_host(v) for k, v in items})
            meta = {"step": step, "extra": extra or {},
                    "dtypes": {k: str(v.dtype) for k, v in items}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any) -> Tuple[Any, Dict]:
        """The state saved at ``step`` in ``template``'s structure, each
        leaf in the template leaf's dtype and on its device."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for key, leaf in _items(template):
                arr = z[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint shape mismatch at {key}: "
                                     f"{arr.shape} vs {tuple(leaf.shape)}")
                t = torch.from_numpy(arr.copy())
                if meta["dtypes"][key] == "torch.bfloat16":
                    t = t.view(torch.bfloat16)
                flat[key] = t.to(device=leaf.device, dtype=leaf.dtype)
        return _rebuild(template, flat), meta

    def restore_latest(self, template: Any):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template)
