"""Fault-tolerant checkpoints of a training state.

The port's counterpart of ``repro/train/checkpoint.py``, with its
guarantees:

* **atomic**: a checkpoint is written to ``<dir>/.tmp-<step>-<pid>`` and
  moved into place with ``os.replace``, so a crash mid-save never corrupts
  the latest checkpoint;
* **async**: ``AsyncCheckpointer`` copies the state to host memory at once,
  then serializes it on a background thread, keeping the last ``keep``;
* **self-describing**: a metadata JSON beside each checkpoint holds the
  step, the time and a manifest of every array's shape; ``latest_step``
  finds the newest step for a restart.

A state is a nested dict (or list) of ``nn.Module``s (stored through their
``state_dict``, buffers included), tensors, numpy arrays and ints,
flattened to numpy arrays under the port's names joined by ``/``
(``model/item_emb.weight``, ``opt/v/head.fc0.bias``, ``opt/count``; a list
index is a name). ``restore`` loads them back into a template of the same
structure: modules in place, tensors onto the template's devices, arrays as
arrays. It also reads a checkpoint the JAX package wrote, whose names are
keystrs (``['params']['item_emb']['table']``), into a template of the
reference's tree (``weights.export_params``' layout).

Elastic restore (``train/elastic.py``): ``restore``'s ``sharding_fn(path,
shape)`` gives each tensor or array leaf a placement
(``distributed/sharding.Placement``) or None. A placed leaf comes back as
its blocks on the placement's mesh (``ShardedLeaf``), so a checkpoint
written whole restores onto any mesh. A module's leaves are loaded in
place, never placed: a ``sharding_fn`` that places one raises.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a host numpy array (copied off the
    device), by its path."""
    out = {}
    for key, leaf in _items(tree):
        path = f"{prefix}{key}"
        if isinstance(leaf, (dict, list, nn.Module)):
            out.update(_flatten(leaf, path + SEP))
        elif isinstance(leaf, torch.Tensor):
            out[path] = leaf.detach().to("cpu", copy=True).numpy()
        else:
            out[path] = np.asarray(leaf)
    return out


def _items(tree: Any):
    if isinstance(tree, nn.Module):
        return tree.state_dict().items()
    return enumerate(tree) if isinstance(tree, list) else tree.items()


def _name(key: str) -> str:
    """A checkpoint's array name in the port's form: a JAX keystr
    ``['params']['blocks'][0]`` -> ``params/blocks/0``; the port's own
    names unchanged."""
    parts = re.findall(r"\['?([^'\]]+)'?\]", key)
    return SEP.join(parts) if parts else key


def _checked(flat: Dict[str, np.ndarray], path: str, shape: tuple) -> np.ndarray:
    if path not in flat:
        raise KeyError(f"checkpoint missing {path}")
    arr = flat[path]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {path}: checkpoint {arr.shape} vs "
                         f"template {tuple(shape)}")
    return arr


def _unflatten_into(tree: Any, flat: Dict[str, np.ndarray], prefix: str = "",
                    sharding_fn: Optional[Callable] = None) -> Any:
    if isinstance(tree, nn.Module):
        sd = tree.state_dict()
        for k, v in sd.items():
            if sharding_fn is not None and sharding_fn(prefix + k, tuple(v.shape)) is not None:
                raise ValueError(f"restore loads the module leaf {prefix + k} in place and "
                                 f"places none: restore it in a tree of tensors to shard it")
        tree.load_state_dict({k: torch.from_numpy(_checked(flat, prefix + k, v.shape))
                              for k, v in sd.items()})
        return tree
    out = [None] * len(tree) if isinstance(tree, list) else {}
    for key, leaf in _items(tree):
        path = f"{prefix}{key}"
        if isinstance(leaf, (dict, list, nn.Module)):
            out[key] = _unflatten_into(leaf, flat, path + SEP, sharding_fn)
        elif isinstance(leaf, (torch.Tensor, np.ndarray)):
            arr = _checked(flat, path, leaf.shape)
            placement = sharding_fn(path, tuple(arr.shape)) if sharding_fn is not None else None
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(dtype=leaf.dtype)
                out[key] = arr.to(leaf.device) if placement is None else placement.place(arr)
            else:
                arr = arr.astype(leaf.dtype, copy=False)
                out[key] = np.array(arr) if placement is None else placement.place(arr)
        else:
            out[key] = type(leaf)(_checked(flat, path, ()))
    return out


def _path(ckpt_dir: str, step: int, ext: str) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}{ext}")


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           extra: Optional[dict] = None) -> str:
    """Write ``flat`` and its metadata atomically; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    final = _path(ckpt_dir, step, ".npz")
    os.replace(tmp, final)
    meta = {"step": step, "time": time.time(),
            "n_params": int(sum(v.size for v in flat.values())),
            "manifest": {k: list(v.shape) for k, v in flat.items()}, **(extra or {})}
    mtmp = os.path.join(ckpt_dir, f".meta-tmp-{step}-{os.getpid()}")
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, _path(ckpt_dir, step, ".json"))
    return final


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Blocking atomic save of ``tree``; returns the checkpoint's path."""
    return _write(ckpt_dir, step, _flatten(tree), extra)


def _steps(ckpt_dir: str) -> list:
    return sorted(int(f[len("step_"):-len(".npz")]) for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".npz"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            sharding_fn: Optional[Callable] = None):
    """(state, step): checkpoint ``step`` (default the latest) loaded into
    ``template``'s structure; modules are loaded in place. ``sharding_fn
    (path, shape)`` (path ``/``-joined) places a tensor or array leaf where
    it returns a placement (``distributed/sharding.Placement``): the leaf
    comes back as its blocks; a module leaf it places raises."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(_path(ckpt_dir, step, ".npz")) as data:
        flat = {_name(k): data[k] for k in data.files}
    return _unflatten_into(template, flat, sharding_fn=sharding_fn), step


class AsyncCheckpointer:
    """Copy to host at ``save`` (the caller may then change the state),
    serialize on a worker thread, keep the last ``keep`` checkpoints.
    ``wait`` joins the save in flight; a failed save raises at the next
    ``save`` or ``wait``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[Exception] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        self.wait()
        flat = _flatten(tree)          # the device -> host copy happens here

        def work():
            try:
                _write(self.ckpt_dir, step, flat, extra)
                self._gc()
            except Exception as e:     # raised again by wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = _steps(self.ckpt_dir)
        for s in steps[:-self.keep] if self.keep else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(_path(self.ckpt_dir, s, ext))
                except FileNotFoundError:
                    pass

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
