"""Checkpointing: atomic, keep-last-k, optional async (the reference's
`train/checkpoint.py`).

Layout:  <dir>/step_<n>/arrays.npz + tree.json  (+ .tmp staging, atomic
rename), as the reference writes it. A tree is nested dicts, lists and
tuples, and `TrainState`s (its params, opt and step as children 0, 1 and
2, as the reference's pytree flattens it), of tensors and Python numbers;
a leaf's key is its path, "/"-joined (the reference's key paths:
"0/<param>", "1/m/<param>", "1/step", "2").

The port's training state is updated in place, so `save` copies every leaf
to host memory before it returns, also when `async_` (the writer thread
then only writes files), and `restore` copies the stored values into the
template's own tensors (the masters stay the model's parameters).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.train.train_step import TrainState


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, TrainState):
        return list(enumerate((node.params, node.opt, node.step)))
    if isinstance(node, dict):
        return sorted(node.items(), key=lambda kv: str(kv[0]))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _leaves(tree, path=()):
    kids = _children(tree)
    if kids is None:
        yield "/".join(str(p) for p in path), tree
        return
    for key, child in kids:
        yield from _leaves(child, path + (key,))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf)


def _flatten(tree) -> dict:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _structure(tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{k!s}: {_structure(c)}" for k, c in kids)
    return f"{type(tree).__name__}({inner})"


def save(directory: str, step: int, tree, keep: int = 3,
         async_: bool = False) -> threading.Thread | None:
    """Write checkpoint for `step`. Returns the writer thread if async."""
    flat = _flatten(tree)               # host copies, before any later step
    structure = _structure(tree)

    def _write():
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"step": step, "treedef": structure,
                       "keys": sorted(flat)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic publish
        _gc(directory, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _rebuild(node, data, path=()):
    kids = _children(node)
    if kids is None:
        key = "/".join(str(p) for p in path)
        arr = data[key]
        if isinstance(node, torch.Tensor):
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"{key}: stored {arr.shape}, template "
                                 f"{tuple(node.shape)}")
            with torch.no_grad():
                node.copy_(torch.from_numpy(arr))
            return node
        return type(node)(arr.item())
    out = {k: _rebuild(c, data, path + (k,)) for k, c in kids}
    if isinstance(node, TrainState):
        return TrainState(out[0], out[1], out[2])
    if isinstance(node, dict):
        return {k: out[k] for k in node}
    return type(node)(out[i] for i in range(len(node)))


def restore(directory: str, template, step: int | None = None):
    """Restore into the structure of `template` (shapes must match):
    tensors are filled in place, other leaves made anew. Returns (tree,
    step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _rebuild(template, data), step
