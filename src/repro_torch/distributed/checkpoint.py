"""Fault-tolerant checkpointing, the port's own copy of
``repro.distributed.checkpoint`` (numpy files, no JAX).

Layout:  <dir>/step_<n>/shard_<i>.npz + manifest.json, written atomically
(tmp dir + rename).  Keeps the last ``keep`` steps.  Restore validates the
manifest (leaf count, structure, shapes, dtypes).

A tree is nested dicts (keys sorted, as ``jax.tree.flatten`` sorts them),
lists, tuples and ``None`` (a node without leaves); anything else is a
leaf: a numpy array, a torch tensor or a scalar.  The manifest's
``treedef`` is the text ``str(jax.tree.flatten(tree)[1])`` gives for the
same tree, and the files are the JAX package's, so each package restores
the other's checkpoints.  A bfloat16 leaf is written as its uint16 view
under the dtype name ``"bfloat16"`` and restored as a ``torch.bfloat16``
tensor (no ``ml_dtypes``); other leaves come back as torch tensors where
``like_tree`` holds a tensor, else as numpy arrays.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch


def _flatten(tree) -> tuple[list, str]:
    """(leaves, treedef text): the leaves in ``jax.tree.flatten``'s order
    and the text of its ``PyTreeDef``."""
    leaves: list = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in keys) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(x) for x in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        leaves.append(node)
        return "*"

    text = walk(tree)
    return leaves, f"PyTreeDef({text})"


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(x) for x in node]
        if isinstance(node, tuple):
            return tuple(build(x) for x in node)
        return next(it)

    return build(like)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the npz holds: bfloat16 as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:  # npz has no native bf16
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    keep: int = 3) -> str:
    """Atomically persist a tree; returns the final path."""
    leaves, treedef = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrs = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrs)
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": treedef,
            "shapes": [list(arrs[f"leaf_{i}"].shape)
                       for i in range(len(leaves))],
            "dtypes": [_dtype_name(l) for l in leaves],
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    valid = [d for d in steps
             if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return int(valid[-1].split("_")[1]) if valid else None


def restore_checkpoint(ckpt_dir: str, like_tree, step: int | None = None
                       ) -> tuple[object, dict]:
    """Restore into the structure of ``like_tree``; returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "shard_0.npz"))
    leaves_like, treedef = _flatten(like_tree)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"model expects {len(leaves_like)}")
    if manifest["treedef"] != treedef:
        # same leaf count but another structure would restore leaves into
        # the wrong places (e.g. a fleet blob set whose rid keys changed)
        raise ValueError(
            f"checkpoint treedef does not match like_tree:\n"
            f"  saved:    {manifest['treedef']}\n"
            f"  expected: {treedef}")
    leaves = []
    for i, like in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        saved_dt = manifest["dtypes"][i]
        want_dt = _dtype_name(like)
        if saved_dt != want_dt:
            # restored bytes must mean what the like_tree says they mean
            raise ValueError(f"leaf {i}: checkpoint dtype {saved_dt} != "
                             f"expected {want_dt}")
        shape = tuple(like.shape) if isinstance(like, torch.Tensor) \
            else np.shape(like)
        if list(arr.shape) != list(shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != {shape}")
        if saved_dt == "bfloat16":
            leaves.append(torch.from_numpy(
                np.ascontiguousarray(arr).view(np.int16)).view(
                    torch.bfloat16))
        elif isinstance(like, torch.Tensor):
            leaves.append(torch.from_numpy(np.ascontiguousarray(arr)))
        else:
            leaves.append(arr)
    return _unflatten(like_tree, leaves), manifest["extra"]
