"""Carry JAX-initialised weights into the port.

``params_from_numpy(tree)`` takes the JAX package's param pytree with its
leaves as numpy arrays (``np.asarray`` of each ``jax.Array``) and returns
the port's param dict: the same keys, tensors instead of arrays, and the
stacked ``layers`` axis split into a list of per-layer dicts.  bf16 leaves
cross through their 16-bit pattern (the uint16 view the fleet wire codec
uses), int8 / float32 W8A8 leaves are copied as they are, so nothing is
re-initialised or re-rounded.  numpy is the only interface: this module
does not import JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _convert(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v) for v in tree)
    return _tensor(tree)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i].clone()


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def params_from_numpy(tree: dict, device: str | torch.device = "cpu") -> dict:
    """JAX param pytree (numpy leaves, layers stacked) -> port params."""
    out = _convert(tree)
    if "layers" in out:
        stacked = out["layers"]
        n = next(iter(_leaves(stacked))).shape[0]
        out["layers"] = [_index(stacked, i) for i in range(n)]
    return _to(out, torch.device(device))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
