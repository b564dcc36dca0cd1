"""Carry JAX-initialised weights and ECC-protected matrices into the port.

``params_from_numpy(tree)`` takes the JAX package's param pytree with its
leaves as numpy arrays (``np.asarray`` of each ``jax.Array``) and returns
the port's param dict: the same keys, tensors instead of arrays, and the
stacked layer axes split into lists: ``layers`` ``[L, ...]`` into a list of
per-layer dicts (the moe family's routed stacks ``[L, E, D, F]`` become
each layer's ``[E, D, F]``, its float32 router ``{"w": [D, E]}``), the
hybrid family's ``groups`` ``[G, every, ...]`` into a list of G lists and
``tail`` ``[T, ...]`` into a list (``tail=None`` stays None).  bf16 leaves
cross through their 16-bit pattern (the uint16 view the fleet wire codec
uses); int8 / uint8 / float32 leaves (W8A8 ``w_q``/``scale``, W4A16
``w_p4``/``scale4``) are copied as they are, so nothing is re-initialised
or re-rounded.

``params_to_numpy(params)`` is the inverse: the port's params (or any tree
in their layout, such as their gradients or AdamW moments) with the layer
lists stacked back on leading axes, JAX's layout, leaves as numpy arrays;
numpy has no bfloat16, so a bf16 leaf stays a CPU ``torch.bfloat16``
tensor (``distributed/checkpoint.py`` writes it as JAX does).

``ecc_from_numpy`` and ``hybrid_from_numpy`` carry a JAX ``PageECC`` and
``HybridWeights`` over the same way; the 14-bit uint16 addresses become
int32, the port's address type.  numpy is the only interface: this module
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
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def params_from_numpy(tree: dict, device: str | torch.device = "cpu") -> dict:
    """JAX param pytree (numpy leaves, layers stacked) -> port params."""
    from repro_torch.models.model import STACKED

    out = _convert(tree)
    for key, depth in STACKED.items():
        if out.get(key) is not None:
            out[key] = _unstack(out[key], depth)
    return _to(out, torch.device(device))



def params_to_numpy(params: dict) -> dict:
    """Port params (layers in lists) -> JAX's layout (layers stacked),
    numpy leaves (bf16 leaves as CPU bf16 tensors)."""
    from repro_torch.models.model import STACKED

    out = dict(params)
    for key, depth in STACKED.items():
        if out.get(key) is not None:
            out[key] = _stack(out[key], depth)
    return _to_numpy(out)


def _stack(items: list, depth: int):
    """Stacked on the host: a card holds no second copy of the layers."""
    if depth > 1:
        items = [_stack(t, depth - 1) for t in items]
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in items], 1) for k in first}
    return torch.stack([t.detach().cpu() for t in items])


def _to_numpy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _unstack(tree, depth: int) -> list:
    n = next(iter(_leaves(tree))).shape[0]
    items = [_index(tree, i) for i in range(n)]
    return items if depth == 1 else [_unstack(t, depth - 1) for t in items]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def ecc_from_numpy(ecc, device: str | torch.device = "cpu"):
    """JAX ``PageECC`` (numpy fields) -> the port's ``core.ecc.PageECC``."""
    from repro_torch.core.ecc import PageECC

    return PageECC(
        threshold=_tensor(ecc.threshold).to(device),
        addr=torch.from_numpy(np.asarray(ecc.addr).astype(np.int32)
                              ).to(device),
        addr_parity=_tensor(ecc.addr_parity).to(device),
        copies=_tensor(ecc.copies).to(device))


def hybrid_from_numpy(hw, device: str | torch.device = "cpu"):
    """JAX ``HybridWeights`` (numpy fields) -> the port's."""
    from repro_torch.core.hybrid_gemv import HybridWeights

    return HybridWeights(
        flash_wq=_tensor(hw.flash_wq).to(device),
        flash_scale=_tensor(hw.flash_scale).to(device),
        npu_wq=_tensor(hw.npu_wq).to(device),
        npu_scale=_tensor(hw.npu_scale).to(device),
        ecc=None if hw.ecc is None else ecc_from_numpy(hw.ecc, device),
        tile_h=int(hw.tile_h), tile_w=int(hw.tile_w))
