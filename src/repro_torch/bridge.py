"""Carry JAX-initialised weights and ECC-protected matrices into the port.

``params_from_numpy(tree)`` takes the JAX package's param pytree with its
leaves as numpy arrays (``np.asarray`` of each ``jax.Array``) and returns
the port's param dict: the same keys, tensors instead of arrays, and the
stacked ``layers`` axis split into a list of per-layer dicts.  bf16 leaves
cross through their 16-bit pattern (the uint16 view the fleet wire codec
uses); int8 / uint8 / float32 leaves (W8A8 ``w_q``/``scale``, W4A16
``w_p4``/``scale4``) are copied as they are, so nothing is re-initialised
or re-rounded.

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
