"""Int8 gradient compression with error feedback, the port's copy of
``repro.distributed.grad_compress`` (the data-parallel all-reduce at
1000+-node scale).

quantize -> all-reduce int8 (4x fewer bytes than float32) -> dequantize;
the residual (g - dequant(quant(g))) is carried to the next step so the
compression is unbiased over time (error-feedback SGD, Seide et al. 2014 /
Karimireddy et al. 2019).

The JAX functions run traced (under ``jit`` in the train step, inside
``shard_map`` for the all-reduce), where XLA turns each division by a
constant into a multiply by its float32 reciprocal (ROADMAP C1): the port
multiplies by ``INV127`` and by ``1 / n`` where JAX divides by 127.0 and
by the axis size.  A division by a traced value (``g / scale``) stays a
division.

``make_error_feedback_transform`` compresses each leaf of JAX's layout
with one scale: JAX stacks a model's layers on a leading axis, so the
absmax of, say, every layer's ``attn.q.w`` sets one scale for all of
them; the port keeps its layers in lists (``models.model.STACKED``), so
the transform takes the absmax over the list before it quantizes each
layer's tensor.  The codes are then the stacked leaf's, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.checkpoint import tree_leaves, tree_unflatten
from repro_torch.quant.int8 import INV127


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(absmax * INV127, 1e-12)


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(g.abs().amax())
    return _quantize(g, scale), scale.float()


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def psum_compressed(g: torch.Tensor, axis, mesh) -> torch.Tensor:
    """Mean-all-reduce in int8 over a mesh axis (every rank of the axis
    calls it on its own g).

    The quantization scale is agreed globally first (pmax of |g|) so the
    int8 payloads are commensurable; the int32 sum is exact in any order.
    Sends the int8 codes (1/4 of float32's bytes) and widens them to int32
    after the gather."""
    g = g.float()
    scale = _scale(mesh.pmax(g.abs().amax(), axis))
    q = _quantize(g, scale)
    parts = mesh.all_gather(q, axis, kind="psum_compressed")
    summed = parts[0].to(torch.int32)
    for p in parts[1:]:
        summed = summed + p.to(torch.int32)
    inv_n = float(np.float32(1.0 / mesh.axis_size(axis)))
    return summed.float() * scale * inv_n


def _jax_leaf_names(tree):
    """A tree shaped as ``tree`` whose leaves name the leaf of JAX's
    layout each one belongs to: in a model's params (or a tree in their
    layout) the tensors of a ``models.model.STACKED`` key's layer lists
    share the name of the leaf JAX stacks them into; every other leaf has
    a name of its own."""
    from repro_torch.models.model import STACKED

    def walk(node, path, drop):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),),
                            STACKED.get(k, 0) if not path
                            and isinstance(v, list) else 0)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):   # leaves in the same order
            return [walk(x, path + ("*" if drop else str(i),),
                         max(drop - 1, 0)) for i, x in enumerate(node)]
        return "/".join(path)

    return walk(tree, (), 0)


def make_error_feedback_transform():
    """(init_state, transform): ``transform(grads, err) ->
    (compressed_grads, new_err)`` over trees of dicts and lists; the error
    buffers start at zeros in float32.  A train step takes it as
    ``make_train_step(grad_transform=lambda g: transform(g, err)[0])``,
    the caller keeping ``err``.  One scale a leaf of JAX's layout: a
    model's layer lists share theirs (``_jax_leaf_names``)."""
    def init_state(params):
        return tree_unflatten(params, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)])

    def transform(grads, err):
        pairs = list(zip(tree_leaves(grads), tree_leaves(err)))
        names = tree_leaves(_jax_leaf_names(grads))
        absmax = {}
        for name, (g, e) in zip(names, pairs):
            a = (g.float() + e).abs().amax()
            absmax[name] = a if name not in absmax \
                else torch.maximum(absmax[name], a)
        outs = []
        for name, (g, e) in zip(names, pairs):
            g = g.float() + e
            scale = _scale(absmax[name]).float()
            deq = decompress(_quantize(g, scale), scale)
            outs.append((deq, g - deq))
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(grads, [o[1] for o in outs]))

    return init_state, transform
