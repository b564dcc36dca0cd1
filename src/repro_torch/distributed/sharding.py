"""Sharding rules: params / caches / batches -> partition specs, the port's
copy of ``repro.distributed.sharding``, and the slicing they imply.

Baseline layout (the paper's "flash tier"):
  * ``data``  axis: ZeRO-3-style parameter sharding (the capacity tier that
    plays the NAND flash role) + batch data parallelism;
  * ``model`` axis: tensor parallelism (attention heads / FFN hidden / expert
    parallelism / KV-sequence for decode);
  * ``pod``   axis (multi-pod): pure data parallelism on top.

Rules are name+shape driven with divisibility fallbacks, so every assigned
architecture (including awkward dims like smollm's 15 heads, qwen2-moe's 60
experts -- padded to 64 -- and mamba2's 3352-wide in_proj) gets a legal
spec.  They read only ``mesh.shape`` (a dict of axis sizes), so any object
with one will do, a ``distributed.mesh.Mesh`` among them.

A spec is a ``PartitionSpec``: a tuple with one entry a dim, each an axis
name, a tuple of names (major to minor) or None.  The port has no GSPMD:
``local_shard`` cuts a rank's slice of a tensor by its spec, and
``gather_shard`` (collective) puts the slices back together.

Paths name a leaf by its keys, as JAX's key paths do; the port keeps
stacked layers as lists, so its paths hold list indices (``("layers", 3,
"attn", "q", "w")``) and its leaves lack JAX's leading layer axes, which
every rule leaves unsharded.
"""

from __future__ import annotations

from typing import Any

import torch


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: ``PartitionSpec("data", None)``; an
    entry of one axis name in a tuple is that name, as JAX normalizes it."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# parent-dict names that mark a linear layer's weight
_LINEAR_KEYS = {"q", "k", "v", "o", "gate", "up", "down", "in_proj",
                "out_proj", "router", "kv_a", "kv_b", "lm_head", "xattn"}


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.shape and n % mesh.shape[axis] == 0 and n > 0


def _matmul_spec(shape, mesh, transposed: bool = False,
                 zero3: bool = True) -> P:
    """Spec for a linear weight [..., in, out] (or [..., out, in] if
    transposed, the W8A8 layout). Leading dims are layer stacks (replicated).
    zero3=True: out->model (TP) + in->data (the paper-faithful "flash tier" --
    weights stream via all-gather, the ship-weights path).
    zero3=False: TP-only residency (the planner's ship-activations answer for
    decode)."""
    nd = len(shape)
    d_in = shape[-1] if transposed else shape[-2]
    d_out = shape[-2] if transposed else shape[-1]
    in_ax = out_ax = None
    if _div(d_out, mesh, "model"):
        out_ax = "model"
        if zero3 and _div(d_in, mesh, "data"):
            in_ax = "data"
    elif _div(d_in, mesh, "model"):
        # TP on the contraction dim instead (mamba2-130m's ragged out dims)
        in_ax = "model"
    elif zero3 and _div(d_in, mesh, "data"):
        in_ax = "data"
    dims = [None] * nd
    if transposed:
        dims[-1], dims[-2] = in_ax, out_ax
    else:
        dims[-2], dims[-1] = in_ax, out_ax
    return P(*dims)


def _expert_spec(shape, mesh, zero3: bool = True) -> P:
    """MoE expert stacks [..., E, in, out]: expert-parallel on model."""
    nd = len(shape)
    dims = [None] * nd
    if _div(shape[-3], mesh, "model"):
        dims[-3] = "model"
        if zero3 and _div(shape[-2], mesh, "data"):
            dims[-2] = "data"
    else:
        return _matmul_spec(shape, mesh, zero3=zero3)
    return P(*dims)


def _vector_spec(shape, mesh, prefer: str = "model") -> P:
    dims = [None] * len(shape)
    if len(shape) and _div(shape[-1], mesh, prefer):
        dims[-1] = prefer
    return P(*dims)


def param_pspec(path: tuple, shape, mesh, zero3: bool = True) -> P:
    """The spec of the param at ``path`` (its keys) of ``shape``."""
    keys = [str(k) for k in path]
    name = "/".join(keys)
    shape = tuple(shape)
    parent = keys[-2] if len(keys) >= 2 else ""
    last = keys[-1] if keys else ""

    if last == "embed" or name.endswith("pos_embed") or last == "enc_pos":
        # [V, D]: vocab -> model (big tables), hidden -> data when divisible
        dims = [None] * len(shape)
        if _div(shape[0], mesh, "model"):
            dims[0] = "model"
        if len(shape) > 1 and _div(shape[-1], mesh, "data"):
            dims[-1] = "data"
        return P(*dims)
    if last in ("w", "w_q", "scale", "b") and parent == "router":
        return P(*([None] * len(shape)))
    if last == "w" and parent in _LINEAR_KEYS:
        return _matmul_spec(shape, mesh, zero3=zero3)
    if last == "w_q" and parent in _LINEAR_KEYS:
        return _matmul_spec(shape, mesh, transposed=True, zero3=zero3)
    if last == "scale" and parent in _LINEAR_KEYS:
        # follows w_q's out dim = scale's last dim
        dims = [None] * len(shape)
        if _div(shape[-1], mesh, "model"):
            dims[-1] = "model"
        return P(*dims)
    if last == "b" and parent in _LINEAR_KEYS:
        return _vector_spec(shape, mesh)
    if parent == "moe" or (last in ("gate", "up", "down") and len(shape) >= 3
                           and parent not in _LINEAR_KEYS):
        return _expert_spec(shape, mesh, zero3=zero3)
    if last in ("conv_w", "conv_b", "norm"):
        return _vector_spec(shape, mesh)  # channels -> model when divisible
    # norms, dt_bias, a_log, d_skip, thresholds... replicate
    return P(*([None] * len(shape)))


def tree_map_paths(fn, tree, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_paths(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def params_pspecs(params, mesh, zero3: bool = True):
    """The spec of every param, in the params' tree."""
    return tree_map_paths(lambda p, t: param_pspec(p, t.shape, mesh, zero3),
                          params)


# ---------------------------------------------------------------------------
# activations / caches / batches
# ---------------------------------------------------------------------------


def dp_axes(mesh):
    """Batch data-parallel axes: ('pod','data') when the pod axis exists."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def batch_pspec(mesh, batch: int, ndim: int = 2) -> P:
    axes = dp_axes(mesh)
    total = 1
    used = []
    for a in axes:
        if batch % (total * mesh.shape[a]) == 0:
            used.append(a)
            total *= mesh.shape[a]
    dims = [tuple(used) if used else None] + [None] * (ndim - 1)
    return P(*dims)


def cache_pspec(path: tuple, shape, mesh, batch: int) -> P:
    """KV caches [L, B, S, Hkv, Dh]: batch -> dp axes (when divisible),
    sequence -> model (flash-decoding style split-K; kv-head counts are
    often < model axis, sequence always divides).  SSM states: batch -> dp,
    last dim -> model when divisible."""
    keys = [str(k) for k in path]
    last = keys[-1] if keys else ""
    shape = tuple(shape)
    if last == "len" or len(shape) <= 1:
        return P()
    bspec = batch_pspec(mesh, batch, 1)[0]
    dims: list[Any] = [None] * len(shape)
    if last in ("k", "v", "xk", "xv", "ckv", "krope"):
        # [L, B, S, Hkv, Dh] or [L, B, S, R]: prefer kv-heads -> model
        # (local attention per head, no cross-shard softmax); fall back to
        # sequence -> model (flash-decoding split-K) for kv < model.  When the
        # batch can't use the dp axes (B=1), the sequence takes them instead
        dims[1] = bspec
        seq_ax = None
        if bspec is None and _div(shape[2], mesh, "data"):
            seq_ax = "data"
        if len(shape) >= 5 and _div(shape[3], mesh, "model"):
            dims[3] = "model"
            dims[2] = seq_ax
        elif seq_ax is not None:
            dims[2] = (seq_ax, "model") if _div(
                shape[2], mesh, "model") and shape[2] % (
                mesh.shape["model"] * mesh.shape["data"]) == 0 else seq_ax
        elif _div(shape[2], mesh, "model"):
            dims[2] = "model"
        return P(*dims)
    # mamba caches: conv [*, B, K-1, C], state [*, B, H, P, N]
    b_axis = len(shape) - 3 if last == "conv" else len(shape) - 4
    b_axis = max(b_axis, 0)
    dims[b_axis] = bspec
    if _div(shape[-1], mesh, "model"):
        dims[-1] = "model"
    return P(*dims)


def cache_pspecs(cache, mesh, batch: int):
    return tree_map_paths(lambda p, t: cache_pspec(p, t.shape, mesh, batch),
                          cache)


# ---------------------------------------------------------------------------
# slices
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` (a view; dims the spec
    leaves out are whole), as ``shard_map`` hands it to a device."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                             f"over {axes} ({n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.axis_index(axes) * size, size)
    return t


def gather_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``local_shard`` (collective over
    the spec's axes): ``local_shard``'s inverse."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        parts = mesh.all_gather(t.contiguous(), axes)
        t = torch.cat(list(parts), dim=dim)
    return t
