"""Double-buffered weight streaming -- the paper's Slice Control on a mesh,
the port's copy of ``repro.distributed.hybrid_stream``.

The paper interleaves NPU-bound weight reads into the channel bubbles left
by read-compute requests.  On a mesh the same idea: while layer k computes
on its (already gathered) weights, layer k+1's ZeRO-3-sharded weights are
gathered in the background.

Every rank calls these on the slices it holds (the JAX functions'
``shard_map`` bodies); ``mesh`` is a ``distributed.mesh.Mesh``.
``streamed_matmul_chain`` is the demonstrable primitive: y = x @ W1 @ W2
... with every Wi sharded over ``axis`` and gathered one step ahead.
"""

from __future__ import annotations

import torch


def ring_all_gather(shard: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """All-gather along ``axis`` by a ring of ``ppermute``s: n - 1 steps,
    each passing the block received last to the next rank."""
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    blocks = [None] * n
    blocks[idx] = shard
    buf = shard
    for i in range(n - 1):
        buf = mesh.ppermute(buf, axis, perm)
        blocks[(idx - i - 1) % n] = buf
    return torch.cat(blocks, dim=0)


def streamed_matmul_chain(x: torch.Tensor, weight_shards: list,
                          mesh, axis: str = "data") -> torch.Tensor:
    """x: [B, D0] (the same on every rank); weight_shards[i]: this rank's
    rows [Di/n, Di+1] of W_i, sharded on ``axis``.

    Gathers W_{i+1} while computing x @ W_i (double buffering): the
    gather for the next layer is issued, as the mesh's asynchronous
    all-gather, before the current product and waited on after it."""
    n = mesh.axis_size(axis)

    def issue(shard):
        return mesh.all_gather(shard, axis, async_op=True)

    def whole(pending, shard):
        return pending.wait().reshape(n * shard.shape[0], *shard.shape[1:])

    nxt = whole(issue(weight_shards[0]), weight_shards[0])
    for i in range(len(weight_shards)):
        w = nxt
        pending = None
        if i + 1 < len(weight_shards):
            pending = issue(weight_shards[i + 1])   # prefetch
        x = x @ w.to(x.dtype)
        if pending is not None:
            nxt = whole(pending, weight_shards[i + 1])
    return x


def alpha_split_matmul(x: torch.Tensor, w_shard: torch.Tensor, mesh,
                       alpha: float, axis_store: str = "data") -> torch.Tensor:
    """The paper's alpha-split on a mesh (``core/partition_plan.py`` in the
    JAX package decides alpha).  x: [B, D] (the same on every rank);
    w_shard: this rank's rows [D/n, H] of w, sharded on ``axis_store``.

    Columns [0, alpha H) run ship-activations (weights stay sharded on
    ``axis_store``, partial matvec + psum -- "read-compute request");
    columns [alpha H, H) run ship-weights (all-gather then local matmul --
    "read request").  Numerically x @ w (the partial products summed in
    rank order); the two collective schedules coexist so they can overlap
    (the paper's channel-bubble filling)."""
    h = w_shard.shape[1]
    h_act = int(alpha * h)
    parts = []
    if h_act:
        # "read-compute": W sharded on the contraction dim; every shard
        # computes a partial GeMM on resident weights, small output psum'd
        rows = w_shard.shape[0]
        i = mesh.axis_index(axis_store)
        x_slice = x[:, i * rows:(i + 1) * rows]
        parts.append(mesh.psum(x_slice @ w_shard[:, :h_act].to(x.dtype),
                               axis_store))
    if h_act < h:
        # "read": stream (gather) the weight rows, compute locally
        w_gat = ring_all_gather(w_shard[:, h_act:].contiguous(), axis_store,
                                mesh)
        parts.append(x @ w_gat.to(x.dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)
