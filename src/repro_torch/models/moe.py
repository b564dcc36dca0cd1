"""Mixture-of-Experts layer: top-k routing and the grouped GEMM over the
routed experts, plus the shared experts.

Counterpart of ``repro.models.moe``, formula for formula, with its two
execution paths:

* **Local** (no mesh): the (token, slot) pairs are sorted by expert and go
  through one grouped GEMM per stacked weight (``jax.lax.ragged_dot`` in
  JAX; the hand-written ``kernels/grouped_gemm`` kernels on CUDA: bf16
  for serving, and float32 for training, whose gradient is the dX and dW
  kernels of ``GroupedGemmF32``, ``jax.value_and_grad`` of
  ``ragged_dot``).  ``params["up"].to(xs.dtype)`` is the leaf itself in
  float32, so the stacks' gradients reach it.

* **Expert-parallel** (a mesh with a ``model`` axis in
  ``distributed.ctx``): each model rank holds ITS ``e / n`` experts'
  stacks only (the slice ``P("model", None, None)`` of ``up`` / ``gate``
  / ``down``; the router and the shared experts whole), takes its tokens'
  slice over the data axes (``batch_pspec``), sorts the (token, slot)
  pairs that hit its experts into a fixed ``capacity``-bounded buffer
  (hits first, the dump bucket last: 2x balanced load, floored at 64,
  capped at n k), runs the grouped GEMM over its local experts (rows past
  the groups' sum come back 0), and combines the weighted rows of every
  model rank; the data slices are gathered back, so every rank returns
  the whole [B, S, D] (JAX's ``shard_map`` body, run by every rank on its
  slice).

  Two choices differ from JAX's body and make the expert-parallel output
  the local path's bits on any number of ranks (JAX's differ from its
  local path by rounding): each rank's ``[capacity, D]`` buffer rows are
  all-gathered over ``model`` with their (token, slot) pair index and
  router weight and put in place in a float32 ``[n k, D]`` (one rank
  holds each pair: no sum), and a token's k outputs are then summed in
  slot order, as ``_moe_local`` sums them (JAX scatter-adds into
  ``[n, D]`` and psums partial sums in x's dtype: another order); and the
  routed sum stays float32 until the shared experts are added (JAX's body
  returns x's dtype, a second bf16 rounding).  A rank receives
  ``n_ranks x capacity`` rows of the buffer's dtype (about 2 n k at the
  2x capacity; n k on 2 ranks) where JAX's all-reduce moves about 2 n
  rows.  No sum depends on the backend or on atomics.

Nothing here reads a device value on the host: the group sizes are counted
with ``scatter_add_`` into a fixed ``[E]`` tensor and read by the kernel on
the device, so a decode step through this layer can be captured as a CUDA
graph and the overlapped loop never waits on it.  Every op is row-wise
(the router's float32 product in fixed 8-row blocks, a stable sort for
top-k, the grouped GEMM whose row bits do not depend on its group), so a
token's output does not depend on the other tokens of the batch.

Expert padding: a routed-expert count that does not divide by 16 (qwen2's
60) is padded to the next multiple, the padded experts' router logits
pinned to -1e30, so the router never selects them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (batch_pspec, gather_shard,
                                              local_shard)
from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
from repro_torch.models.layers import (ffn, fixed_row_matmul, init_ffn,
                                       init_linear)


CAPACITY_FACTOR = 2.0


def padded_experts(cfg: ModelConfig, divisor: int = 16) -> int:
    return -(-cfg.n_experts // divisor) * divisor


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> dict:
    """The JAX distributions: a float32 router ``{"w": [D, E]}``, routed
    stacks ``up`` / ``gate`` ``[E, D, F]`` (normal / sqrt(D)) and ``down``
    ``[E, F, D]`` (normal / sqrt(F)), and the shared experts as one FFN of
    ``n_shared_experts * moe_d_ff`` without bias."""
    e = padded_experts(cfg)
    dff = cfg.moe_d_ff

    def w(shape, s):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * s).to(dtype)

    p = {
        "router": init_linear(gen, cfg.d_model, e, False, torch.float32,
                              device),
        "up": w((e, cfg.d_model, dff), cfg.d_model ** -0.5),
        "down": w((e, dff, cfg.d_model), dff ** -0.5),
    }
    if cfg.gated_ffn:
        p["gate"] = w((e, cfg.d_model, dff), cfg.d_model ** -0.5)
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, dataclasses.replace(cfg, use_bias=False),
                               dff * cfg.n_shared_experts, dtype, device)
    return p


def _route(params: dict, xt: torch.Tensor, cfg: ModelConfig, e: int):
    """(top-k expert ids [n, k], their softmax probabilities [n, k]).

    ``lax.top_k`` puts the lower index first among equal logits; a stable
    descending sort does the same (``torch.topk`` promises no order)."""
    logits = fixed_row_matmul(xt.float(), params["router"]["w"].float())
    if e > cfg.n_experts:
        pad = torch.arange(e, device=xt.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    topw, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    return topi, torch.softmax(topw, dim=-1)


def _expert_gemm(params: dict, xs: torch.Tensor, group_sizes: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    h_up = grouped_gemm(xs, params["up"].to(xs.dtype), group_sizes)
    if cfg.gated_ffn:
        h_g = grouped_gemm(xs, params["gate"].to(xs.dtype), group_sizes)
        h = F.silu(h_g.float()).to(xs.dtype) * h_up
    else:
        h = F.gelu(h_up.float(), approximate="tanh").to(xs.dtype)
    return grouped_gemm(h, params["down"].to(xs.dtype), group_sizes)


def _shared_ffn(params: dict, xt: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The shared experts: JAX's formulas are ``layers.ffn``'s (W8A8 or
    W4A16 linears where quantized)."""
    return ffn(params["shared"], xt, cfg.gated_ffn)


class _PairRows(torch.autograd.Function):
    """``xt[order // k]``: the token row of each (token, slot) pair, in
    expert order.  Its gradient sums a token's k pair rows in slot order
    (through ``inv``, the pairs' places in that order).  The backward of
    ``index_select`` would add the duplicates with atomics on CUDA, in no
    fixed order; this one gives the same bits on a second backward pass
    and under remat."""

    @staticmethod
    def forward(ctx, xt, order, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xt.index_select(0, torch.div(order, k, rounding_mode="floor"))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        rows = g.index_select(0, inv).reshape(-1, ctx.k, g.shape[-1])
        dx = rows[:, 0]
        for j in range(1, ctx.k):
            dx = dx + rows[:, j]
        return dx, None, None, None


def _moe_local(params: dict, xt: torch.Tensor, cfg: ModelConfig,
               e: int) -> torch.Tensor:
    """float32 [n, D]: each token's k expert outputs weighted by their
    probabilities, summed over k in order."""
    n, d = xt.shape
    k = cfg.top_k
    topi, probs = _route(params, xt, cfg, e)
    flat = topi.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n * k, device=xt.device))
    # jnp.repeat(xt, k, axis=0)[order] without the copy: pair p is token p // k
    xs = _PairRows.apply(xt, order, inv, k)
    group_sizes = torch.zeros((e,), dtype=torch.int32, device=xt.device)
    group_sizes.scatter_add_(0, flat, torch.ones_like(flat,
                                                      dtype=torch.int32))
    ye = _expert_gemm(params, xs.contiguous(), group_sizes, cfg)
    ye = ye.index_select(0, inv).reshape(n, k, d).float()
    y = ye[:, 0] * probs[:, :1]
    for j in range(1, k):
        y = y + ye[:, j] * probs[:, j:j + 1]
    return y


def _moe_expert_parallel(params: dict, xt: torch.Tensor, cfg: ModelConfig,
                         e: int, mesh) -> torch.Tensor:
    """float32 [n, D] on one (data, model) rank: xt this rank's tokens
    [n, D]; the expert stacks this rank's slices [e_loc, ...]."""
    n, d = xt.shape
    k = cfg.top_k
    e_loc = params["up"].shape[0]
    n_shards = e // e_loc
    e0 = mesh.axis_index("model") * e_loc
    topi, probs = _route(params, xt, cfg, e)   # the router is replicated
    flat = topi.reshape(-1)                    # [n k] global expert ids
    local_e = flat - e0
    mine = (local_e >= 0) & (local_e < e_loc)
    sort_key = torch.where(mine, local_e, e_loc)   # dump bucket sorts last
    # 2x balanced load, floored at 64 so small/imbalanced batches (decode,
    # randomly-initialized routers) never drop; capped at n k (zero drops)
    capacity = max(int(-(-n * k * CAPACITY_FACTOR // n_shards)), 64)
    capacity = min(capacity, n * k)
    order = torch.sort(sort_key, stable=True).indices[:capacity]
    key_sel = sort_key.index_select(0, order)
    token_idx = torch.div(order, k, rounding_mode="floor")
    xs = xt.index_select(0, token_idx)
    group_sizes = torch.zeros((e_loc + 1,), dtype=torch.int32,
                              device=xt.device)
    group_sizes.scatter_add_(0, key_sel, torch.ones_like(key_sel,
                                                         dtype=torch.int32))
    ye = _expert_gemm(params, xs.contiguous(), group_sizes[:e_loc], cfg)
    # each (token, slot) pair's row is held by one rank: every rank's
    # buffer rows are gathered with their pair index and weight and put
    # in place, the dump rows (past the groups' sum) sent to a spare row
    # past the pairs, as JAX's mask drops them; then the slots in order,
    # as ``_moe_local`` sums them: the local path's bits on any number of
    # ranks
    dest = torch.where(key_sel < e_loc, order, n * k)
    w = probs.reshape(-1).index_select(0, order)
    meta = mesh.all_gather(torch.stack([dest.double(), w.double()], 1),
                           "model").reshape(-1, 2)
    rows = mesh.all_gather(ye, "model").reshape(-1, d)
    pairs = torch.zeros((n * k + 1, d), dtype=torch.float32,
                        device=xt.device)
    pairs.index_copy_(0, meta[:, 0].long(),
                      rows.float() * meta[:, 1:].float())
    pairs = pairs[:n * k].reshape(n, k, d)
    y = pairs[:, 0]
    for j in range(1, k):
        y = y + pairs[:, j]
    return y


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] in x's dtype (expert-parallel under a
    mesh: the expert stacks are this rank's slices)."""
    b, s, d = x.shape
    mesh = ctx.mesh()
    xt = x.reshape(-1, d)
    if mesh is not None and "model" in mesh.shape:
        e = params["up"].shape[0] * mesh.shape["model"]
        spec = batch_pspec(mesh, b, 3)
        xloc = local_shard(x, spec, mesh)
        y = _moe_expert_parallel(params, xloc.reshape(-1, d), cfg, e, mesh)
        y = gather_shard(y.reshape(xloc.shape), spec, mesh).reshape(-1, d)
    else:
        y = _moe_local(params, xt, cfg, params["up"].shape[0])
    if "shared" in params:
        y = y + _shared_ffn(params, xt, cfg).float()
    return y.to(x.dtype).reshape(b, s, d)
