"""Mixture-of-Experts layer: top-k routing and the grouped GEMM over the
routed experts, plus the shared experts.

Counterpart of ``repro.models.moe``'s local path (no mesh): the (token,
slot) pairs are sorted by expert and go through one grouped GEMM per
stacked weight (``jax.lax.ragged_dot`` in JAX; the hand-written
``kernels/grouped_gemm`` kernel on CUDA), formula for formula.  The
expert-parallel ``shard_map`` path is not ported (the port has no mesh).

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
from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
from repro_torch.models.layers import (ffn, fixed_row_matmul, init_ffn,
                                       init_linear)


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
    xs = xt.index_select(0, torch.div(order, k, rounding_mode="floor"))
    group_sizes = torch.zeros((e,), dtype=torch.int32, device=xt.device)
    group_sizes.scatter_add_(0, flat, torch.ones_like(flat,
                                                      dtype=torch.int32))
    ye = _expert_gemm(params, xs.contiguous(), group_sizes, cfg)
    ye = ye.index_select(0, inv).reshape(n, k, d).float()
    y = ye[:, 0] * probs[:, :1]
    for j in range(1, k):
        y = y + ye[:, j] * probs[:, j:j + 1]
    return y


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] in x's dtype."""
    b, s, d = x.shape
    e = params["up"].shape[0]
    xt = x.reshape(-1, d)
    y = _moe_local(params, xt, cfg, e)
    if "shared" in params:
        y = y + _shared_ffn(params, xt, cfg).float()
    return y.to(x.dtype).reshape(b, s, d)
