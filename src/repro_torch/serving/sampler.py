"""Token samplers (greedy / temperature / top-k / top-p), the counterpart
of ``repro.serving.sampler``.

``greedy`` and ``sample`` apply one global setting to the whole batch;
``sample_batch`` is the serving path: it honors per-request
``SamplingParams`` (temperature / top-k / top-p / seed) row by row in one
vectorized call, so mixed greedy and stochastic slots share one decode
step.  The keys are jax's threefry keys (``serving.threefry``), so a
seed-pinned request draws the same tokens as in the JAX engine wherever
the two frameworks' logits and float32 roundings agree.
"""

from __future__ import annotations

import torch

from repro_torch.serving import threefry

NEG_INF = -1e30


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis (the first maximum on ties, as
    ``jnp.argmax``), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_batch(logits: torch.Tensor, seeds: torch.Tensor,
                 counts: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling honoring per-request ``SamplingParams``.

    logits: [B, V]; seeds / counts: int32 [B]; temperature: f32 [B] (<= 0
    is greedy); top_k: int32 [B] (0 = disabled); top_p: f32 [B] (1.0 =
    disabled).  The key of row b is ``fold_in(PRNGKey(seeds[b]),
    counts[b])``, deterministic per (request seed, output index), so a
    preempted request restarted with its prefix folded into its prompt
    draws the same continuation.  No host sync: the function can be
    captured in a CUDA graph.
    """
    b, v = logits.shape
    greedy_tok = greedy(logits)
    lg = logits.float() / torch.clamp_min(temperature.float(), 1e-6)[:, None]
    # stable, as jnp.argsort: among ties the lower vocab id ranks first
    order = torch.argsort(-lg, dim=-1, stable=True)
    # rank of each vocab id (0 = best): the sort permutation inverted by a
    # scatter, as the JAX code does with .at[].set
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(v, device=lg.device).expand(b, v))
    keff = torch.where(top_k > 0, top_k, v).to(order.dtype)[:, None]
    lg = torch.where(ranks < keff, lg, NEG_INF)
    sorted_lg = torch.gather(lg, 1, order)
    cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p.float()[:, None]).sum(-1, keepdim=True)
    # where every cumulative sum stays below top_p the index is V, past
    # the end: jnp.take_along_axis fills NaN there, and lg < NaN is
    # false, so nothing is cut
    cutoff = torch.gather(sorted_lg, 1, cutoff_idx.clamp_max(v - 1))
    cut = (lg < cutoff) & (cutoff_idx < v)
    lg = torch.where(cut, NEG_INF, lg)
    keys = threefry.fold_in(threefry.PRNGKey(seeds), counts)
    sampled = threefry.categorical(keys, lg).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy_tok)


def fused_sample(logits: torch.Tensor, seeds: torch.Tensor,
                 counts: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 greedy_only: bool = False) -> torch.Tensor:
    """``sample_batch`` shaped for the fused decode step.

    ``greedy_only`` is static (the engine knows on the host whether any
    row is stochastic): an all-greedy batch takes a bare argmax instead of
    the sort / top-k / top-p work.  Greedy rows of a mixed batch still
    take the argmax inside ``sample_batch``, so both agree bit for bit on
    greedy rows.
    """
    if greedy_only:
        return greedy(logits)
    return sample_batch(logits, seeds, counts, temperature, top_k, top_p)


def sample(logits: torch.Tensor, key: torch.Tensor, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int32) under one global setting and one
    threefry key [2] for the whole batch."""
    if temperature <= 0.0:
        return greedy(logits)
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
        v = logits.shape[-1]
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx.clamp_max(v - 1))
        cut = (logits < cutoff) & (cutoff_idx < v)
        logits = torch.where(cut, NEG_INF, logits)
    return threefry.categorical(key, logits).to(torch.int32)
