"""Token samplers.  Only greedy is ported: seed-pinned stochastic sampling
must reproduce JAX's threefry keys (``fold_in(PRNGKey(seed), i)``) to stay
comparable with the reference, which is a later slice."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis (the first maximum on ties, as
    ``jnp.argmax``), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
