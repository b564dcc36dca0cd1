"""Plain PyTorch oracle for the causal prefill flash attention kernel: the
model's own ``chunked_attention`` in its causal form, as ``attn_full``
calls it."""

from __future__ import annotations

import torch

from repro_torch.models.attention import chunked_attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, S, Hkv, D] -> [B, S, H, D], causal."""
    return chunked_attention(q, k, v, causal=True)
