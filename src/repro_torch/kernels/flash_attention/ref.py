"""Plain PyTorch oracle for the prefill flash attention kernel: the
model's own ``chunked_attention``, causal or bidirectional, as ``attn_full``
calls it."""

from __future__ import annotations

import torch

from repro_torch.models.attention import chunked_attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, Skv, Hkv, D] -> [B, S, H, D].  Causal:
    Skv == S.  Bidirectional: any Skv (cross-attention); the keys are
    sliced into chunks, not padded, so no key past Skv enters."""
    return chunked_attention(q, k, v, causal=causal)
