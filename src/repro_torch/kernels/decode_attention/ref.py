"""Oracles: models/attention holds the plain PyTorch references."""

from repro_torch.models.attention import (  # noqa: F401
    decode_attention as decode_attention_ref,
    paged_decode_attention as paged_decode_attention_ref,
)
