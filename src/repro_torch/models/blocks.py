"""GQA attention block shared by the transformer families (dense subset).

Counterpart of ``repro.models.blocks``.  Where the JAX model runs the jnp
twins of its Pallas kernels, this module calls the kernel wrappers: on a
CUDA tensor they launch the Hopper kernels (B3 flash attention for prefill,
B1 paged decode attention), on a CPU tensor their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.attention import write_paged_rows
from repro_torch.models.layers import (apply_rope, init_linear, layer_norm,
                                       linear, rms_norm)


def norm(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "ln":
        return layer_norm(x, params["g"], params["b"], cfg.norm_eps)
    return rms_norm(x, params["g"], cfg.norm_eps)


def init_norm(cfg: ModelConfig, dtype: torch.dtype,
              device: torch.device) -> dict:
    p = {"g": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "ln":
        p["b"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              device: torch.device) -> dict:
    qd = cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    return {
        "q": init_linear(gen, cfg.d_model, qd, cfg.use_bias, dtype, device),
        "k": init_linear(gen, cfg.d_model, kvd, cfg.use_bias, dtype, device),
        "v": init_linear(gen, cfg.d_model, kvd, cfg.use_bias, dtype, device),
        "o": init_linear(gen, qd, cfg.d_model, False, dtype, device),
    }


def _rope_qk(cfg: ModelConfig, q, k, positions):
    if cfg.rope_mode == "standard":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    elif cfg.rope_mode == "mrope":
        raise NotImplementedError("M-RoPE (vlm family) is not ported yet")
    return q, k


def attn_full(params: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal full-sequence attention (the B3 flash attention kernel).
    Returns (out, k, v) so callers can build the cache."""
    b, s, _ = x.shape
    q = linear(params["q"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = linear(params["k"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = linear(params["v"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q, k = _rope_qk(cfg, q, k, positions)
    out = flash_attention(q, k, v)
    out = linear(params["o"], out.reshape(b, s, -1))
    return out, k, v


def attn_decode_paged(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      block_table: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
    """One-token attention against a paged per-slot cache.

    x: [B, D]; k/v_pages: [P, page, Hkv, Dh] (one layer's pools, written IN
    PLACE); block_table: [B, pages_per_slot] int32; lengths: [B] int32
    per-slot valid lengths (the new token's write position); active: [B]
    bool.  Returns out [B, D].  The attend is the B1 paged decode kernel.
    """
    b = x.shape[0]
    q = linear(params["q"], x).reshape(b, 1, cfg.n_heads, cfg.d_head)
    k = linear(params["k"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = linear(params["v"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    q, k = _rope_qk(cfg, q, k, lengths.reshape(b, 1))
    write_paged_rows(k_pages, k[:, 0], block_table, lengths, active)
    write_paged_rows(v_pages, v[:, 0], block_table, lengths, active)
    out = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 block_table,
                                 (lengths + active.to(torch.int32)).contiguous())
    return linear(params["o"], out.reshape(b, -1))
