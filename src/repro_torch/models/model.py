"""Functional model API of the port: init / prefill / decode, dense family.

Counterpart of ``repro.models.model`` for the paged serving path:

    init_params(cfg, seed, max_seq, device, dtype)           -> params
    forward(params, cfg, tokens)                    -> logits [B, S, V]
    init_paged_cache(cfg, slots, max_seq, dtype, page_size, num_pages,
                     device)                                 -> cache
    prefill_into_slots(params, cfg, tokens, true_lens, cache, slot_ids)
                                             -> (last_logits [M, V], cache)
    decode_step_paged(params, cfg, token, cache, active)
                                             -> (logits [B, V], cache)

Params are plain dicts of tensors with the JAX package's key names; the
layer stack is a list of per-layer dicts (``params["layers"][i]``) where the
JAX package stacks them on a leading axis.  The paged cache holds the page
pools ``k``/``v`` ``[L, P, page, Hkv, Dh]``, the per-slot lengths ``lens``
and, passed in by the caller, the block table ``block``.

Where the JAX functions return a new cache, these write the page pools IN
PLACE and return a shallow copy of the cache dict with a new ``lens``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.layers import (_w4a16_matmul, dense_weight, ffn,
                                       init_ffn, init_linear)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.parallel_block:
        raise NotImplementedError(
            f"{cfg.name}: only the sequential dense family is ported")


def _init_dense_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "attn_norm": blocks.init_norm(cfg, dtype, device),
        "attn": blocks.init_attn(gen, cfg, dtype, device),
        "ffn_norm": blocks.init_norm(cfg, dtype, device),
        "ffn": init_ffn(gen, cfg, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, max_seq: int = 4096,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights (bf16 by default) with the JAX package's
    distributions (normal * 0.02 embeddings, normal / sqrt(d_in) linears,
    unit norms), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``.  The bits differ from ``jax.random``'s; parity tests carry
    JAX weights over with ``repro_torch.bridge`` instead."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: dict = {}
    p["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              dtype=torch.float32, device=dev) * 0.02).to(dtype)
    p["final_norm"] = blocks.init_norm(cfg, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, False,
                                   dtype, dev)
    p["layers"] = [_init_dense_layer(gen, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)]
    if cfg.rope_mode == "learned":
        p["pos_embed"] = (torch.randn((max_seq, cfg.d_model), generator=gen,
                                      dtype=torch.float32, device=dev)
                          * 0.02).to(dtype)
    return p


def lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits.  A W4A16 head goes through the B4 kernel on CUDA
    (the product of float32 x with the dequantized weights, which the JAX
    package materializes first); a float or W8A8 head is dequantized to
    float32, as the JAX package does, and multiplied outside any kernel."""
    if cfg.tie_embeddings:
        return x.float() @ params["embed"].float().T
    head = params["lm_head"]
    if "w_p4" in head:
        return _w4a16_matmul(head["w_p4"], head["scale4"], x.float())
    return x.float() @ dense_weight(head).float()


# ---------------------------------------------------------------------------
# full-sequence layer application (prefill): returns the layer's K/V
# ---------------------------------------------------------------------------


def _dense_layer_full(lp, x, cfg: ModelConfig, positions):
    h = blocks.norm(cfg, lp["attn_norm"], x)
    attn_out, k, v = blocks.attn_full(lp["attn"], h, cfg, positions)
    x = x + attn_out
    x = x + ffn(lp["ffn"], blocks.norm(cfg, lp["ffn_norm"], x), cfg.gated_ffn)
    return x, (k, v)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.rope_mode == "learned":
        x = x + params["pos_embed"][:x.shape[1]][None]
    return x


def forward(params: dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced full-sequence logits f32 [B, S, V] (the dense branch
    of the JAX ``forward``): every position attends causally to its
    prefix through the B3 kernel on CUDA."""
    _check_family(cfg)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for lp in params["layers"]:
        x, _ = _dense_layer_full(lp, x, cfg, positions)
    x = blocks.norm(cfg, params["final_norm"], x)
    return lm_head(params, cfg, x)


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def supports_paged(cfg: ModelConfig) -> bool:
    """The port pages the dense family's K/V; other families come later."""
    return cfg.family == "dense"


def init_paged_cache(cfg: ModelConfig, num_slots: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16, page_size: int = 16,
                     num_pages: int | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """Block-table KV cache: a shared page pool + per-slot lengths.

      k/v   [L, P, page, Hkv, Dh]   page pools (page 0 is the null page)
      lens  [slots] int32           per-slot valid lengths

    The block table ``[slots, pages_per_slot]`` int32 is kept by the caller
    and passed in as ``cache["block"]``; ``paged_slot_capacity`` is
    ``pages_per_slot * page``.  By default P fits every slot at max_seq.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    pages_per_slot = -(-max_seq // page_size)
    if num_pages is None:
        num_pages = num_slots * pages_per_slot + 1
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "lens": torch.zeros((num_slots,), dtype=torch.int32, device=dev)}


def paged_slot_capacity(cache: dict) -> int:
    """Max tokens one slot can hold (pages_per_slot * page_size)."""
    return cache["block"].shape[1] * cache["k"].shape[2]


def prefill_into_slots(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       true_lens: torch.Tensor, cache: dict,
                       slot_ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Prefill M requests into M slots of a paged cache, in one pass.

    tokens: [M, Sp] right-padded to a common bucket length; true_lens: [M]
    int32 valid lengths; slot_ids: [M].  Only the named slots' pages
    (already in their block-table rows) are written.  Returns (per-request
    last-valid-position logits [M, V], cache).

    Right-padding keeps every row's positions 0-based; causality keeps the
    pads out of every valid position's attention, and pad K/V land in the
    row's own pages (or the null page past its allocation), masked by
    ``lens``.  A row repeated to pad the group writes identical values.
    """
    _check_family(cfg)
    x = _embed(params, cfg, tokens)
    m, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(m, s)
    true_lens = true_lens.to(device=x.device, dtype=torch.int32)
    slot_ids = slot_ids.to(device=x.device).long()
    page = cache["k"].shape[2]
    n_pages = -(-s // page)
    pids = cache["block"][slot_ids][:, :n_pages].long()   # [M, n_pages]

    def to_pages(arr: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
        # [M, S, Hkv, Dh] -> [M, n_pages, page, Hkv, Dh] in the pool's dtype
        pad = n_pages * page - s
        if pad:
            arr = torch.nn.functional.pad(arr, (0, 0, 0, 0, 0, pad))
        return arr.reshape(m, n_pages, page, *arr.shape[2:]).to(pool.dtype)

    for li, lp in enumerate(params["layers"]):
        x, (k, v) = _dense_layer_full(lp, x, cfg, positions)
        cache["k"][li][pids] = to_pages(k, cache["k"])
        cache["v"][li][pids] = to_pages(v, cache["v"])
    lens = cache["lens"].clone()
    lens[slot_ids] = true_lens
    x_last = x[torch.arange(m, device=x.device), true_lens.long() - 1]
    x_last = blocks.norm(cfg, params["final_norm"], x_last)
    return lm_head(params, cfg, x_last), {**cache, "lens": lens}


def decode_step_paged(params: dict, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict, active: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """One decode step over mixed-progress slots of a paged cache.

    token: int [B]; active: bool [B].  Each slot attends its own valid
    prefix (``cache["lens"]``) through its block-table row; inactive slots
    write to the null page and keep their length, so their lanes are pure
    padding.  Returns (logits [B, V], cache); logits of inactive slots are
    garbage and must be ignored by the caller.
    """
    _check_family(cfg)
    x = params["embed"][token.long()]
    lens = cache["lens"]
    # a slot at capacity must not decode: its page write would clamp onto
    # its own last page, so its lane is deactivated instead
    active = active.to(torch.bool) & (lens < paged_slot_capacity(cache))
    if cfg.rope_mode == "learned":
        x = x + params["pos_embed"][lens.long()]
    block = cache["block"]
    for li, lp in enumerate(params["layers"]):
        hn = blocks.norm(cfg, lp["attn_norm"], x)
        attn_out = blocks.attn_decode_paged(
            lp["attn"], hn, cfg, cache["k"][li], cache["v"][li], block, lens,
            active)
        x = x + attn_out
        x = x + ffn(lp["ffn"], blocks.norm(cfg, lp["ffn_norm"], x),
                    cfg.gated_ffn)
    cache = {**cache, "lens": lens + active.to(torch.int32)}
    x = blocks.norm(cfg, params["final_norm"], x)
    return lm_head(params, cfg, x), cache
