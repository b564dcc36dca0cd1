"""Functional model API of the port: init / forward, the wave engine's
shared-cursor prefill and decode, and the paged prefill and decode, for the
dense, vlm, moe, mla_moe, hybrid, ssm and audio families.

Counterpart of ``repro.models.model``:

    init_params(cfg, seed, max_seq, device, dtype, finish)   -> params
    forward(params, cfg, tokens, extras)            -> logits [B, S, V]
    init_cache(cfg, batch, max_seq, dtype, device)           -> cache
    prefill(params, cfg, tokens, cache, extras)  -> (last_logits [B, V], cache)
    decode_step(params, cfg, token, cache)          -> (logits [B, V], cache)
    decode_and_sample(params, cfg, tok_host, tok_dev, use_dev, cache,
                      sample_fn)                      -> (tokens [B], cache)
    init_paged_cache(cfg, slots, max_seq, dtype, page_size, num_pages,
                     device, kv_dtype)                       -> cache
    prefill_into_slots(params, cfg, tokens, true_lens, cache, slot_ids,
                       extras)               -> (last_logits [M, V], cache)
    prefill_chunk_into_slot(params, cfg, tokens, start, chunk_len, cache,
                            slot)                  -> (logits [V], cache)
    decode_step_paged(params, cfg, token, cache, active)
                                             -> (logits [B, V], cache)
    decode_and_sample_paged(params, cfg, tok_host, tok_dev, use_dev, cache,
                            active, sample_fn)  -> (tokens [B], cache)
    swap_out_pages(cache, page_ids) / swap_in_pages(cache, page_ids, *pay)
    checkpoint_slot_state(cache, slot) / restore_slot_state(cache, slot, ck)

Params are plain dicts of tensors with the JAX package's key names; where
the JAX package stacks layers on a leading axis the port keeps lists:
``params["layers"][i]`` (dense, vlm, moe, mla_moe's MoE layers, ssm, audio's
decoder; a moe layer's routed stacks ``moe["up"]`` etc. are its ``[E, in,
out]`` slice), ``params["dense_layers"][i]`` (mla_moe's first
``first_k_dense`` layers, a dense FFN each), ``params["enc_layers"][i]``
(audio's encoder), ``params["groups"][g][i]`` and
``params["tail"][i]`` (hybrid, zamba2's Mamba layers; ``tail`` is None when
the layer count divides), beside ``params["shared"]``, the one dense block
every group applies.

The wave cache (``init_cache``, JAX's legacy cache) keeps one shared length
cursor ``len`` (an int32 [] tensor on the device) for all B rows: K/V
``[L, B, Smax, Hkv, Dh]`` (dense, vlm, moe; hybrid one layer per group;
audio's decoder self-attention, beside its cross-attention rows ``xk``/``xv``
``[L, B, encoder_seq, Hkv, Dh]``) or MLA's compressed rows ``ckv`` /
``krope`` ``[L, B, Smax, R]`` / ``[L, B, Smax, Dr]``, the hybrid family's
Mamba state
``mamba`` / ``tail`` and the ssm family's ``layers`` (``conv`` ``[..., B,
K-1, C]``, ``state`` ``[..., B, H, P, N]`` float32).  ``prefill`` takes a
left-padded batch (the engine pads to the wave's longest prompt) and
writes every row; ``decode_step`` writes each row's K/V at ``len``.

The paged cache holds the page pools ``k``/``v``
``[L, P, page, Hkv, Dh]`` (hybrid: one layer per group; mla_moe pages its
compressed rows, ``ckv`` / ``krope`` ``[L, P, page, R]`` / ``[L, P, page,
Dr]``, dense layers first), the per-slot
lengths ``lens``, for the hybrid family the Mamba state pools ``mamba``
(``conv`` ``[G, every, slots, K-1, C]``, ``state`` ``[G, every, slots, H, P,
N]``) and ``tail`` (``[T, slots, ...]`` or None), and, passed in by the
caller, the block table ``block``.  Under ``kv_dtype="int8"`` the pools
are int8 with float32 scale pools ``k_scale`` / ``v_scale`` (``ckv_scale``
/ ``krope_scale``; the pool shapes less their last axis); rows quantize at
their write.

Where the JAX functions return a new cache, these write the page, K/V and
state tensors IN PLACE and return a shallow copy of the cache dict with a
new ``lens`` (paged) or ``len`` (wave); a conv window whose dtype the JAX
function would change (jnp's promotion, C3) is rebound to a new tensor of
that dtype instead.  The ssm and audio families have no paged path (they
serve in wave mode, as in JAX).

A parallel-block dense model (``cfg.parallel_block``, command-r-plus-104b)
gives its attention and its FFN the same normed input, ``x + attn(hn) +
ffn(hn)``, in every path, as the JAX package's four branches do; its
``ffn_norm`` is drawn and kept, unused, as JAX keeps it.

The vlm family prepends ``extras["vision_embeds"]`` [B, n_vision, D] (the
stub vision frontend's patch embeddings) to the token embeddings and
rotates q/k by M-RoPE (``layers.apply_mrope``): its caches hold the vision
rows first, so a slot's length counts them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import ctx as dist_ctx
from repro_torch.distributed.sharding import batch_pspec
from repro_torch.models import blocks
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import quantize_rows
from repro_torch.models.layers import (_w4a16_matmul, ffn,
                                       fixed_row_apply, fixed_row_matmul,
                                       init_ffn, init_linear, linear,
                                       mrope_positions)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


# init_params, forward and the wave cache's prefill / decode
MODEL_FAMILIES = ("dense", "vlm", "moe", "mla_moe", "hybrid", "ssm", "audio")
PAGED_FAMILIES = ("dense", "vlm", "moe", "mla_moe", "hybrid")  # the paged path
# param subtrees the JAX package stacks on leading layer axes, which the
# port keeps as (nested) lists -> the number of those axes
STACKED = {"layers": 1, "dense_layers": 1, "enc_layers": 1, "groups": 2,
           "tail": 1}


def _check_family(cfg: ModelConfig, families: tuple[str, ...]) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported for this "
            f"function (ported: {', '.join(families)})")


def _init_dense_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "attn_norm": blocks.init_norm(cfg, dtype, device),
        "attn": blocks.init_attn(gen, cfg, dtype, device),
        "ffn_norm": blocks.init_norm(cfg, dtype, device),
        "ffn": init_ffn(gen, cfg, cfg.d_ff, dtype, device),
    }


def _init_moe_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "attn_norm": blocks.init_norm(cfg, dtype, device),
        "attn": blocks.init_attn(gen, cfg, dtype, device),
        "ffn_norm": blocks.init_norm(cfg, dtype, device),
        "moe": moe_mod.init_moe(gen, cfg, dtype, device),
    }


def _init_mla_layer(gen, cfg: ModelConfig, dtype, device,
                    dense_ffn: bool) -> dict:
    p = {
        "attn_norm": blocks.init_norm(cfg, dtype, device),
        "attn": blocks.init_mla(gen, cfg, dtype, device),
        "ffn_norm": blocks.init_norm(cfg, dtype, device),
    }
    if dense_ffn:
        p["ffn"] = init_ffn(gen, cfg, cfg.dense_d_ff, dtype, device)
    else:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
    return p


def _init_audio_dec_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "attn_norm": blocks.init_norm(cfg, dtype, device),
        "attn": blocks.init_attn(gen, cfg, dtype, device),
        "xattn_norm": blocks.init_norm(cfg, dtype, device),
        "xattn": blocks.init_attn(gen, cfg, dtype, device),
        "ffn_norm": blocks.init_norm(cfg, dtype, device),
        "ffn": init_ffn(gen, cfg, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, max_seq: int = 4096,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.bfloat16, finish=None) -> dict:
    """Random weights (bf16 by default) with the JAX package's
    distributions (normal * 0.02 embeddings, normal / sqrt(d_in) linears,
    unit norms), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``.  The bits differ from ``jax.random``'s; parity tests carry
    JAX weights over with ``repro_torch.bridge`` instead.

    ``finish(subtree, stacked)``, when given, receives each top-level
    entry and each layer as soon as it is made (``stacked``: the layer sits
    under a ``STACKED`` key) and returns what the params keep.
    ``serving.fleet.worker.build_params`` quantizes there, so no more than
    one layer's float weights are alive at a time; the draws and their
    order do not depend on it."""
    _check_family(cfg, MODEL_FAMILIES)
    dev = resolve_device(device)
    # the meta device has no generator; its draws are shapes only
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    fin = finish or (lambda tree, stacked: tree)

    def stack(make, n: int) -> list:
        return [fin(make(gen, cfg, dtype, dev), True) for _ in range(n)]

    def normal(rows: int) -> torch.Tensor:
        # scaled in place: one float32 copy alive (12.6 GB for
        # command-r-plus-104b's 256,000 x 12,288 embedding), the same bits
        return torch.randn((rows, cfg.d_model), generator=gen,
                           dtype=torch.float32, device=dev).mul_(0.02).to(
                               dtype)

    p: dict = {}
    p["embed"] = fin(normal(cfg.vocab_size), False)
    p["final_norm"] = fin(blocks.init_norm(cfg, dtype, dev), False)
    if not cfg.tie_embeddings:
        p["lm_head"] = fin(init_linear(gen, cfg.d_model, cfg.vocab_size,
                                       False, dtype, dev), False)
    if cfg.family in ("dense", "vlm"):
        p["layers"] = stack(_init_dense_layer, cfg.n_layers)
    elif cfg.family == "moe":
        p["layers"] = stack(_init_moe_layer, cfg.n_layers)
    elif cfg.family == "mla_moe":
        kd = cfg.first_k_dense
        p["dense_layers"] = stack(
            lambda *a: _init_mla_layer(*a, dense_ffn=True), kd)
        p["layers"] = stack(
            lambda *a: _init_mla_layer(*a, dense_ffn=False),
            cfg.n_layers - kd)
    elif cfg.family == "audio":
        p["enc_layers"] = stack(_init_dense_layer, cfg.n_encoder_layers)
        p["layers"] = stack(_init_audio_dec_layer, cfg.n_layers)
        p["enc_pos"] = fin(normal(cfg.encoder_seq), False)
        p["enc_final_norm"] = fin(blocks.init_norm(cfg, dtype, dev), False)
    elif cfg.family == "hybrid":
        n_groups, every, tail = _hybrid_layout(cfg)
        p["groups"] = [stack(ssm_mod.init_mamba_block, every)
                       for _ in range(n_groups)]
        p["tail"] = stack(ssm_mod.init_mamba_block, tail) if tail else None
        p["shared"] = fin(_init_dense_layer(gen, cfg, dtype, dev), False)
    else:  # ssm
        p["layers"] = stack(ssm_mod.init_mamba_block, cfg.n_layers)
    if cfg.rope_mode == "learned":
        p["pos_embed"] = fin(normal(max_seq), False)
    return p


# vocabulary rows of the float32 head weight made at a time (a 0.54 GB
# block at d_model 8192), so the whole float32 matrix (4.98 GB at
# qwen2-vl-72b) never exists
LM_HEAD_BLOCK = 16384


def _head_block(params: dict, cfg: ModelConfig, v0: int,
                v1: int) -> torch.Tensor:
    """Vocabulary rows v0:v1 of the float or W8A8 head (or the tied
    embedding) as a float32 [d_model, v1 - v0] weight: JAX's dequantized
    head, a block of columns at a time."""
    if cfg.tie_embeddings:
        return params["embed"][v0:v1].float().T
    head = params["lm_head"]
    if "w" in head:
        return head["w"][:, v0:v1].float()
    return head["w_q"][v0:v1].float().mul_(head["scale"][v0:v1, None]).T


def lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits.  A W4A16 head goes through the B4 kernel on CUDA
    (the product of x, read in its own dtype, with the dequantized weights,
    which the JAX package materializes first) in 8-row blocks: B4's GeMV
    gives a row the same bits at 1-8 rows, its tiled GEMM above 8 rows
    other ones (ROADMAP C11).  A float or W8A8 head is dequantized to
    float32, as the JAX package does, and multiplied outside any kernel,
    LM_HEAD_BLOCK vocabulary rows at a time, each block in
    ``fixed_row_matmul``'s 8-row products (a row's bits do not depend on
    the batch)."""
    head = params.get("lm_head")
    if head is not None and "w_p4" in head:
        logits = fixed_row_apply(lambda rows: _w4a16_matmul(
            head["w_p4"], head["scale4"], rows, torch.float32), x)
    else:
        xf = x.float()
        logits = torch.cat(
            [fixed_row_matmul(xf, _head_block(params, cfg, v0, min(
                v0 + LM_HEAD_BLOCK, cfg.vocab_size)))
             for v0 in range(0, cfg.vocab_size, LM_HEAD_BLOCK)], dim=-1)
    return dist_ctx.constrain(logits, kind="logits")


# ---------------------------------------------------------------------------
# full-sequence layer application (prefill): returns the layer's K/V
# ---------------------------------------------------------------------------


def _mlp(lp, h, cfg: ModelConfig) -> torch.Tensor:
    """The layer's FFN on normed h: the dense FFN, or a MoE layer's
    ``moe_ffn`` (the moe family's layers, mla_moe's past its dense ones;
    JAX calls it on ``[B, S, D]`` in prefill and on ``hn2[:, None]`` in
    decode; a decode step's h [B, D] is taken so)."""
    if "moe" not in lp:
        return ffn(lp["ffn"], h, cfg.gated_ffn)
    if h.dim() == 2:
        return moe_mod.moe_ffn(lp["moe"], h[:, None], cfg)[:, 0]
    return moe_mod.moe_ffn(lp["moe"], h, cfg)


def _residual(lp, x, hn, attn_out, cfg: ModelConfig) -> torch.Tensor:
    """A layer's two residual adds after its attention on ``hn``, the
    normed x: the FFN on the normed sum, or, in a parallel block
    (command-r), on ``hn`` itself, ``x + attn_out + ffn(hn)``, summed in
    JAX's order."""
    if cfg.parallel_block:
        return x + attn_out + _mlp(lp, hn, cfg)
    x = x + attn_out
    return x + _mlp(lp, blocks.norm(cfg, lp["ffn_norm"], x), cfg)


def _dense_layer_full(lp, x, cfg: ModelConfig, positions, causal=True):
    """A dense or moe layer over full rows (JAX ``_dense_layer_full`` /
    ``_moe_layer_full``)."""
    h = blocks.norm(cfg, lp["attn_norm"], x)
    attn_out, k, v = blocks.attn_full(lp["attn"], h, cfg, positions, causal)
    return _residual(lp, x, h, attn_out, cfg), (k, v)


def _mla_layer_full(lp, x, cfg: ModelConfig, positions):
    """An mla_moe layer over full rows (JAX ``_mla_layer_full``): returns
    the layer's compressed rows (c_kv [B, S, R], k_rope [B, S, Dr])."""
    h = blocks.norm(cfg, lp["attn_norm"], x)
    attn_out, ckv, krope = blocks.mla_full(lp["attn"], h, cfg, positions)
    x = x + attn_out
    x = x + _mlp(lp, blocks.norm(cfg, lp["ffn_norm"], x), cfg)
    return x, (ckv, krope)


def _mla_stack(params) -> list:
    """mla_moe's layers in order: the dense ones, then the MoE ones; a
    cache's layer axis follows it."""
    return list(params["dense_layers"]) + list(params["layers"])


def _audio_dec_layer_full(lp, x, cfg: ModelConfig, positions, enc_out):
    h = blocks.norm(cfg, lp["attn_norm"], x)
    attn_out, k, v = blocks.attn_full(lp["attn"], h, cfg, positions)
    x = x + attn_out
    h = blocks.norm(cfg, lp["xattn_norm"], x)
    xout, xk, xv = blocks.attn_full(lp["xattn"], h, cfg, positions,
                                    causal=False, kv_override=enc_out)
    x = x + xout
    x = x + ffn(lp["ffn"], blocks.norm(cfg, lp["ffn_norm"], x), cfg.gated_ffn)
    return x, (k, v, xk, xv)


class _EmbedLookup(torch.autograd.Function):
    """``embed[tokens]`` whose gradient is JAX's ``_embed_lookup`` VJP: the
    cotangent scatter-added in float32 into zeros, then cast to the
    embedding's dtype (torch's own backward of an index accumulates in the
    parameter's dtype).  ``index_put_`` with ``accumulate=True`` sums a
    row's repeats in a fixed order (on CUDA it sorts the indices and adds
    each row's run in order, no atomics), so two backward passes give the
    same bits."""

    @staticmethod
    def forward(ctx, embed, tokens):
        ctx.save_for_backward(tokens)
        ctx.embed_shape, ctx.embed_dtype = embed.shape, embed.dtype
        return embed[tokens]

    @staticmethod
    def backward(ctx, ct):
        (tokens,) = ctx.saved_tensors
        ct = dist_ctx.constrain(ct.float())
        g = torch.zeros(ctx.embed_shape, dtype=torch.float32,
                        device=ct.device)
        g.index_put_((tokens.reshape(-1),), ct.reshape(-1, ct.shape[-1]),
                     accumulate=True)
        return dist_ctx.constrain(g, kind="embed").to(ctx.embed_dtype), None


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           extras: dict | None = None) -> torch.Tensor:
    """Token embeddings [B, S, D]; the vlm family's ``vision_embeds``
    [B, n_vision, D] prepended (JAX ``_embed``).  Under autograd the
    lookup's gradient is JAX's (``_EmbedLookup``); a tied head adds its own
    gradient to the same leaf."""
    x = _EmbedLookup.apply(params["embed"], tokens.long())
    if cfg.family == "vlm":
        vis = extras["vision_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([vis, x], dim=1)
    if cfg.rope_mode == "learned":
        x = x + params["pos_embed"][:x.shape[1]][None]
    return x


def _positions(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Rotary positions of x's rows: [B, S], or M-RoPE's [3, B, S]."""
    b, s = x.shape[0], x.shape[1]
    if cfg.rope_mode == "mrope":
        return mrope_positions(b, s, cfg.n_vision_tokens, x.device)
    return torch.arange(s, device=x.device).expand(b, s)


def _encode_audio(params, cfg: ModelConfig,
                  frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B, Senc, D]: learned
    positions, bidirectional self-attention (B3's bidirectional mode on
    CUDA), the encoder's final norm."""
    x = frames + params["enc_pos"][None, :frames.shape[1]]
    pos = _positions(cfg, x)
    enc_cfg = dataclasses.replace(cfg, rope_mode="none")
    step = dist_ctx.maybe_remat(
        lambda h, lp: _dense_layer_full(lp, h, enc_cfg, pos, causal=False)[0])
    for lp in params["enc_layers"]:
        x = dist_ctx.constrain(step(x, lp))
    return blocks.norm(cfg, params["enc_final_norm"], x)


def _mamba_full(lp, x, cfg: ModelConfig, valid=None):
    out, state = ssm_mod.mamba_block(lp, x, cfg, valid=valid)
    return x + out, state


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            extras: dict | None = None) -> torch.Tensor:
    """Teacher-forced full-sequence logits f32 [B, S, V] (the dense, vlm,
    moe, mla_moe, hybrid, ssm and audio branches of the JAX ``forward``):
    attention runs
    through the B3 kernel on CUDA (bidirectional for the whisper encoder
    and the cross-attention), every Mamba layer's intra-chunk term through
    B6.  ``extras["frames"]``: the audio family's frame embeddings;
    ``extras["vision_embeds"]``: the vlm family's, whose rows lead the
    returned logits."""
    _check_family(cfg, MODEL_FAMILIES)
    x = dist_ctx.constrain(_embed(params, cfg, tokens, extras))
    positions = _positions(cfg, x)

    def layers(apply, stack):
        """Each layer of ``stack`` through ``apply(lp, h) -> (h, _)``,
        under ``maybe_remat``, the residual constrained after it (the JAX
        scans' bodies)."""
        h = x
        step = dist_ctx.maybe_remat(lambda h, lp: apply(lp, h)[0])
        for lp in stack:
            h = dist_ctx.constrain(step(h, lp))
        return h

    if cfg.family in ("dense", "vlm", "moe"):
        x = layers(lambda lp, h: _dense_layer_full(lp, h, cfg, positions),
                   params["layers"])
    elif cfg.family == "mla_moe":
        x = layers(lambda lp, h: _mla_layer_full(lp, h, cfg, positions),
                   _mla_stack(params))
    elif cfg.family == "audio":
        enc_out = _encode_audio(params, cfg, extras["frames"])
        x = layers(lambda lp, h: _audio_dec_layer_full(lp, h, cfg, positions,
                                                       enc_out),
                   params["layers"])
    elif cfg.family == "hybrid":
        for gp in params["groups"]:
            for lp in gp:
                x, _ = _mamba_full(lp, x, cfg)
            x, _ = _dense_layer_full(params["shared"], x, cfg, positions)
            x = dist_ctx.constrain(x)
        for lp in params.get("tail") or ():
            x, _ = _mamba_full(lp, x, cfg)
    else:  # ssm
        x = layers(lambda lp, h: _mamba_full(lp, h, cfg), params["layers"])
    x = blocks.norm(cfg, params["final_norm"], x)
    return lm_head(params, cfg, x)


# ---------------------------------------------------------------------------
# the wave cache: one shared length cursor for every row
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """The wave engine's cache (JAX ``init_cache``), zeros:

      k/v    [L, B, Smax, Hkv, Dh]   dense, vlm, moe; hybrid L = n_groups;
                                     audio the decoder's self-attention
      ckv/krope [L, B, Smax, R] / [L, B, Smax, Dr]   mla_moe
      xk/xv  [L, B, encoder_seq, Hkv, Dh]   audio: cross-attention rows
      mamba  {conv [G, every, B, K-1, C], state [G, every, B, H, P, N]},
      tail   the same with [T, B] or None   hybrid
      layers {conv [L, B, K-1, C], state [L, B, H, P, N]}   ssm
      len    int32 []                the shared cursor
    """
    _check_family(cfg, MODEL_FAMILIES)
    dev = resolve_device(device)
    f = cfg.family
    out: dict = {"len": torch.zeros((), dtype=torch.int32, device=dev)}
    if f in ("dense", "vlm", "moe", "audio", "hybrid"):
        n_kv = _hybrid_layout(cfg)[0] if f == "hybrid" else cfg.n_layers
        shape = (n_kv, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        out["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        out["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if f == "mla_moe":
        for key, width in (("ckv", cfg.kv_lora_rank),
                           ("krope", cfg.qk_rope_dim)):
            out[key] = torch.zeros((cfg.n_layers, batch, max_seq, width),
                                   dtype=dtype, device=dev)
    if f == "audio":
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.d_head)
        out["xk"] = torch.zeros(shape, dtype=dtype, device=dev)
        out["xv"] = torch.zeros(shape, dtype=dtype, device=dev)
    if f in ("hybrid", "ssm"):
        one = ssm_mod.init_mamba_cache(cfg, batch, dtype, dev)

        def rep(*dims):
            return {k: torch.zeros((*dims, *v.shape), dtype=v.dtype,
                                   device=dev) for k, v in one.items()}
        if f == "hybrid":
            n_groups, every, tail = _hybrid_layout(cfg)
            out["mamba"] = rep(n_groups, every)
            out["tail"] = rep(tail) if tail else None
        else:
            out["layers"] = rep(cfg.n_layers)
    return out


def state_pools(cache: dict) -> list[dict]:
    """The Mamba state pool dicts of a cache (hybrid ``mamba`` / ``tail``,
    the wave ssm cache's ``layers``)."""
    return [cache[k] for k in ("mamba", "tail", "layers")
            if isinstance(cache.get(k), dict)]


def _promote_conv(cache: dict, dtype: torch.dtype) -> None:
    """A decode step returns each conv window in the promoted dtype of the
    pool and this step's activations (``jnp.concatenate``, C3), so a
    float32 model over a bf16 cache carries float32 conv pools from its
    first decode step on; the pools are rebound to that dtype (a no-op for
    a bf16 model)."""
    for pools in state_pools(cache):
        pools["conv"] = pools["conv"].to(
            torch.promote_types(pools["conv"].dtype, dtype))


def _mamba_step(lp, h, cfg: ModelConfig, pool: dict, active=None):
    """One Mamba layer's decode step; pool: the layer's state views,
    updated in place."""
    out, new = ssm_mod.mamba_decode_step(lp, h, pool, cfg, active=active)
    for k, v in pool.items():
        v.copy_(new[k])
    return h + out


def _conv_tail(h: torch.Tensor, lp, cfg: ModelConfig) -> torch.Tensor:
    """Last K-1 conv inputs of the sequence (pre-activation), for decode."""
    z_xbc_dt = linear(lp["in_proj"], h[:, -(cfg.ssm_conv - 1):, :])
    d_in = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    return z_xbc_dt[..., d_in:d_in + d_in + 2 * g * n]


def _mamba_prefill(lp, h, cfg: ModelConfig, pool: dict) -> torch.Tensor:
    """One Mamba layer over the whole (left-padded) rows, no valid mask, as
    the JAX wave prefill runs it; the final state and the conv tail go
    into the layer's pool views in place."""
    out, state = ssm_mod.mamba_block(lp, h, cfg)
    pool["conv"].copy_(_conv_tail(h, lp, cfg))
    pool["state"].copy_(state)
    return h + out


def _write_kv(cache: dict, li: int, k: torch.Tensor, v: torch.Tensor,
              keys=("k", "v")) -> None:
    """Layer ``li``'s K/V [B, S, Hkv, Dh] (or MLA's [B, S, R] / [B, S, Dr])
    at rows 0..S-1 of every batch row, the rows after them zeroed (JAX pads
    the prefill's K/V to Smax)."""
    s = k.shape[1]
    for name, arr in zip(keys, (k, v)):
        pool = cache[name][li]
        pool[:, :s].copy_(arr)
        pool[:, s:].zero_()


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, extras: dict | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Process a batch of prompts, left-padded to one length S (the JAX
    wave prefill, which attends the pads: the engine reproduces that).
    Writes every row of the cache in place (K/V rows past S zeroed; the
    audio family's cross-attention rows; the Mamba conv tails and final
    states) and returns (last-position logits [B, V], a shallow copy of the
    cache with ``len`` = S).  A conv pool in another dtype than the
    activations is rebound to theirs, as the JAX cache takes the prefill's
    conv tails as they are.  ``extras["frames"]``: the audio family's
    frame embeddings [B, encoder_seq, D]; ``extras["vision_embeds"]``: the
    vlm family's [B, n_vision, D], prepended (``len`` = n_vision + S).

    Raises ValueError for an ssm / hybrid batch shorter than the conv
    window (``ssm_conv - 1``): its decode conv state would be short (the
    JAX reference crashes on its first decode step)."""
    _check_family(cfg, MODEL_FAMILIES)
    f = cfg.family
    s = tokens.shape[1]
    if f in ("ssm", "hybrid") and s < cfg.ssm_conv - 1:
        raise ValueError(
            f"{cfg.name}: a wave prefill of {s} tokens is shorter than the "
            f"conv window (ssm_conv - 1 = {cfg.ssm_conv - 1}); the decode "
            f"conv state would be short")
    x = _embed(params, cfg, tokens, extras)
    s = x.shape[1]
    positions = _positions(cfg, x)
    if f in ("dense", "vlm", "moe"):
        for li, lp in enumerate(params["layers"]):
            x, (k, v) = _dense_layer_full(lp, x, cfg, positions)
            _write_kv(cache, li, k, v)
    elif f == "mla_moe":
        for li, lp in enumerate(_mla_stack(params)):
            x, (ckv, krope) = _mla_layer_full(lp, x, cfg, positions)
            _write_kv(cache, li, ckv, krope, keys=("ckv", "krope"))
    elif f == "audio":
        enc_out = _encode_audio(params, cfg, extras["frames"])
        for li, lp in enumerate(params["layers"]):
            x, (k, v, xk, xv) = _audio_dec_layer_full(lp, x, cfg, positions,
                                                      enc_out)
            _write_kv(cache, li, k, v)
            _write_kv(cache, li, xk, xv, keys=("xk", "xv"))
    else:
        for pools in state_pools(cache):
            if pools["conv"].dtype != x.dtype:
                pools["conv"] = pools["conv"].to(x.dtype)
        if f == "hybrid":
            for gi, gp in enumerate(params["groups"]):
                for li, lp in enumerate(gp):
                    x = _mamba_prefill(lp, x, cfg, {
                        k: v[gi, li] for k, v in cache["mamba"].items()})
                x, (k, v) = _dense_layer_full(params["shared"], x, cfg,
                                              positions)
                _write_kv(cache, gi, k, v)
            for ti, lp in enumerate(params.get("tail") or ()):
                x = _mamba_prefill(lp, x, cfg,
                                   {k: v[ti] for k, v in cache["tail"].items()})
        else:  # ssm
            for li, lp in enumerate(params["layers"]):
                x = _mamba_prefill(lp, x, cfg, {
                    k: v[li] for k, v in cache["layers"].items()})
    new_len = torch.full((), s, dtype=torch.int32, device=x.device)
    x_last = blocks.norm(cfg, params["final_norm"], x[:, -1])
    return lm_head(params, cfg, x_last), {**cache, "len": new_len}


def _dense_layer_wave(lp, x, cfg: ModelConfig, k_cache, v_cache, pos):
    hn = blocks.norm(cfg, lp["attn_norm"], x)
    return _residual(lp, x, hn, blocks.attn_decode(
        lp["attn"], hn, cfg, k_cache, v_cache, pos), cfg)


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One token for every row of a wave cache, at the shared cursor.

    token: int [B].  Each row's K/V is written at ``cache["len"]`` and the
    Mamba states advance, in place; the rows attend their first len + 1
    keys (B1 over the contiguous cache on CUDA, the MLA decode kernel over
    mla_moe's compressed rows; audio's cross-attention over all
    encoder_seq rows).  Nothing here reads a device value on the
    host, so the step can be captured as a CUDA graph.  Returns (logits
    [B, V], a shallow copy of the cache with ``len`` + 1).

    Under ``distributed.ctx.lowering_ctx(mesh=...)`` with a ``model``
    axis whose size does not divide the kv heads (dense, vlm, moe), the
    attention is split-K (``blocks.attn_decode_sharded``, JAX's branch):
    ``cache["k"]`` / ``["v"]`` are then this rank's slices under
    ``P(None, batch_axes, "model", None, None)`` (what ``cache_pspec`` /
    ``elastic.reshard_cache`` give where the batch takes the data axes);
    a moe layer runs expert-parallel under any mesh with ``model``."""
    _check_family(cfg, MODEL_FAMILIES)
    x = params["embed"][token.long()]
    pos = cache["len"]
    if cfg.rope_mode == "learned":
        x = x + params["pos_embed"].index_select(0, pos.reshape(1).long())
    f = cfg.family
    if f in ("dense", "vlm", "moe"):
        mesh = dist_ctx.mesh()
        if mesh is not None and "model" in mesh.shape \
                and cfg.n_kv_heads % mesh.shape["model"] != 0:
            # split-K: this rank's cache slices, combined over ``model``
            batch_axes = batch_pspec(mesh, x.shape[0], 1)[0]
            for li, lp in enumerate(params["layers"]):
                hn = blocks.norm(cfg, lp["attn_norm"], x)
                x = _residual(lp, x, hn, blocks.attn_decode_sharded(
                    lp["attn"], hn, cfg, cache["k"][li], cache["v"][li], pos,
                    mesh, batch_axes), cfg)
        else:
            for li, lp in enumerate(params["layers"]):
                x = _dense_layer_wave(lp, x, cfg, cache["k"][li],
                                      cache["v"][li], pos)
    elif f == "mla_moe":
        for li, lp in enumerate(_mla_stack(params)):
            hn = blocks.norm(cfg, lp["attn_norm"], x)
            x = x + blocks.mla_decode(lp["attn"], hn, cfg, cache["ckv"][li],
                                      cache["krope"][li], pos)
            x = x + _mlp(lp, blocks.norm(cfg, lp["ffn_norm"], x), cfg)
    elif f == "audio":
        for li, lp in enumerate(params["layers"]):
            hn = blocks.norm(cfg, lp["attn_norm"], x)
            x = x + blocks.attn_decode(lp["attn"], hn, cfg, cache["k"][li],
                                       cache["v"][li], pos)
            hn = blocks.norm(cfg, lp["xattn_norm"], x)
            x = x + blocks.cross_attn_decode(
                lp["xattn"], hn, cfg, cache["xk"][li], cache["xv"][li],
                cfg.encoder_seq)
            x = x + ffn(lp["ffn"], blocks.norm(cfg, lp["ffn_norm"], x),
                        cfg.gated_ffn)
    else:
        _promote_conv(cache, x.dtype)
        if f == "hybrid":
            for gi, gp in enumerate(params["groups"]):
                for li, lp in enumerate(gp):
                    x = _mamba_step(lp, x, cfg, {
                        k: v[gi, li] for k, v in cache["mamba"].items()})
                x = _dense_layer_wave(params["shared"], x, cfg,
                                      cache["k"][gi], cache["v"][gi], pos)
            for ti, lp in enumerate(params.get("tail") or ()):
                x = _mamba_step(lp, x, cfg,
                                {k: v[ti] for k, v in cache["tail"].items()})
        else:  # ssm
            for li, lp in enumerate(params["layers"]):
                x = _mamba_step(lp, x, cfg, {
                    k: v[li] for k, v in cache["layers"].items()})
    x = blocks.norm(cfg, params["final_norm"], x)
    return lm_head(params, cfg, x), {**cache, "len": pos + 1}


def decode_and_sample(params: dict, cfg: ModelConfig, tok_host: torch.Tensor,
                      tok_dev: torch.Tensor, use_dev: torch.Tensor,
                      cache: dict, sample_fn) -> tuple[torch.Tensor, dict]:
    """``decode_and_sample_paged`` for the wave cache: the input token
    merged on the device, ``where(use_dev, tok_dev, tok_host)``, one
    ``decode_step``, then ``sample_fn(logits)``."""
    token = torch.where(use_dev.to(torch.bool), tok_dev, tok_host)
    logits, cache = decode_step(params, cfg, token, cache)
    return sample_fn(logits), cache


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def supports_paged(cfg: ModelConfig) -> bool:
    """The port pages the dense, vlm and moe families' K/V, mla_moe's
    compressed rows and the hybrid family's shared-attention K/V (its
    Mamba state lives in a slot-indexed pool), the parallel-block dense
    model among them.  The ssm and audio families keep the shared cursor
    (wave mode), as in JAX."""
    return cfg.family in PAGED_FAMILIES


def wave_only(cfg: ModelConfig) -> bool:
    """True for the families the JAX package cannot page (pure SSM and
    encoder-decoder: recurrent or cross-attention state tied to the shared
    cursor); the engine's ``mode="auto"`` serves them in wave mode."""
    return cfg.family in ("ssm", "audio")


def has_slot_state(cfg: ModelConfig) -> bool:
    """True when the paged cache carries per-slot recurrent state (the
    hybrid family's Mamba conv window + SSM state)."""
    return cfg.family == "hybrid"


def _hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, layers_per_group, tail_layers) of the zamba2-style stack."""
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return n_groups, every, cfg.n_layers - n_groups * every


def init_paged_cache(cfg: ModelConfig, num_slots: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16, page_size: int = 16,
                     num_pages: int | None = None,
                     device: str | torch.device = "cuda",
                     kv_dtype: str = "bf16") -> dict:
    """Block-table KV cache: a shared page pool + per-slot state.

      k/v   [L, P, page, Hkv, Dh]   page pools (page 0 is the null page);
                                    hybrid: L = n_groups, one shared-attn
                                    application per group; int8 under
                                    kv_dtype="int8", beside
      k_scale/v_scale [L, P, page, Hkv] float32, one scale per row and head
      ckv/krope [L, P, page, R] / [L, P, page, Dr]   mla_moe instead of
                                    k/v: the compressed rows, dense layers
                                    first (int8: ckv_scale / krope_scale
                                    [L, P, page], one scale per row)
      mamba {conv [G, every, slots, K-1, C] (dtype),
             state [G, every, slots, H, P, N] float32}   hybrid only
      tail  the same with a leading [T, slots] axis, or None
      lens  [slots] int32           per-slot valid lengths

    The block table ``[slots, pages_per_slot]`` int32 is kept by the caller
    and passed in as ``cache["block"]``; ``paged_slot_capacity`` is
    ``pages_per_slot * page``.  By default P fits every slot at max_seq.
    """
    if cfg.family in ("ssm", "audio"):
        raise ValueError(f"paged cache unsupported for family {cfg.family!r}")
    _check_family(cfg, PAGED_FAMILIES)
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype: {kv_dtype!r}")
    dev = resolve_device(device)
    pages_per_slot = -(-max_seq // page_size)
    if num_pages is None:
        num_pages = num_slots * pages_per_slot + 1
    n_kv = cfg.n_layers
    out: dict = {}
    if cfg.family == "hybrid":
        n_kv, every, tail = _hybrid_layout(cfg)
        one = ssm_mod.init_mamba_cache(cfg, num_slots, dtype, dev)
        out["mamba"] = {k: torch.zeros((n_kv, every, *v.shape), dtype=v.dtype,
                                       device=dev) for k, v in one.items()}
        out["tail"] = ({k: torch.zeros((tail, *v.shape), dtype=v.dtype,
                                       device=dev) for k, v in one.items()}
                       if tail else None)
    shapes = {key: (n_kv, num_pages, page_size, cfg.n_kv_heads, cfg.d_head)
              for key in ("k", "v")}
    if cfg.family == "mla_moe":
        shapes = {"ckv": (n_kv, num_pages, page_size, cfg.kv_lora_rank),
                  "krope": (n_kv, num_pages, page_size, cfg.qk_rope_dim)}
    pools = {}
    for key, shape in shapes.items():
        if kv_dtype == "int8":
            pools[key] = torch.zeros(shape, dtype=torch.int8, device=dev)
            pools[key + "_scale"] = torch.zeros(shape[:-1],
                                                dtype=torch.float32,
                                                device=dev)
        else:
            pools[key] = torch.zeros(shape, dtype=dtype, device=dev)
    return {**pools, **out,
            "lens": torch.zeros((num_slots,), dtype=torch.int32, device=dev)}


def paged_pool_dtype(cache: dict) -> torch.dtype:
    """dtype of the page pools (the bytes that move with a page): int8
    under kv_dtype="int8"."""
    return cache[blocks.paged_pool_names(cache)[0]].dtype


def paged_kv_dtype(cache: dict) -> str:
    """The cache's kv_dtype string ("bf16" or "int8")."""
    return "int8" if paged_pool_dtype(cache) == torch.int8 else "bf16"


def kv_page_bytes(cfg: ModelConfig, page_size: int,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of one KV page across its layer-stacked pools: 1-byte codes
    plus their float32 row scales for int8 pools, else the element size
    (``serving.kv_cache.kv_page_elems``)."""
    from repro_torch.serving.kv_cache import (kv_page_elems,
                                              kv_page_scale_elems)
    if dtype == torch.int8:
        return (kv_page_elems(cfg, page_size)
                + 4 * kv_page_scale_elems(cfg, page_size))
    return kv_page_elems(cfg, page_size) * dtype.itemsize


def _pool(cache: dict, key: str, li: int):
    """Layer ``li``'s view of one page pool: the tensor, or the (int8 data,
    float32 scales) pair under kv_dtype="int8"."""
    sk = key + "_scale"
    return (cache[key][li], cache[sk][li]) if sk in cache else cache[key][li]


def swap_out_pages(cache: dict, page_ids: torch.Tensor
                   ) -> tuple[torch.Tensor, ...]:
    """Page payloads for the flash tier or a snapshot: one tensor per
    ``blocks.paged_pool_keys`` entry, [L, n, page, ...] (float32 scale
    payloads beside int8 ones), gathered into new device tensors."""
    return blocks.kv_swap_out(cache, page_ids)


def swap_in_pages(cache: dict, page_ids: torch.Tensor,
                  *payloads: torch.Tensor) -> dict:
    """Scatter page payloads onto ``page_ids`` of the hot pools, in place;
    the caller remaps the owning slot's block-table row to the new pids."""
    return blocks.kv_swap_in(cache, page_ids, *payloads)


def checkpoint_slot_state(cache: dict, slot: int):
    """Snapshot one slot's recurrent state (hybrid Mamba conv window + SSM
    state) as host tensors; None for families without per-slot state."""
    if "mamba" not in cache:
        return None
    out = {"mamba": {k: v[:, :, slot].cpu().clone()
                     for k, v in cache["mamba"].items()}}
    if cache.get("tail") is not None:
        out["tail"] = {k: v[:, slot].cpu().clone()
                       for k, v in cache["tail"].items()}
    return out


def restore_slot_state(cache: dict, slot: int, ckpt) -> dict:
    """Write a ``checkpoint_slot_state`` snapshot back into the slot's rows
    of the state pools (in place); returns the cache."""
    if ckpt is None:
        return cache
    for k, pool in cache["mamba"].items():
        pool[:, :, slot] = ckpt["mamba"][k].to(pool.device, pool.dtype)
    if ckpt.get("tail") is not None and cache.get("tail") is not None:
        for k, pool in cache["tail"].items():
            pool[:, slot] = ckpt["tail"][k].to(pool.device, pool.dtype)
    return cache


def paged_slot_capacity(cache: dict) -> int:
    """Max tokens one slot can hold (pages_per_slot * page_size)."""
    return (cache["block"].shape[1]
            * cache[blocks.paged_pool_names(cache)[0]].shape[2])


def _first_rows(slot_ids: torch.Tensor) -> torch.Tensor:
    """Index of the first row of each distinct slot id.  The engine pads a
    prefill group by repeating its first row; the repeats carry the same
    values, but an index_put with duplicate indices is a write race on a
    card, so only these rows are written."""
    uniq, inv = torch.unique(slot_ids, return_inverse=True)
    m = slot_ids.shape[0]
    first = torch.full(uniq.shape, m, dtype=torch.long,
                       device=slot_ids.device)
    return first.scatter_reduce_(0, inv, torch.arange(
        m, device=slot_ids.device), reduce="amin")


def prefill_into_slots(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       true_lens: torch.Tensor, cache: dict,
                       slot_ids: torch.Tensor, extras: dict | None = None
                       ) -> tuple[torch.Tensor, dict]:
    """Prefill M requests into M slots of a paged cache, in one pass.

    tokens: [M, Sp] right-padded to a common bucket length; true_lens: [M]
    int32 valid cache lengths (the prompt, and the vlm family's prepended
    ``extras["vision_embeds"]`` rows); slot_ids: [M].  Only the named
    slots' pages (already in their block-table rows) and state rows are
    written.  Returns (per-request last-valid-position logits [M, V],
    cache).

    Right-padding keeps every row's positions 0-based; causality keeps the
    pads out of every valid position's attention, and pad K/V land in the
    row's own pages (or the null page past its allocation), masked by
    ``lens``.  The Mamba recurrence would fold trailing pads into the
    state, so (hybrid) pad positions get dt = 0, an identity state update,
    and the decode conv window is gathered at each row's own length.
    """
    _check_family(cfg, PAGED_FAMILIES)
    x = _embed(params, cfg, tokens, extras)
    m, s = x.shape[0], x.shape[1]
    positions = _positions(cfg, x)
    true_lens = true_lens.to(device=x.device, dtype=torch.int32)
    slot_ids = slot_ids.to(device=x.device).long()
    rows = _first_rows(slot_ids)
    slots = slot_ids[rows]
    names = blocks.paged_pool_names(cache)
    page = cache[names[0]].shape[2]
    n_pages = -(-s // page)
    pids = cache["block"][slots][:, :n_pages].long()      # [U, n_pages]

    def to_pages(arr: torch.Tensor, pool: torch.Tensor) -> None:
        # [U, S, *row] -> the slots' pages [U, n_pages, page, *row]
        if n_pages * page != s:
            pad = [0, 0] * (arr.dim() - 2) + [0, n_pages * page - s]
            arr = torch.nn.functional.pad(arr, pad)
        pool[pids] = arr.reshape(rows.shape[0], n_pages, page,
                                 *arr.shape[2:]).to(pool.dtype)

    def write_kv(li: int, k: torch.Tensor, v: torch.Tensor) -> None:
        # [M, S, Hkv, Dh] (mla_moe: [M, S, R], [M, S, Dr]); int8 pools
        # quantize per row HERE, at the write
        for name, arr in zip(names, (k, v)):
            arr = arr[rows]
            if name + "_scale" in cache:
                arr, scale = quantize_rows(arr)
                to_pages(scale, cache[name + "_scale"][li])
            to_pages(arr, cache[name][li])

    if cfg.family in ("dense", "vlm", "moe"):
        for li, lp in enumerate(params["layers"]):
            x, (k, v) = _dense_layer_full(lp, x, cfg, positions)
            write_kv(li, k, v)
    elif cfg.family == "mla_moe":
        for li, lp in enumerate(_mla_stack(params)):
            x, (ckv, krope) = _mla_layer_full(lp, x, cfg, positions)
            write_kv(li, ckv, krope)
    else:  # hybrid
        valid = torch.arange(s, device=x.device)[None, :] < true_lens[:, None]

        def mamba(lp, h, pool: dict):
            # pool: one layer's {conv [slots, K-1, C], state [slots, H, P, N]}
            out, state = _mamba_full(lp, h, cfg, valid)
            conv = ssm_mod.conv_tail_at(lp, h, cfg, true_lens)
            pool["conv"][slots] = conv[rows].to(pool["conv"].dtype)
            pool["state"][slots] = state[rows].to(pool["state"].dtype)
            return out

        for gi, gp in enumerate(params["groups"]):
            for li, lp in enumerate(gp):
                x = mamba(lp, x, {k: v[gi, li]
                                  for k, v in cache["mamba"].items()})
            x, (k, v) = _dense_layer_full(params["shared"], x, cfg, positions)
            write_kv(gi, k, v)
        for ti, lp in enumerate(params.get("tail") or ()):
            x = mamba(lp, x, {k: v[ti] for k, v in cache["tail"].items()})
    lens = cache["lens"].clone()
    lens[slots] = true_lens[rows]
    x_last = x[torch.arange(m, device=x.device), true_lens.long() - 1]
    x_last = blocks.norm(cfg, params["final_norm"], x_last)
    return lm_head(params, cfg, x_last), {**cache, "lens": lens}


def prefill_into_slot(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      true_len, cache: dict, slot, extras: dict | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """One request's ``prefill_into_slots`` (JAX ``prefill_into_slot``).

    tokens: [1, Sp]; true_len, slot: ints or 0-d tensors.  Returns
    (logits [V], cache)."""
    dev = tokens.device
    logits, cache = prefill_into_slots(
        params, cfg, tokens,
        torch.as_tensor(true_len, dtype=torch.int32).reshape(1).to(dev),
        cache, torch.as_tensor(slot, dtype=torch.int32).reshape(1).to(dev),
        extras)
    return logits[0], cache


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill needs a paged cache and a 1-D token / position
    stream (no prepended vision or audio embeddings to split across chunk
    calls): the dense and moe families, as in JAX."""
    return supports_paged(cfg) and cfg.family in ("dense", "moe")


def prefill_chunk_into_slot(params: dict, cfg: ModelConfig,
                            tokens: torch.Tensor, start: int, chunk_len: int,
                            cache: dict, slot: int
                            ) -> tuple[torch.Tensor, dict]:
    """Chunked-prefill continuation: ``chunk_len`` prompt tokens of one
    slot, from cache position ``start``.

    tokens: [C] int, the chunk right-padded to a bucket (the engine's
    power-of-two buckets with the page size as floor).  Each chunk
    position's K/V is scattered into the slot's pages first, then the
    chunk's queries attend the block row up to their own positions (the
    buffer decode reads; on CUDA the chunk kernel, which gives each query
    B3's bits, the one-shot prefill's), and every other op is row-wise
    (the int8 products exact, the norms' means the same for any row count
    of a bucket, as the card and the CPU show; the moe family's router in
    fixed 8-row products and its grouped GEMM, whose row bits do not depend
    on the group): a position's bits do not
    depend on how the prompt was split, so the cache, the returned logits
    and every later decode logit are the same for ANY chunk schedule, the
    single chunk and, over bf16 pools, ``prefill_into_slots`` included (a
    partial prefix hit equals a cold run).  The pools and
    ``cache["lens"][slot]`` (= start + chunk_len) are written in place.

    Returns (logits [V] at chunk position ``chunk_len - 1``, cache).
    """
    if not supports_chunked_prefill(cfg):
        raise ValueError(
            f"chunked prefill unsupported for family {cfg.family!r}")
    c = tokens.shape[0]
    x = params["embed"][tokens.long()][None]                # [1, C, D]
    if cfg.rope_mode == "learned":
        tbl = params["pos_embed"]
        gpos = start + torch.arange(c, device=x.device)
        x = x + tbl[torch.clamp(gpos, 0, tbl.shape[0] - 1)][None]
    block_row = cache["block"][slot]
    for li, lp in enumerate(params["layers"]):
        hn = blocks.norm(cfg, lp["attn_norm"], x)
        attn_out = blocks.attn_prefill_chunk_paged(
            lp["attn"], hn, cfg, _pool(cache, "k", li), _pool(cache, "v", li),
            block_row, start, chunk_len)
        x = _residual(lp, x, hn, attn_out, cfg)
    cache["lens"][slot] = start + chunk_len
    x_last = x[:, min(max(chunk_len - 1, 0), c - 1)]
    x_last = blocks.norm(cfg, params["final_norm"], x_last)
    return lm_head(params, cfg, x_last)[0], cache


def _dense_layer_decode(lp, x, cfg: ModelConfig, k_pages, v_pages, block,
                        lens, active):
    # k/v_pages: one layer's pools (``_pool``)
    hn = blocks.norm(cfg, lp["attn_norm"], x)
    return _residual(lp, x, hn, blocks.attn_decode_paged(
        lp["attn"], hn, cfg, k_pages, v_pages, block, lens, active), cfg)


def decode_step_paged(params: dict, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict, active: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """One decode step over mixed-progress slots of a paged cache.

    token: int [B]; active: bool [B].  Each slot attends its own valid
    prefix (``cache["lens"]``) through its block-table row; inactive slots
    write to the null page and keep their length, and (hybrid) their conv
    window and SSM state stay bit-identical, so their lanes are pure
    padding.  Returns (logits [B, V], cache); logits of inactive slots are
    garbage and must be ignored by the caller.
    """
    _check_family(cfg, PAGED_FAMILIES)
    x = params["embed"][token.long()]
    lens = cache["lens"]
    # a slot at capacity must not decode: its page write would clamp onto
    # its own last page, so its lane is deactivated instead
    active = active.to(torch.bool) & (lens < paged_slot_capacity(cache))
    if cfg.rope_mode == "learned":
        x = x + params["pos_embed"][lens.long()]
    block = cache["block"]
    if cfg.family in ("dense", "vlm", "moe"):
        for li, lp in enumerate(params["layers"]):
            x = _dense_layer_decode(lp, x, cfg, _pool(cache, "k", li),
                                    _pool(cache, "v", li), block, lens,
                                    active)
    elif cfg.family == "mla_moe":
        for li, lp in enumerate(_mla_stack(params)):
            hn = blocks.norm(cfg, lp["attn_norm"], x)
            x = x + blocks.mla_decode_paged(
                lp["attn"], hn, cfg, _pool(cache, "ckv", li),
                _pool(cache, "krope", li), block, lens, active)
            x = x + _mlp(lp, blocks.norm(cfg, lp["ffn_norm"], x), cfg)
    else:  # hybrid
        _promote_conv(cache, x.dtype)
        for gi, gp in enumerate(params["groups"]):
            for li, lp in enumerate(gp):
                x = _mamba_step(lp, x, cfg, {
                    k: v[gi, li] for k, v in cache["mamba"].items()}, active)
            x = _dense_layer_decode(params["shared"], x, cfg,
                                    _pool(cache, "k", gi),
                                    _pool(cache, "v", gi), block, lens,
                                    active)
        for ti, lp in enumerate(params.get("tail") or ()):
            x = _mamba_step(lp, x, cfg,
                            {k: v[ti] for k, v in cache["tail"].items()},
                            active)
    cache = {**cache, "lens": lens + active.to(torch.int32)}
    x = blocks.norm(cfg, params["final_norm"], x)
    return lm_head(params, cfg, x), cache


def decode_and_sample_paged(params: dict, cfg: ModelConfig,
                            tok_host: torch.Tensor, tok_dev: torch.Tensor,
                            use_dev: torch.Tensor, cache: dict,
                            active: torch.Tensor, sample_fn
                            ) -> tuple[torch.Tensor, dict]:
    """Fused decode + sample: the overlapped serving loop's one step.

    The input token is merged on the device, ``where(use_dev, tok_dev,
    tok_host)``: a slot whose previous token was sampled by the previous
    fused step (``tok_dev``, not yet read by the host) chains into this
    step with no host round trip, while a freshly prefilled slot feeds its
    host-known first token through ``tok_host``.  ``sample_fn(logits) ->
    tokens`` keeps this module free of the sampler; the engine closes it
    over the per-request sampling rows.  Returns (tokens [B], cache);
    tokens of inactive rows are garbage, as ``decode_step_paged``'s logits
    are.
    """
    token = torch.where(use_dev.to(torch.bool), tok_dev, tok_host)
    logits, cache = decode_step_paged(params, cfg, token, cache, active)
    return sample_fn(logits), cache
