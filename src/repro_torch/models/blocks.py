"""GQA attention block shared by the transformer families (dense, vlm
with M-RoPE, hybrid and audio subset), and DeepSeek's multi-head latent
attention (MLA, the mla_moe family).

Counterpart of ``repro.models.blocks``.  Where the JAX model runs the jnp
twins of its Pallas kernels, this module calls the kernel wrappers: on a
CUDA tensor they launch the Hopper kernels (B3 flash attention for prefill,
causal or, for the whisper encoder and cross-attention, bidirectional; B1
decode attention over the paged pools or, in wave mode, over the
contiguous cache; and for a prefill chunk the paged chunk attention, which
runs B3's per-block arithmetic through the block row, so a chunk query gets
B3's one-shot bits), on a CPU tensor their plain versions.  MLA's prefill
runs B3 at the qk head (192 at full width: v padded to it), its decode
the paged MLA decode attention kernel over the compressed ``ckv`` /
``krope`` pools (in wave mode over the contiguous cache).  The page pools
are bf16 tensors or int8 ``(data, scale)`` pairs (``models.attention``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import P, gather_shard, local_shard
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_chunk_attention,
                                                      paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mla_decode_attention.ops import (
    mla_decode_attention, mla_decode_attention_contiguous)
from repro_torch.models.attention import (gather_kv_pages, pool_page_size,
                                          scatter_chunk_rows, scatter_kv_pages,
                                          write_paged_rows)
from repro_torch.models.layers import (apply_mrope, apply_rope,
                                       dense_weight, fixed_row_bmm,
                                       init_linear, layer_norm, linear,
                                       mrope_grid_side, rms_norm)


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


def _mrope_decode_pos(cfg: ModelConfig, pos):
    """M-RoPE position of the text token at cache index ``pos``: prefill
    gives text tokens ``idx - n_vision + side`` (layers.mrope_positions),
    and decode continues that stream, not the raw cache index."""
    return pos - cfg.n_vision_tokens + mrope_grid_side(cfg.n_vision_tokens)


def _decode_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """The rotary positions of one decode token per row, from its cache
    index ``pos`` [B, 1] (a device tensor, so a captured step reads it):
    itself, or under M-RoPE the text stream's position in all three
    streams, [3, B, 1]."""
    if cfg.rope_mode == "mrope":
        return _mrope_decode_pos(cfg, pos)[None].expand(3, *pos.shape)
    return pos


def _rope_qk(cfg: ModelConfig, q, k, positions):
    if cfg.rope_mode == "standard":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    elif cfg.rope_mode == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k


def attn_full(params: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, causal: bool = True,
              kv_override: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention (the B3 flash attention kernel).  Returns
    (out, k, v) so callers can build the cache.  ``kv_override``:
    cross-attention source states [B, Senc, D], no RoPE; the attention is
    bidirectional under ``kv_override`` or ``causal=False``."""
    b, s, _ = x.shape
    src = kv_override if kv_override is not None else x
    q = linear(params["q"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = linear(params["k"], src).reshape(b, src.shape[1], cfg.n_kv_heads,
                                         cfg.d_head)
    v = linear(params["v"], src).reshape(b, src.shape[1], cfg.n_kv_heads,
                                         cfg.d_head)
    if kv_override is None:
        q, k = _rope_qk(cfg, q, k, positions)
    q = ctx.constrain(q, kind="heads")
    k = ctx.constrain(k, kind="heads")
    v = ctx.constrain(v, kind="heads")
    out = flash_attention(q, k, v, causal=causal and kv_override is None)
    out = ctx.constrain(out, kind="heads")
    out = linear(params["o"], out.reshape(b, s, -1))
    return out, k, v


def attn_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """One-token attention against the wave engine's contiguous cache.

    x: [B, D]; k/v_cache: [B, Smax, Hkv, Dh] (one layer's, written IN
    PLACE: this token's K/V row at ``pos``); pos: int32 [] on the device,
    the shared cursor.  Every row attends its first pos + 1 rows (B1 over
    the cache read as B pages on CUDA).  Returns out [B, D]."""
    b = x.shape[0]
    q = linear(params["q"], x).reshape(b, 1, cfg.n_heads, cfg.d_head)
    k = linear(params["k"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = linear(params["v"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    q, k = _rope_qk(cfg, q, k,
                    _decode_positions(cfg, pos.reshape(1, 1).expand(b, 1)))
    at = pos.reshape(1).long()
    k_cache.index_copy_(1, at, k.to(k_cache.dtype))
    v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    lengths = (pos + 1).to(torch.int32).reshape(1).expand(b).contiguous()
    out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths)
    return linear(params["o"], out.reshape(b, -1))


# ---------------------------------------------------------------------------
# split-K decode attention over the model axis (flash-decoding)
# ---------------------------------------------------------------------------
#
# Each model rank owns S / n of the sequence of every wave-cache row,
# performs the new token's K/V write only if the position lands in its
# slice, computes its partial online softmax, and the ranks combine with
# small (m, l, o) reductions (JAX ``attn_decode_sharded``).

NEG_INF = -1e30


def attn_decode_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        k_cache: torch.Tensor, v_cache: torch.Tensor,
                        pos: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """Split-K decode attention on one rank.  x: [B, D], the same on every
    rank; k/v_cache: this rank's slice of the layer's wave cache [B, Smax,
    Hkv, Dh] under ``P(batch_axes, "model", None, None)`` (the rows of
    its batch slice, the sequence rows ``[i S/n, (i+1) S/n)`` of model
    index i), written IN PLACE; pos: int32 [] on the device.

    The rank that owns ``pos`` writes the new K/V there (a clamped index
    and ``torch.where``, no host read); every rank computes its float32
    partial (m, l, o) over its rows (plain torch: JAX computes this part in
    jnp, outside any Pallas kernel), combined by ``pmax`` and two
    ``psum``s over ``model``; the batch slices are gathered back over
    ``batch_axes``.  Returns out [B, D]."""
    b = x.shape[0]
    q = linear(params["q"], x).reshape(b, 1, cfg.n_heads, cfg.d_head)
    k = linear(params["k"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = linear(params["v"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    q, k = _rope_qk(cfg, q, k,
                    _decode_positions(cfg, pos.reshape(1, 1).expand(b, 1)))
    n_rep = cfg.n_heads // cfg.n_kv_heads
    bspec = P(batch_axes, None, None, None)
    qb, kb, vb = (local_shard(t, bspec, mesh) for t in (q, k, v))
    s_loc = k_cache.shape[1]
    s0 = mesh.axis_index("model") * s_loc
    p = pos.reshape(1).long()
    idx = torch.clamp(p - s0, 0, s_loc - 1)
    in_range = (p >= s0) & (p < s0 + s_loc)
    for cache, new in ((k_cache, kb), (v_cache, vb)):
        cur = cache.index_select(1, idx)
        cache.index_copy_(1, idx, torch.where(in_range, new.to(cache.dtype),
                                              cur))
    # local online softmax over this rank's sequence slice; GQA by a
    # grouped einsum (no repeated cache)
    bq = qb[:, 0].reshape(qb.shape[0], cfg.n_kv_heads, n_rep, cfg.d_head)
    s = torch.einsum("bgrd,bsgd->bgrs", bq.float(),
                     k_cache.float()) * (cfg.d_head ** -0.5)
    valid = (s0 + torch.arange(s_loc, device=x.device)) < (p + 1)
    s = torch.where(valid, s, NEG_INF)
    m_loc = s.amax(-1)                                 # [B, G, R]
    p_exp = torch.exp(s - m_loc[..., None])
    l_loc = p_exp.sum(-1)
    o_loc = torch.einsum("bgrs,bsgd->bgrd", p_exp, v_cache.float())
    m = mesh.pmax(m_loc, "model")
    scale = torch.exp(m_loc - m)
    l = mesh.psum(l_loc * scale, "model")
    o = mesh.psum(o_loc * scale[..., None], "model")
    o = o / torch.clamp_min(l, 1e-20)[..., None]
    o = o.reshape(o.shape[0], cfg.n_heads * cfg.d_head).to(x.dtype)
    out = gather_shard(o, P(batch_axes, None), mesh)
    return linear(params["o"], out)


def cross_attn_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      enc_len: int) -> torch.Tensor:
    """Decoder cross-attention against the fixed encoder K/V
    ``[B, Senc, Hkv, Dh]``: every row attends its first ``enc_len``."""
    b = x.shape[0]
    q = linear(params["q"], x).reshape(b, cfg.n_heads, cfg.d_head)
    lengths = torch.full((b,), enc_len, dtype=torch.int32, device=x.device)
    return linear(params["o"], decode_attention(
        q.contiguous(), k_cache, v_cache, lengths).reshape(b, -1))


def attn_decode_paged(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      block_table: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
    """One-token attention against a paged per-slot cache.

    x: [B, D]; k/v_pages: [P, page, Hkv, Dh] (one layer's pools, written IN
    PLACE); block_table: [B, pages_per_slot] int32; lengths: [B] int32
    per-slot valid lengths (the new token's write position); active: [B]
    bool.  Returns out [B, D].  The attend is the B1 paged decode kernel;
    int8 ``(data, scale)`` pools quantize the new rows at their write.
    """
    b = x.shape[0]
    q = linear(params["q"], x).reshape(b, 1, cfg.n_heads, cfg.d_head)
    k = linear(params["k"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = linear(params["v"], x).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    q, k = _rope_qk(cfg, q, k, _decode_positions(cfg, lengths.reshape(b, 1)))
    write_paged_rows(k_pages, k[:, 0], block_table, lengths, active)
    write_paged_rows(v_pages, v[:, 0], block_table, lengths, active)
    out = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 block_table,
                                 (lengths + active.to(torch.int32)).contiguous())
    return linear(params["o"], out.reshape(b, -1))


def attn_prefill_chunk_paged(params: dict, x: torch.Tensor, cfg: ModelConfig,
                             k_pages, v_pages, block_row: torch.Tensor,
                             start: int, chunk_len: int) -> torch.Tensor:
    """Chunked-prefill attention for ONE slot against the paged pool.

    x: [1, C, D] chunk hidden states (C a bucket; rows from ``chunk_len`` on
    are padding); k/v_pages: one layer's pools (written IN PLACE);
    block_row: [pages_per_slot] int32, the slot's block-table row; the
    chunk's rows sit at cache positions ``start + i``.

    The chunk's K/V is scattered into the slot's pages FIRST (padding rows
    are redirected to the null page 0), then every query attends the block
    row up to its own position (the paged chunk kernel on CUDA: over bf16
    pools a query's bits are B3's in a one-shot prefill), so each
    position's math is the same however the prompt was chunked, the
    one-shot prefill included.  Returns out [1, C, D].
    """
    b, c, _ = x.shape
    q = linear(params["q"], x).reshape(b, c, cfg.n_heads, cfg.d_head)
    k = linear(params["k"], x).reshape(b, c, cfg.n_kv_heads, cfg.d_head)
    v = linear(params["v"], x).reshape(b, c, cfg.n_kv_heads, cfg.d_head)
    gpos = start + torch.arange(c, device=x.device)
    q, k = _rope_qk(cfg, q, k, gpos[None])
    page = pool_page_size(k_pages)
    pps = block_row.shape[0]
    valid = torch.arange(c, device=x.device) < chunk_len
    pid = block_row.long()[torch.clamp(gpos // page, 0, pps - 1)]
    pid = torch.where(valid, pid, torch.zeros_like(pid))
    off = gpos % page
    scatter_chunk_rows(k_pages, k[0], pid, off)
    scatter_chunk_rows(v_pages, v[0], pid, off)
    out = paged_chunk_attention(q[0].contiguous(), k_pages, v_pages,
                                block_row, start, chunk_len)
    return linear(params["o"], out.reshape(b, c, -1))


def paged_pool_names(cache: dict) -> tuple[str, str]:
    """The two layer-stacked page pools of a paged cache: K and V, or MLA's
    compressed ``ckv`` / ``krope`` rows ([page, R] and [page, Dr])."""
    return ("ckv", "krope") if "ckv" in cache else ("k", "v")


def paged_pool_keys(cache: dict) -> tuple[str, ...]:
    """The cache keys whose pages move with a page: the two pools of
    ``paged_pool_names`` and, under ``kv_dtype="int8"``, their float32
    scale pools, in this order."""
    a, b = paged_pool_names(cache)
    keys = (a, b)
    if a + "_scale" in cache:
        keys += (a + "_scale", b + "_scale")
    return keys


def kv_swap_out(cache: dict, page_ids: torch.Tensor
                ) -> tuple[torch.Tensor, ...]:
    """The tier's spill: whole pages gathered from every pool of
    ``paged_pool_keys`` (K / V, then their scales under int8), each
    [L, n, page, ...] in a new tensor; the pools are untouched and the
    caller hands the freed pids back to the allocator."""
    keys = paged_pool_keys(cache)
    out = []
    for a, b in zip(keys[::2], keys[1::2]):
        out += gather_kv_pages(cache[a], cache[b], page_ids)
    return tuple(out)


def kv_swap_in(cache: dict, page_ids: torch.Tensor,
               *payloads: torch.Tensor) -> dict:
    """The tier's prefetch and a migration's inject: one payload per
    ``paged_pool_keys`` entry, as ``kv_swap_out`` returns them, written
    onto ``page_ids`` in place (the pools keep their storage, which a
    captured decode graph reads); the caller remaps the block table."""
    keys = paged_pool_keys(cache)
    if len(payloads) != len(keys):
        raise ValueError(f"{len(payloads)} payloads for pools {keys}")
    pay = dict(zip(keys, payloads))
    for a, b in zip(keys[::2], keys[1::2]):
        scatter_kv_pages(cache[a], cache[b], page_ids, pay[a], pay[b])
    return cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> dict:
    qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "q": init_linear(gen, cfg.d_model, cfg.n_heads * qk_head, False,
                         dtype, device),
        "kv_a": init_linear(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_dim, False, dtype,
                            device),
        "kv_a_norm": torch.ones((cfg.kv_lora_rank,), dtype=dtype,
                                device=device),
        "kv_b": init_linear(gen, cfg.kv_lora_rank,
                            cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim),
                            False, dtype, device),
        "o": init_linear(gen, cfg.n_heads * cfg.v_head_dim, cfg.d_model,
                         False, dtype, device),
    }


def mla_full(params: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence MLA (B3 at the qk head, v padded to it, the output cut
    back to v's width; the scale qk_head^-0.5).  Returns (out, c_kv [B, S,
    R], k_rope [B, S, Dr]) for the compressed cache."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q = linear(params["q"], x).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = linear(params["kv_a"], x)
    c_kv = rms_norm(kv[..., :r], params["kv_a_norm"], cfg.norm_eps)
    kvb = linear(params["kv_b"], c_kv).reshape(b, s, h, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(kv[..., r:].reshape(b, s, 1, dr), positions,
                        cfg.rope_theta)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    vpad = torch.nn.functional.pad(v, (0, dn + dr - dv))
    out = flash_attention(qf, kf, vpad, causal=True)[..., :dv]
    out = linear(params["o"], out.reshape(b, s, -1))
    return out, c_kv, k_rope[:, :, 0, :]


def _mla_decode_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    posb: torch.Tensor):
    """The decode token's projections: (q_nope [B, H, Dn], roped q_rope
    [B, H, Dr], normed c_kv [B, R], roped k_rope [B, Dr]) at per-lane
    positions ``posb`` [B, 1]."""
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = linear(params["q"], x).reshape(b, h, dn + dr)
    kv = linear(params["kv_a"], x)
    c_kv = rms_norm(kv[..., :r], params["kv_a_norm"], cfg.norm_eps)
    q_rope = apply_rope(q[..., dn:][:, None], posb, cfg.rope_theta)[:, 0]
    k_rope = apply_rope(kv[..., r:][:, None, None, :], posb,
                        cfg.rope_theta)[:, 0, 0]
    return q[..., :dn], q_rope, c_kv, k_rope


def _mla_up_weights(params: dict, cfg: ModelConfig):
    """(W_uk [H, Dn, R], W_uv [H, R, Dv]) float32, from ``kv_b``'s dense
    weight [R, H * (Dn + Dv)] (dequantized under W8A8, as JAX does)."""
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn = cfg.qk_nope_dim
    wkb = dense_weight(params["kv_b"]).float().reshape(r, h, -1)
    return wkb[..., :dn].permute(1, 2, 0), wkb[..., dn:].permute(1, 0, 2)


def _mla_absorbed_attend(params: dict, x: torch.Tensor, cfg: ModelConfig,
                         q_nope: torch.Tensor, q_rope: torch.Tensor,
                         attend) -> torch.Tensor:
    """JAX's ``_mla_absorbed_attend`` around its attention: the absorbed
    query ``q_c = q_nope . W_uk`` and the output ``ctx . W_uv`` are float32
    products per head in fixed 8-row blocks (a row's bits do not depend on
    the batch), ``attend(q_c, q_rope)`` the attention (the MLA decode
    kernel on CUDA), then the output projection.  Returns out [B, D]."""
    b = x.shape[0]
    w_uk, w_uv = _mla_up_weights(params, cfg)
    q_c = fixed_row_bmm(q_nope.float().transpose(0, 1), w_uk)  # [H, B, R]
    ctx = attend(q_c.transpose(0, 1).contiguous(),
                 q_rope.float().contiguous())                   # [B, H, R]
    out = fixed_row_bmm(ctx.transpose(0, 1), w_uv).transpose(0, 1)
    return linear(params["o"], out.reshape(b, -1).to(x.dtype))


def mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def mla_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
               ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """One-token MLA against the wave engine's contiguous compressed cache:
    ckv/krope_cache [B, Smax, R] / [B, Smax, Dr] (one layer's, written IN
    PLACE at ``pos``, the shared cursor, an int32 [] on the device); every
    row attends its first pos + 1 rows (the MLA decode kernel over the
    cache read as B pages on CUDA).  Returns out [B, D]."""
    b = x.shape[0]
    posb = pos.reshape(1, 1).expand(b, 1)
    q_nope, q_rope, c_kv, k_rope = _mla_decode_qkv(params, x, cfg, posb)
    at = pos.reshape(1).long()
    ckv_cache.index_copy_(1, at, c_kv[:, None].to(ckv_cache.dtype))
    krope_cache.index_copy_(1, at, k_rope[:, None].to(krope_cache.dtype))
    lengths = (pos + 1).to(torch.int32).reshape(1).expand(b).contiguous()
    return _mla_absorbed_attend(
        params, x, cfg, q_nope, q_rope,
        lambda q_c, q_r: mla_decode_attention_contiguous(
            q_c, q_r, ckv_cache, krope_cache, lengths, mla_scale(cfg)))


def mla_decode_paged(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     ckv_pages, krope_pages, block_table: torch.Tensor,
                     lengths: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """One-token MLA against a paged compressed cache.

    ckv/krope_pages: [P, page, R] / [P, page, Dr] pools or int8 ``(data,
    scale)`` pairs (one layer's, written IN PLACE: this token's rows at
    ``lengths``, inactive lanes to the null page); block_table: [B, pps];
    lengths: [B] the new token's write positions; active: [B] bool.  The
    attend is the paged MLA decode kernel on CUDA, through the block
    table.  Returns out [B, D]."""
    b = x.shape[0]
    q_nope, q_rope, c_kv, k_rope = _mla_decode_qkv(params, x, cfg,
                                                   lengths.reshape(b, 1))
    write_paged_rows(ckv_pages, c_kv, block_table, lengths, active)
    write_paged_rows(krope_pages, k_rope, block_table, lengths, active)
    valid = (lengths + active.to(torch.int32)).contiguous()
    return _mla_absorbed_attend(
        params, x, cfg, q_nope, q_rope,
        lambda q_c, q_r: mla_decode_attention(
            q_c, q_r, ckv_pages, krope_pages, block_table, valid,
            mla_scale(cfg)))
