"""Attention: chunked (flash-style) full attention + single-token decode.

Plain PyTorch versions of ``repro.models.attention``: the CPU path of the
port and the oracles of its CUDA kernels (``kernels/flash_attention``,
``kernels/decode_attention``).  Layouts follow the JAX package: q
``[B, S, H, D]``, caches ``[B, Smax, Hkv, D]``, page pools
``[P, page, Hkv, D]``.

A pool is a tensor ``[P, page, *row]`` or, for ``kv_dtype="int8"``, a
``(data int8 [P, page, *row], scale float32 [P, page, *row[:-1]])`` pair
with one symmetric scale per row over its last axis.  Rows quantize once,
at their write (prefill, the decode append, a prefill chunk), and
dequantize where they are attended; the scale depends on the row's own
values only, so a page's bits are a function of its token span.

Unlike the JAX versions, which return new arrays, the page writes here
update the pool in place.
"""

from __future__ import annotations

import torch

from repro_torch.quant.int8 import INV127

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] (GQA head sharing)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over chunks, positions 0..S-1.

    q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D]. Returns [B, Sq, H, D] in q's
    dtype; scores, softmax and accumulator in float32.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    sm_scale = d ** -0.5
    qf = q.float().transpose(1, 2)   # [B, H, Sq, D]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    pos_q = torch.arange(sq, device=q.device)
    pos_kv = torch.arange(skv, device=q.device)
    outs = []
    for q0 in range(0, sq, q_chunk):
        q_blk = qf[:, :, q0:q0 + q_chunk]
        cq = q_blk.shape[2]
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, kv_chunk):
            s = (q_blk @ kf[:, :, k0:k0 + kv_chunk].transpose(-1, -2)) \
                * sm_scale
            if causal:
                mask = pos_q[q0:q0 + cq, None] >= pos_kv[None, k0:k0 + kv_chunk]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf[:, :, k0:k0 + kv_chunk]
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-20)[..., None])
    out = torch.cat(outs, dim=2).transpose(1, 2)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
    """One-token attention against a cache.

    q: [B, H, D]; k_cache/v_cache: [B, Smax, Hkv, D]; length: [] or [B]
    (valid prefix length per slot, the new token's kv already written).
    A slot with length 0 gives a finite row (uniform softmax over masked
    scores); callers ignore inactive slots' outputs.
    """
    b, smax, hkv, d = k_cache.shape
    h = q.shape[1]
    k = _repeat_kv(k_cache, h // hkv)
    v = _repeat_kv(v_cache, h // hkv)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * (d ** -0.5)
    pos = torch.arange(smax, device=q.device)
    valid = pos[None, :] < torch.as_tensor(length, device=q.device).reshape(-1, 1)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# paged KV cache (block-table indirection, per-slot lengths)
# ---------------------------------------------------------------------------


def quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float [..., D] -> (int8 [..., D], float32 [...] per-row scale).

    The JAX source spells the scale ``max(absmax / 127.0, 1e-8)``; it runs
    only inside the jitted engine steps, where XLA multiplies by the float32
    reciprocal (C1), so the port computes ``absmax * float32(1/127)``, then
    the floor.  The division of the row by its scale stays IEEE."""
    rf = rows.float()
    absmax = rf.abs().amax(-1)
    scale = torch.clamp_min(absmax * INV127, 1e-8)
    q = torch.clamp(torch.round(rf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def pool_page_size(pages) -> int:
    return (pages[0] if isinstance(pages, tuple) else pages).shape[1]


def gather_paged_rows(pages, block_table: torch.Tensor) -> torch.Tensor:
    """Materialize each slot's contiguous view from ONE page pool.

    pages: [P, page, *row], or an int8 ``(data, scale)`` pool (the view
    comes back dequantized to float32); block_table: [B, pages_per_slot]
    page ids (0 = the reserved null page).  Returns [B, pages_per_slot *
    page, *row].
    """
    if isinstance(pages, tuple):
        data, scale = pages
        return dequantize_rows(gather_paged_rows(data, block_table),
                               gather_paged_rows(scale, block_table))
    b, pps = block_table.shape
    page = pages.shape[1]
    return pages[block_table.long()].reshape(b, pps * page, *pages.shape[2:])


def write_paged_rows(pages, rows: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor, active: torch.Tensor):
    """Scatter one new token's row per slot into its current page, in place.

    pages: [P, page, *row] or an int8 ``(data, scale)`` pool (rows quantize
    at this write); rows: [B, *row]; lengths: [B] write positions (= valid
    length before this token); active: [B] bool.  Inactive slots are
    redirected to the reserved null page 0 so their garbage never lands in
    a page owned by a live request.  A slot at capacity (only ever
    inactive) clamps its page index, as the JAX gather does.
    """
    page = pool_page_size(pages)
    b = rows.shape[0]
    lengths = lengths.long()
    pj = torch.clamp(lengths // page, max=block_table.shape[1] - 1)
    page_idx = block_table.long()[torch.arange(b, device=rows.device), pj]
    page_idx = torch.where(active, page_idx, torch.zeros_like(page_idx))
    return scatter_chunk_rows(pages, rows, page_idx, lengths % page)


def scatter_chunk_rows(pages, rows: torch.Tensor, pid: torch.Tensor,
                       off: torch.Tensor):
    """Write rows at explicit (page, offset) indices, in place (the
    chunked-prefill write path; int8 pools quantize here).  rows: [C,
    *row]; pid / off: [C]."""
    if isinstance(pages, tuple):
        data, scale = pages
        q, s = quantize_rows(rows)
        data[pid, off] = q
        scale[pid, off] = s
        return pages
    pages[pid, off] = rows.to(pages.dtype)
    return pages


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One-token attention against a paged cache.

    q: [B, H, D]; k/v_pages: [P, page, Hkv, D]; block_table: [B,
    pages_per_slot]; lengths: [B] valid tokens per slot (new token included).
    """
    return decode_attention(q, gather_paged_rows(k_pages, block_table),
                            gather_paged_rows(v_pages, block_table), lengths)


def paged_chunk_attention(q: torch.Tensor, k_pages, v_pages,
                          block_table: torch.Tensor,
                          q_positions: torch.Tensor) -> torch.Tensor:
    """Multi-query attention of one prefill chunk against a paged cache.

    q: [B, C, H, D] chunk queries; k/v_pages: [P, page, Hkv, D] or int8
    ``(data, scale)`` pools; block_table: [B, pages_per_slot]; q_positions:
    [B, C] cache positions of the queries.  Each query attends exactly the
    cache positions <= its own, every key read from the gathered block row,
    so a position's math does not depend on how the prompt was split into
    chunks.  The JAX float32 formula, formula for formula.
    """
    b, c, h, d = q.shape
    k = gather_paged_rows(k_pages, block_table)   # [B, Smax, Hkv, D]
    v = gather_paged_rows(v_pages, block_table)
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    s = torch.einsum("bchd,bshd->bhcs", q.float(), k.float()) * (d ** -0.5)
    key_pos = torch.arange(k.shape[1], device=q.device)
    mask = key_pos[None, None, None, :] <= q_positions[:, None, :, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhcs,bshd->bchd", p, v.float())
    return out.to(q.dtype)


def gather_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_ids: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole pages out of a layer-stacked pool (the flash tier's spill).

    k/v_pages: [L, P, page, Hkv, D]; page_ids: [n] int.  Returns new
    tensors [L, n, page, Hkv, D]; the pool is untouched."""
    ids = page_ids.to(device=k_pages.device, dtype=torch.long)
    return k_pages.index_select(1, ids), v_pages.index_select(1, ids)


def scatter_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                     page_ids: torch.Tensor, ks: torch.Tensor,
                     vs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole pages back into a layer-stacked pool (the tier's prefetch),
    in place: ks/vs [L, n, page, Hkv, D] land on ``page_ids`` [n], which
    must be distinct.  Returns the pools, which keep their storage."""
    ids = page_ids.to(device=k_pages.device, dtype=torch.long)
    k_pages.index_copy_(1, ids, ks.to(k_pages.device, k_pages.dtype))
    v_pages.index_copy_(1, ids, vs.to(v_pages.device, v_pages.dtype))
    return k_pages, v_pages
