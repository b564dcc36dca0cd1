"""Plain PyTorch version of the paged MLA decode attention: the attention
part of ``repro.models.blocks._mla_absorbed_attend``, formula for formula
(the CPU path and the kernel's oracle on the card).

``mla_decode_attention_splitkv`` rehearses, in plain PyTorch, the CUDA
kernel's schedule and arithmetic (``csrc/mla_decode_attention.cu``): each
slot's keys cut into splits of ``SPLIT`` keys at absolute positions from
key 0; per split the scores from the query's three bf16 terms
(:func:`bf16_terms`) against the rows as bf16 (an int8 pool's codes, its
row scales applied to the products), the latent and rope sums kept apart,
added, then scaled; a float32 softmax partial (max, sum, unnormalised
context), the context from the three bf16 terms of the weights (an int8
pool's row scales folded in first); the partials merged in split-index
order.  A slot's result depends on its own length, queries and pages only.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, gather_paged_rows

SPLIT = 64  # keys per split: the kernel's kSplit


def mla_decode_attention_ref(q_c: torch.Tensor, q_rope: torch.Tensor,
                             ckv_pages, krope_pages,
                             block_table: torch.Tensor,
                             lengths: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """ctx float32 [B, H, R] of the absorbed query against each slot's
    compressed rows:

      s   = (q_c . ckv + q_rope . krope) * scale   over the gathered row
      s   = -1e30 at keys >= lengths[b]
      ctx = softmax(s) @ ckv

    q_c: float32 [B, H, R]; q_rope: [B, H, Dr] (taken in float32);
    ckv_pages / krope_pages: [P, page, R] / [P, page, Dr] bf16 or float
    pools, or int8 ``(data, scale)`` pools (dequantized as JAX gathers
    them); block_table: [B, pps]; lengths: [B] valid keys, the new one
    included.  A length-0 slot gives the uniform mean, as JAX's does."""
    ckv = gather_paged_rows(ckv_pages, block_table).float()    # [B, S, R]
    krope = gather_paged_rows(krope_pages, block_table).float()
    scores = (torch.einsum("bhr,bsr->bhs", q_c.float(), ckv)
              + torch.einsum("bhd,bsd->bhs", q_rope.float(), krope))
    scores = scores * scale
    smax = ckv.shape[1]
    valid = torch.arange(smax, device=ckv.device)[None, :] \
        < lengths.to(ckv.device).reshape(-1, 1)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, ckv)


def bf16_terms(x: torch.Tensor, n: int = 3) -> list[torch.Tensor]:
    """``x`` (taken in float32) as ``n`` float32 tensors of bf16 values, as
    the kernel's ``split3_bf16x2`` cuts it: term i is the top 8 significant
    bits of what the terms before it leave (the high half of its float32
    bits, so each remainder is exact); three sum back to ``x`` exactly
    wherever |x| >= 2^-110 (below it, to within 2^-133)."""
    rest = x.float().contiguous()
    terms = []
    for _ in range(n):
        t = (rest.view(torch.int32) & -65536).view(torch.float32)
        terms.append(t)
        rest = rest - t
    return terms


def _rows_and_scales(pool, block_table: torch.Tensor):
    """(rows as the kernel stages them, float32, and the row scales, or
    None): bf16 rows as they are, an int8 pool's codes (exact in bf16)."""
    if isinstance(pool, tuple):
        data, scale = pool
        return (gather_paged_rows(data, block_table).float(),
                gather_paged_rows(scale, block_table).float())
    return gather_paged_rows(pool, block_table).float(), None


def _term_products(terms: list[torch.Tensor], rows: torch.Tensor):
    """sum_t terms[t] @ rows in float32, the terms' products added in
    order: ((t0 @ rows + t1 @ rows) + t2 @ rows)."""
    out = terms[0] @ rows
    for t in terms[1:]:
        out = out + t @ rows
    return out


def mla_decode_attention_splitkv(q_c: torch.Tensor, q_rope: torch.Tensor,
                                 ckv_pages, krope_pages,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor, scale: float,
                                 split: int = SPLIT) -> torch.Tensor:
    """The kernel's schedule and arithmetic in float32: per slot, splits
    of ``split`` keys at absolute positions; per split the latent and rope
    scores from the query's three bf16 terms (int8: times the row scales
    after the products), added, then scaled; a partial (m, l, acc) with
    acc from the three bf16 terms of P' = p (times the ckv row scales for
    int8) against the rows; the partials merged in split order.  A
    length-0 slot gives 0, as the kernel does."""
    b, h, r = q_c.shape
    cap = block_table.shape[1] * (ckv_pages[0] if isinstance(
        ckv_pages, tuple) else ckv_pages).shape[1]
    out = torch.zeros((b, h, r), dtype=torch.float32, device=q_c.device)
    for i in range(b):
        n = min(int(lengths[i]), cap)
        ckv, cs = _rows_and_scales(ckv_pages, block_table[i:i + 1])
        krope, ks = _rows_and_scales(krope_pages, block_table[i:i + 1])
        ckv, krope = ckv[0], krope[0]
        qc_t, qr_t = bf16_terms(q_c[i]), bf16_terms(q_rope[i])
        parts = []
        for t0 in range(0, n, split):
            rows = slice(t0, min(t0 + split, n))
            lat = _term_products(qc_t, ckv[rows].T)          # [H, n]
            rope = _term_products(qr_t, krope[rows].T)
            if cs is not None:
                lat = lat * cs[0, rows]
                rope = rope * ks[0, rows]
            s = (lat + rope) * scale
            m = s.amax(-1)
            p = torch.exp(s - m[:, None])
            pw = p * cs[0, rows] if cs is not None else p
            parts.append((m, p.sum(-1), _term_products(bf16_terms(pw),
                                                       ckv[rows])))
        if not parts:
            continue
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_sum = torch.zeros_like(m_all)
        acc = torch.zeros((h, r), dtype=torch.float32, device=q_c.device)
        for m, l, a in parts:  # split-index order
            w = torch.exp(m - m_all)
            l_sum = l_sum + l * w
            acc = acc + a * w[:, None]
        out[i] = acc / torch.clamp_min(l_sum, 1e-20)[:, None]
    return out
