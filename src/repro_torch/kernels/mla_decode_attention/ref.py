"""Plain PyTorch version of the paged MLA decode attention: the attention
part of ``repro.models.blocks._mla_absorbed_attend``, formula for formula
(the CPU path and the kernel's oracle on the card).

``mla_decode_attention_splitkv`` rehearses, in plain PyTorch, the CUDA
kernel's schedule (``csrc/mla_decode_attention.cu``): each slot's keys
cut into splits of ``SPLIT`` keys at absolute positions from key 0, a
float32 softmax partial (max, sum, unnormalised context) per split, the
partials merged in split-index order.  A slot's result depends on its own
length, queries and pages only.
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


def mla_decode_attention_splitkv(q_c: torch.Tensor, q_rope: torch.Tensor,
                                 ckv_pages, krope_pages,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor, scale: float,
                                 split: int = SPLIT) -> torch.Tensor:
    """The kernel's schedule in float32: per slot, splits of ``split`` keys
    at absolute positions, a partial (m, l, acc) each, merged in split
    order.  A length-0 slot gives 0, as the kernel does."""
    b, h, r = q_c.shape
    cap = block_table.shape[1] * (ckv_pages[0] if isinstance(
        ckv_pages, tuple) else ckv_pages).shape[1]
    out = torch.zeros((b, h, r), dtype=torch.float32, device=q_c.device)
    for i in range(b):
        n = min(int(lengths[i]), cap)
        ckv = gather_paged_rows(ckv_pages, block_table[i:i + 1])[0].float()
        krope = gather_paged_rows(krope_pages,
                                  block_table[i:i + 1])[0].float()
        parts = []
        for t0 in range(0, n, split):
            rows = slice(t0, min(t0 + split, n))
            s = (q_c[i].float() @ ckv[rows].T
                 + q_rope[i].float() @ krope[rows].T) * scale   # [H, n]
            m = s.amax(-1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(-1), p @ ckv[rows]))
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
