"""Oracles: models/attention holds the plain PyTorch references.

``paged_decode_attention_splitkv`` rehearses, in plain PyTorch, the CUDA
kernel's schedule (``csrc/decode_attention.cu``): each slot's keys cut into
splits of ``SPLIT`` keys at absolute positions from key 0, a float32
softmax partial (max, sum, unnormalised output) per split, and the partials
merged in split-index order.  Each slot is computed on its own, so its bits
depend on its own length, query and pages only.  The oracle stays the
one-shot softmax of ``paged_decode_attention_ref``; the chunk kernel's is
``paged_chunk_attention_ref``, the JAX float32 formula.  Both take bf16
pools or int8 ``(data, scale)`` pools.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import (  # noqa: F401
    decode_attention as decode_attention_ref,
    paged_chunk_attention as paged_chunk_attention_ref,
    paged_decode_attention as paged_decode_attention_ref,
)

SPLIT = 64  # keys per split: the kernel's kSplit


def paged_decode_attention_splitkv(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_table: torch.Tensor,
                                   lengths: torch.Tensor,
                                   split: int = SPLIT) -> torch.Tensor:
    """q: [B, H, D]; k/v_pages: [P, page, Hkv, D]; block_table: [B, pps];
    lengths: [B] -> [B, H, D] in q's dtype.  A length-0 slot gives 0."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    n_rep = h // hkv
    cap = block_table.shape[1] * page
    scale = d ** -0.5
    k_rows = k_pages.reshape(-1, hkv, d)
    v_rows = v_pages.reshape(-1, hkv, d)
    out = torch.zeros_like(q)
    for i in range(b):
        n = min(int(lengths[i]), cap)
        qf = q[i].float().reshape(hkv, n_rep, d)
        parts = []
        for t0 in range(0, n, split):
            t = torch.arange(t0, min(t0 + split, n), device=q.device)
            rows = block_table[i, t // page].long() * page + t % page
            k, v = k_rows[rows].float(), v_rows[rows].float()  # [n, Hkv, D]
            s = torch.einsum("grd,ngd->grn", qf, k) * scale
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("grn,ngd->grd", p, v)))
        if not parts:
            continue
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_sum = torch.zeros_like(m_all)
        acc = torch.zeros_like(qf)
        for m, l, a in parts:  # split-index order
            w = torch.exp(m - m_all)
            l_sum = l_sum + l * w
            acc = acc + a * w[..., None]
        out[i] = (acc / torch.clamp_min(l_sum, 1e-20)[..., None]).reshape(
            h, d).to(q.dtype)
    return out
