"""Wrapper of the paged GQA decode attention kernel
(``csrc/decode_attention.cu``).

``paged_decode_attention(q, k_pages, v_pages, block_table, lengths)``: one
query token per (slot, head) against one layer's page pools through the
block table.  A CPU tensor takes the plain version
(``models.attention.paged_decode_attention``); a CUDA tensor launches the
kernel, which reads the block table itself: split-KV over splits of
``ref.SPLIT`` keys at absolute positions, the splits' float32 partials in
a workspace allocated here, merged in split-index order by a second kernel
that the same C entry launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    SPLIT, paged_decode_attention_ref)

HEAD_DIMS = (16, 32, 64, 112, 128)  # 112: zamba2-7b's shared block
MAX_GROUP = 8  # grouped query heads per kv head
LAUNCHES = {"paged_decode_attention": 0}


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k/v_pages: [P, page, Hkv, D]; block_table: [B, pps]
    int32; lengths: [B] int32 valid tokens per slot -> [B, H, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_table,
                                          lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: tensor on {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"{name} must be bf16 on {q.device}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32 on {q.device}")
    b, h, d = q.shape
    _, page, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"unsupported head layout H={h} Hkv={hkv} D={d}")
    if block_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("block_table / lengths do not match the batch")
    out = torch.empty_like(q)
    if b == 0:
        return out
    pps = block_table.shape[1]
    n_split = -(-pps * page // SPLIT)
    ws = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    status = build.library().repro_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, h, hkv, d, page, pps, n_split, float(d ** -0.5),
        build.stream_handle(q.device))
    build.check(status, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out
