"""Wrapper of the paged MLA decode attention kernel
(``csrc/mla_decode_attention.cu``).

``mla_decode_attention(q_c, q_rope, ckv_pages, krope_pages, block_table,
lengths, scale)``: one decode token per slot of DeepSeek's multi-head
latent attention, the absorbed query ``q_c`` (the no-rope query times
``W_uk``, float32 [B, H, R]) and the roped query ``q_rope`` against the
slot's compressed rows ``ckv`` [R] and ``krope`` [Dr], read through the
block table; returns the value context ``softmax(s) @ ckv`` in float32
[B, H, R] (the caller applies ``W_uv`` and the output projection).  The
kernel is split-KV, splits of ``ref.SPLIT`` keys at absolute positions, a
float32 workspace allocated here, the splits merged in split-index order
by a second kernel that the same C entry launches; its grid spans the
block table's capacity, so a decode graph captures it.

``mla_decode_attention_contiguous``: the same over the wave engine's
contiguous ``[B, Smax, R]`` / ``[B, Smax, Dr]`` caches, read as a pool of
B pages of Smax rows through the table ``[[0], ..., [B - 1]]`` (no copy).

A pool is a bf16 tensor or an int8 ``(data, scale)`` pair
(``models.attention``).  A CPU tensor takes the plain version
(``ref.mla_decode_attention_ref``, JAX's formula); a CUDA tensor launches
the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import contiguous_block_table
from repro_torch.kernels.mla_decode_attention.ref import (
    SPLIT, mla_decode_attention_ref)

# (R, Dr) instances: deepseek-v2-lite-16b's and its reduced config's
SHAPES = ((512, 64), (32, 8))
MAX_HEADS = 16
LAUNCHES = {"mla_decode_attention": 0, "mla_decode_attention_int8": 0}


def _pool_parts(pool, want_rows: int, name: str, dev):
    """(data, scale or None) of one pool, checked."""
    data, scale = pool if isinstance(pool, tuple) else (pool, None)
    want = torch.int8 if scale is not None else torch.bfloat16
    if data.dtype != want or data.device != dev or not data.is_contiguous():
        raise TypeError(f"mla_decode_attention: {name} must be contiguous "
                        f"{want} on {dev}, got {data.dtype} on {data.device}")
    if data.dim() != 3 or data.shape[2] != want_rows:
        raise ValueError(f"mla_decode_attention: {name} {tuple(data.shape)} "
                         f"is not [P, page, {want_rows}]")
    if data.data_ptr() % 16:
        raise ValueError(f"mla_decode_attention: {name} must start on a "
                         f"16-byte boundary")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.device != dev
                              or scale.shape != data.shape[:2]
                              or not scale.is_contiguous()):
        raise TypeError(f"mla_decode_attention: {name}'s scales must be "
                        f"contiguous float32 {tuple(data.shape[:2])}")
    return data, scale


def mla_decode_attention(q_c: torch.Tensor, q_rope: torch.Tensor,
                         ckv_pages, krope_pages, block_table: torch.Tensor,
                         lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """q_c: float32 [B, H, R]; q_rope: float32 [B, H, Dr]; ckv/krope
    pools: bf16 [P, page, R] / [P, page, Dr] or int8 (data, scale) pairs;
    block_table: int32 [B, pps]; lengths: int32 [B] valid keys per slot
    -> float32 [B, H, R].  A length-0 slot comes out 0 on the card (the
    plain version gives JAX's uniform mean; callers ignore such lanes)."""
    if q_c.device.type == "cpu":
        return mla_decode_attention_ref(q_c, q_rope, ckv_pages, krope_pages,
                                        block_table, lengths, scale)
    if q_c.device.type != "cuda":
        raise ValueError(f"mla_decode_attention: tensor on {q_c.device}")
    b, h, r = q_c.shape
    dr = q_rope.shape[-1]
    for name, t in (("q_c", q_c), ("q_rope", q_rope)):
        if t.dtype != torch.float32 or t.device != q_c.device \
                or not t.is_contiguous() or t.dim() != 3:
            raise TypeError(f"mla_decode_attention: {name} must be a "
                            f"contiguous 3-d float32 tensor on {q_c.device}")
    if q_rope.shape[:2] != (b, h):
        raise ValueError(f"mla_decode_attention: q_rope "
                         f"{tuple(q_rope.shape)} for q_c {tuple(q_c.shape)}")
    if (r, dr) not in SHAPES or not 0 < h <= MAX_HEADS:
        raise ValueError(f"mla_decode_attention: unsupported H={h} R={r} "
                         f"Dr={dr} (instances {SHAPES}, H <= {MAX_HEADS})")
    if isinstance(ckv_pages, tuple) != isinstance(krope_pages, tuple):
        raise TypeError("mla_decode_attention: ckv and krope pools of "
                        "different kinds")
    ckv, ckv_s = _pool_parts(ckv_pages, r, "ckv_pages", q_c.device)
    kr, kr_s = _pool_parts(krope_pages, dr, "krope_pages", q_c.device)
    if kr.shape[:2] != ckv.shape[:2]:
        raise ValueError("mla_decode_attention: ckv and krope pools of "
                         "different page counts or sizes")
    for name, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.device != q_c.device \
                or not t.is_contiguous():
            raise TypeError(f"mla_decode_attention: {name} must be "
                            f"contiguous int32 on {q_c.device}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("mla_decode_attention: block_table / lengths do "
                         "not match the batch")
    out = torch.empty((b, h, r), dtype=torch.float32, device=q_c.device)
    if b == 0:
        return out
    int8 = ckv_s is not None
    page, pps = ckv.shape[1], block_table.shape[1]
    n_split = -(-pps * page // SPLIT)
    ws = torch.empty(b * n_split * h * (r + 2), dtype=torch.float32,
                     device=q_c.device)
    status = build.library().repro_mla_decode_attention(
        q_c.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
        ckv_s.data_ptr() if int8 else None, kr_s.data_ptr() if int8 else None,
        block_table.data_ptr(), lengths.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, h, r, dr, page, pps, n_split, int(int8),
        float(scale), build.stream_handle(q_c.device))
    name = "mla_decode_attention_int8" if int8 else "mla_decode_attention"
    build.check(status, name)
    LAUNCHES[name] += 1
    return out


def mla_decode_attention_contiguous(q_c: torch.Tensor, q_rope: torch.Tensor,
                                    ckv_cache: torch.Tensor,
                                    krope_cache: torch.Tensor,
                                    lengths: torch.Tensor,
                                    scale: float) -> torch.Tensor:
    """The wave cache's form: ckv/krope_cache [B, Smax, R] / [B, Smax, Dr]
    (one layer's, contiguous), lengths int32 [B] -> float32 [B, H, R]; on
    CUDA the kernel over the cache as B pages of Smax rows."""
    block = contiguous_block_table(q_c.shape[0], q_c.device)
    return mla_decode_attention(q_c, q_rope, ckv_cache, krope_cache, block,
                                lengths, scale)
