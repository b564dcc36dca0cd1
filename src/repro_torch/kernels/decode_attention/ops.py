"""Wrappers of the paged GQA attention kernels.

``paged_decode_attention(q, k_pages, v_pages, block_table, lengths)`` (B1,
``csrc/decode_attention.cu``): one query token per (slot, head) against one
layer's page pools through the block table, split-KV over splits of
``ref.SPLIT`` keys at absolute positions, the splits' float32 partials in a
workspace allocated here, merged in split-index order by a second kernel
that the same C entry launches.  It takes query groups (``H / Hkv``) of up
to ``MAX_GROUP`` heads: above 8 the kernel runs the group-of-8 arithmetic
in two passes, so a head's bits do not depend on its group.

``paged_chunk_attention(q, k_pages, v_pages, block_row, start, n_valid)``
(``csrc/paged_chunk_attention.cu``): the queries of one slot's prefill
chunk, query i at cache position ``start + i``, each attending the keys up
to its own position.  The kernel runs B3's per-block arithmetic
(``csrc/attention_tile.cuh``) on 64-row query tiles at absolute multiples
of 64, the K/V blocks read through the block row, so over bf16 pools a
chunk query's output is B3's one-shot bits for that query.  It maps each
query head to its kv head on its own and takes any group that
``H % Hkv == 0`` allows.

``decode_attention(q, k_cache, v_cache, lengths)``: B1 over a contiguous
cache ``[B, Smax, Hkv, D]`` (the wave engine's, and whisper's encoder rows
for cross-attention), read as a pool of B pages of Smax rows through the
block table ``[[0], [1], ..., [B - 1]]``: no copy, and B1's splits at
absolute key positions give a row the bits it has in any batch.  The
table is made once per (B, device) and kept, so a captured decode graph
reads one address.

A pool is a bf16 tensor ``[P, page, Hkv, D]`` or an int8 ``(data, scale)``
pair (``models.attention``).  A CPU tensor takes the plain version
(``models.attention``); a CUDA tensor launches the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    SPLIT, decode_attention_ref, paged_chunk_attention_ref,
    paged_decode_attention_ref)

HEAD_DIMS = (16, 32, 64, 112, 128)  # 112: zamba2-7b's shared block
MAX_GROUP = 16  # grouped query heads per kv head, B1 (two passes of 8)
CHUNK_BLOCK = 64  # keys per K/V block and rows per query tile, chunk kernel
LAUNCHES = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0,
            "paged_chunk_attention": 0, "paged_chunk_attention_int8": 0}


def _check_pools(q: torch.Tensor, k_pages, v_pages, name: str,
                 max_group: int | None = None):
    """(k, v, k_scale, v_scale, int8) of bf16 or int8 ``(data, scale)``
    pools on q's device, or raise; ``max_group``: the most query heads a
    kv head may have (None: any)."""
    int8 = isinstance(k_pages, tuple)
    if int8 != isinstance(v_pages, tuple):
        raise TypeError(f"{name}: K and V pools of different kinds")
    k, ks = k_pages if int8 else (k_pages, None)
    v, vs = v_pages if int8 else (v_pages, None)
    want = torch.int8 if int8 else torch.bfloat16
    tensors = [("q", q, torch.bfloat16), ("k_pages", k, want),
               ("v_pages", v, want)]
    if int8:
        tensors += [("k_scale", ks, torch.float32),
                    ("v_scale", vs, torch.float32)]
    for tname, t, dtype in tensors:
        if t.dtype != dtype or t.device != q.device:
            raise TypeError(f"{name}: {tname} must be {dtype} on {q.device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if v.shape != k.shape or k.shape[-1] != q.shape[-1] or k.dim() != 4:
        raise ValueError(f"{name}: pool shapes {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if int8 and (ks.shape != k.shape[:-1] or vs.shape != k.shape[:-1]):
        raise ValueError(f"{name}: scale pools {tuple(ks.shape)} / "
                         f"{tuple(vs.shape)} do not match {tuple(k.shape)}")
    h, d, hkv = q.shape[-2], q.shape[-1], k.shape[2]
    if d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"{name}: unsupported head layout H={h} Hkv={hkv} "
                         f"D={d}")
    if max_group is not None and h // hkv > max_group:
        raise ValueError(f"{name}: a query group of {h // hkv} heads (H={h} "
                         f"Hkv={hkv}); B1 takes at most {max_group}")
    return k, v, ks, vs, int8


def _check_int32(q: torch.Tensor, name: str, **tensors) -> None:
    for tname, t in tensors.items():
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise TypeError(f"{name}: {tname} must be contiguous int32 on "
                            f"{q.device}")


def paged_decode_attention(q: torch.Tensor, k_pages, v_pages,
                           block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k/v_pages: bf16 [P, page, Hkv, D] or int8 (data,
    scale) pools; block_table: [B, pps] int32; lengths: [B] int32 valid
    tokens per slot -> [B, H, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_table,
                                          lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: tensor on {q.device}")
    k, v, ks, vs, int8 = _check_pools(q, k_pages, v_pages,
                                      "paged_decode_attention", MAX_GROUP)
    _check_int32(q, "paged_decode_attention", block_table=block_table,
                 lengths=lengths)
    b, h, d = q.shape
    _, page, hkv, _ = k.shape
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
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
        block_table.data_ptr(), lengths.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, h, hkv, d, page, pps, n_split, int(int8),
        float(d ** -0.5), build.stream_handle(q.device))
    name = "paged_decode_attention_int8" if int8 else "paged_decode_attention"
    build.check(status, name)
    LAUNCHES[name] += 1
    return out


# (batch, device) -> the block table [[0], ..., [B - 1]] of a contiguous
# cache read as B pages
_CONTIGUOUS_TABLES: dict[tuple[int, torch.device], torch.Tensor] = {}


def contiguous_block_table(b: int, device: torch.device) -> torch.Tensor:
    """int32 [B, 1]: row b of a contiguous cache is page b."""
    key = (b, device)
    if key not in _CONTIGUOUS_TABLES:
        _CONTIGUOUS_TABLES[key] = torch.arange(
            b, dtype=torch.int32, device=device).reshape(b, 1)
    return _CONTIGUOUS_TABLES[key]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k/v_cache: bf16 [B, Smax, Hkv, D] contiguous (one
    layer of the wave cache, or the encoder's K/V); lengths: [B] int32
    valid rows per slot, the new row included -> [B, H, D].  On the CPU the
    plain ``models.attention.decode_attention``; on CUDA B1, the cache a
    pool of B pages of Smax rows (its launches count as
    ``paged_decode_attention``)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} "
                         f"/ {tuple(v_cache.shape)} for q {tuple(q.shape)}")
    block = contiguous_block_table(q.shape[0], q.device)
    return paged_decode_attention(q, k_cache, v_cache, block, lengths)


def paged_chunk_attention(q: torch.Tensor, k_pages, v_pages,
                          block_row: torch.Tensor, start: int,
                          n_valid: int) -> torch.Tensor:
    """q: [C, H, D] a slot's chunk queries at cache positions start ..
    start + C - 1, of which the first ``n_valid`` are the chunk's (the rest
    bucket padding); k/v_pages: bf16 or int8 (data, scale) pools whose page
    size divides 64; block_row: [pps] int32 the slot's page ids -> [C, H,
    D].  Rows past ``n_valid`` are discarded by the caller: the plain
    version computes them as the JAX formula does, the kernel writes 0."""
    c = q.shape[0]
    if q.device.type == "cpu":
        pos = start + torch.arange(c, device=q.device)
        return paged_chunk_attention_ref(q[None], k_pages, v_pages,
                                         block_row[None], pos[None])[0]
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: tensor on {q.device}")
    k, v, ks, vs, int8 = _check_pools(q, k_pages, v_pages,
                                      "paged_chunk_attention")
    _check_int32(q, "paged_chunk_attention", block_row=block_row)
    _, h, d = q.shape
    _, page, hkv, _ = k.shape
    pps = block_row.shape[0]
    if block_row.dim() != 1 or not 0 < n_valid <= c or start < 0 \
            or start + n_valid > pps * page:
        raise ValueError(f"paged_chunk_attention: block_row "
                         f"{tuple(block_row.shape)}, n_valid {n_valid} of "
                         f"{c} rows, start {start}, page {page}")
    if CHUNK_BLOCK % page:
        raise ValueError(f"paged_chunk_attention: page size {page} does not "
                         f"divide the kernel's {CHUNK_BLOCK}-key blocks")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("paged_chunk_attention: q and the pools must start "
                         "on a 16-byte boundary")
    out = torch.empty_like(q)
    status = build.library().repro_paged_chunk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
        block_row.data_ptr(), out.data_ptr(), c, n_valid, start, h, hkv, d,
        page, pps, int(int8), float(d ** -0.5),
        build.stream_handle(q.device))
    name = "paged_chunk_attention_int8" if int8 else "paged_chunk_attention"
    build.check(status, name)
    LAUNCHES[name] += 1
    return out
