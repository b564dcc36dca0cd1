"""Wrapper of the prefill flash attention kernel
(``csrc/flash_attention.cu``), causal or bidirectional.

``flash_attention(q, k, v, causal=True)`` with q ``[B, S, H, D]`` and k/v
``[B, Skv, Hkv, D]`` in the model's layout: causal, Skv == S (prefill
self-attention); bidirectional, any Skv (the whisper encoder's
self-attention and its decoder's cross-attention over the encoder's rows).
A CPU tensor takes the plain version
(``models.attention.chunked_attention(causal)``); a CUDA tensor launches
the kernel (wgmma fed by TMA), which reads all three through their
strides, within TMA's rules: the last axis contiguous, the other strides
multiples of 8 elements, 16-byte aligned bases.  The two modes count their
launches apart: ``flash_attention`` and ``flash_attention_bidir``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# head dims beside every multiple of 8 up to 64 (deepseek-v2-lite-16b's
# reduced qk head of 24 among them): 112 zamba2-7b's shared block, 192
# deepseek-v2-lite-16b's MLA prefill (qk 128 + 64, v padded to it)
HEAD_DIMS = (112, 128, 192)


def head_dim_ok(d: int) -> bool:
    if 0 < d <= 64:
        return d % 8 == 0
    return d in HEAD_DIMS
LAUNCHES = {"flash_attention": 0, "flash_attention_bidir": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensor on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device or t.dim() != 4:
            raise TypeError(f"{name} must be a 4-d bf16 tensor on {q.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: last axis must be contiguous and the "
                             f"other strides multiples of 8, got {t.stride()}")
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape \
            or (causal and skv != s):
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (causal={causal})")
    if not head_dim_ok(d) or h % hkv:
        raise ValueError(f"unsupported head layout H={h} Hkv={hkv} D={d}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention: no keys to attend")
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    name = "flash_attention" if causal else "flash_attention_bidir"
    status = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, skv, h, hkv, d, strides, float(d ** -0.5), int(causal),
        build.stream_handle(q.device))
    build.check(status, name)
    LAUNCHES[name] += 1
    return out
