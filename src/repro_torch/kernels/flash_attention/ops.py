"""Wrapper of the causal prefill flash attention kernel
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v)`` with q ``[B, S, H, D]`` and k/v
``[B, S, Hkv, D]`` in the model's layout.  A CPU tensor takes the plain
version (``models.attention.chunked_attention(causal=True)``); a CUDA tensor
launches the kernel, which reads all three through their strides.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 112, 128)  # 112: zamba2-7b's shared block
LAUNCHES = {"flash_attention": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
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
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"unsupported head layout H={h} Hkv={hkv} D={d}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    status = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, hkv, d, strides, float(d ** -0.5),
        build.stream_handle(q.device))
    build.check(status, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
