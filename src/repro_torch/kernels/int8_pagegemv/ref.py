"""Plain PyTorch versions of the W8A8 integer product (the kernel's oracle)
and of the paged GeMV front end."""

from __future__ import annotations

import torch


def int8_gemm_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int32[M, N] = int8[M, K] @ int8[N, K]^T, exact.

    Computed in float64, which every device's matmul supports: each product
    is at most 127*127 and every partial sum is an integer below 2^53, so
    the result is exact in any summation order.
    """
    return (x_q.to(torch.float64) @ w_q.to(torch.float64).T).to(torch.int32)


def paged_int8_gemm_ref(w_q: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """int32[h, b] = int8[h, w] @ int8[w, b] (exact integer reference)."""
    return int8_gemm_ref(x_q.T, w_q).T


def paged_int8_gemv_ref(w_q: torch.Tensor, scale: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """The full W8A8 path: quantize activations per column, exact int
    product, dequantize by ``scale[h] (x) x_scale[b]``.  x: [w] or [w, b]
    float; returns f32 [h] or [h, b]."""
    from repro_torch.quant.int8 import quantize_activation

    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    x_q, x_scale = quantize_activation(x)
    acc = paged_int8_gemm_ref(w_q, x_q).float()
    y = acc * scale[:, None] * x_scale[None, :]
    return y[:, 0] if squeeze else y
