"""Plain PyTorch versions of the W4A16 product (the kernel's oracle):
``quant.int4``'s dequantize, then a float32 matmul, as the JAX reference
``repro.kernels.w4a16_gemv.ref.w4a16_gemv_ref`` computes it."""

from __future__ import annotations

import torch

from repro_torch.quant.int4 import QuantizedLinear4, dequantize4


def w4a16_gemm_ref(x: torch.Tensor, w_p4: torch.Tensor,
                   scale4: torch.Tensor) -> torch.Tensor:
    """f32[M, N] = x[M, K] . dequant(w_p4 [N, K/2], scale4)^T."""
    n, kb = w_p4.shape
    q = QuantizedLinear4(w_packed=w_p4, scale=scale4, h=n, w=2 * kb)
    return x.float() @ dequantize4(q).T


def w4a16_gemv_ref(q: QuantizedLinear4, x: torch.Tensor) -> torch.Tensor:
    """x: [w] or [w, b] -> f32 [h] or [h, b]."""
    return dequantize4(q) @ x.float()
