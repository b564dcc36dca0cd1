"""Plain PyTorch version of the W8A8 integer product (the kernel's oracle)."""

from __future__ import annotations

import torch


def int8_gemm_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int32[M, N] = int8[M, K] @ int8[N, K]^T, exact.

    Computed in float64, which every device's matmul supports: each product
    is at most 127*127 and every partial sum is an integer below 2^53, so
    the result is exact in any summation order.
    """
    return (x_q.to(torch.float64) @ w_q.to(torch.float64).T).to(torch.int32)
