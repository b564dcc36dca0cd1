"""Wrapper of the W8A8 integer product kernel (``csrc/int8_gemm.cu``).

``int8_gemm(x_q, w_q)`` computes ``int32[M, N] = x_q[M, K] . w_q[N, K]^T``.
A CPU tensor takes the plain version (``ref.int8_gemm_ref``); a CUDA tensor
launches the kernel: the weight-streaming GeMV variant for M <= 8 (decode),
the tiled variant otherwise (prefill).  ``LAUNCHES`` counts each variant's
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_pagegemv.ref import int8_gemm_ref

GEMV_MAX_M = 8
LAUNCHES = {"int8_gemv": 0, "int8_gemm": 0}


def int8_gemm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    if x_q.device.type == "cpu":
        return int8_gemm_ref(x_q, w_q)
    if x_q.device.type != "cuda" or w_q.device != x_q.device:
        raise ValueError(f"int8_gemm: operands on {x_q.device} and {w_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 operands, got {x_q.dtype}, "
                        f"{w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_gemm shapes {tuple(x_q.shape)} . "
                         f"{tuple(w_q.shape)}^T do not contract")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("int8_gemm takes contiguous operands")
    m, k = x_q.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    vec = int(k % 16 == 0 and x_q.data_ptr() % 16 == 0
              and w_q.data_ptr() % 16 == 0)
    lib = build.library()
    stream = build.stream_handle(x_q.device)
    if m <= GEMV_MAX_M:
        name = "int8_gemv"
        status = lib.repro_int8_gemv(x_q.data_ptr(), w_q.data_ptr(),
                                     out.data_ptr(), m, n, k, vec, stream)
    else:
        name = "int8_gemm"
        status = lib.repro_int8_gemm(x_q.data_ptr(), w_q.data_ptr(),
                                     out.data_ptr(), m, n, k, vec, stream)
    build.check(status, name)
    LAUNCHES[name] += 1
    return out
