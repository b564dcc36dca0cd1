"""Wrapper of the W8A8 integer product kernel (``csrc/int8_gemm.cu``).

``int8_gemm(x_q, w_q)`` computes ``int32[M, N] = x_q[M, K] . w_q[N, K]^T``.
A CPU tensor takes the plain version (``ref.int8_gemm_ref``); a CUDA tensor
launches the kernel variant :func:`gemm_variant` picks from the shape and
the operands' alignment alone.  Where K is a multiple of 16 and both bases
are 16-byte aligned (every model shape): the tensor-core GeMV (mma.sync,
weights streamed into registers) for M <= 8 (decode), the tensor-core GEMM
(wgmma fed by TMA) for M > 8 (prefill).  Otherwise the ``__dp4a`` GeMV for
M <= 8 and the ``__dp4a`` tiled GEMM above.  A launch that fails raises; no
other variant is tried.  ``LAUNCHES`` counts each variant's launches.

``paged_int8_gemv(w_q, scale, x)`` is the counterpart of the JAX front end
``repro.kernels.int8_pagegemv.ops.paged_int8_gemv``: x is ``[w]`` or
``[w, b]``, quantized per column, multiplied by the kernel above and
dequantized by ``scale[h] (x) x_scale[b]``.  The Pallas kernel's page
tiling (``tile_h`` / ``tile_w``) only shapes the TPU grid; the sums are
exact integers either way, so the port takes no tile arguments.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_pagegemv.ref import int8_gemm_ref
from repro_torch.quant.int8 import quantize_activation

GEMV_MAX_M = 8
LAUNCHES = {"int8_gemv": 0, "int8_gemv_dp4a": 0, "int8_gemm": 0,
            "int8_gemm_tc": 0}


def gemm_variant(m: int, k: int, x_ptr: int, w_ptr: int) -> str:
    """The kernel variant for an [m, k] . [n, k]^T product whose operands
    start at device addresses ``x_ptr`` and ``w_ptr``.  Where every row of
    both operands starts on a 16-byte boundary (k a multiple of 16, aligned
    bases: the GeMV's 16-byte loads and the TMA tensor maps need it),
    ``int8_gemv`` for m <= 8 and ``int8_gemm_tc`` above; otherwise
    ``int8_gemv_dp4a`` and ``int8_gemm``."""
    aligned = k % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0
    if m <= GEMV_MAX_M:
        return "int8_gemv" if aligned else "int8_gemv_dp4a"
    return "int8_gemm_tc" if aligned else "int8_gemm"


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
    xp, wp = x_q.data_ptr(), w_q.data_ptr()
    lib = build.library()
    stream = build.stream_handle(x_q.device)
    name = gemm_variant(m, k, xp, wp)
    status = getattr(lib, "repro_" + name)(xp, wp, out.data_ptr(), m, n, k,
                                           stream)
    build.check(status, name)
    LAUNCHES[name] += 1
    return out


def paged_int8_gemm(w_q: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """int32[h, b] = int8[h, w] @ int8[w, b], through ``int8_gemm``."""
    return int8_gemm(x_q.T.contiguous(), w_q).T


def paged_int8_gemv(w_q: torch.Tensor, scale: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """W8A8 GeMV/GeMM: w_q int8 [h, w], scale f32 [h], x float [w] or
    [w, b] -> f32 [h] or [h, b]."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    x_q, x_scale = quantize_activation(x)
    acc = paged_int8_gemm(w_q, x_q).float()
    y = acc * scale[:, None] * x_scale[None, :]
    return y[:, 0] if squeeze else y
