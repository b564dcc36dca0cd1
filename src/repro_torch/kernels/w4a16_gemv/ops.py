"""Wrapper of the W4A16 product kernels (``csrc/w4a16_gemv.cu``, B4).

``w4a16_gemm(x, w_p4, scale4)`` computes ``f32[M, N] = x[M, K] .
dequant(w_p4 [N, K/2], scale4 [N, ceil(K/g)])^T`` with g = min(128, K):
the low nibble of byte j is column 2j, the high nibble column 2j+1, each
stored plus 8.  x is bf16 or float32 and is read as it is (bf16 -> float32
is exact, so the function does not depend on which).  A CPU tensor takes
the plain version (``ref.w4a16_gemm_ref``); a CUDA tensor launches a
kernel or raises: the tensor-core GeMV (``w4a16_gemv``) for M <= 8
(decode), the tensor-core tiled GEMM (``w4a16_gemm``) above.
``LAUNCHES`` counts the launches of each.

``w4a16_gemv(q, x)`` is the counterpart of the JAX front end
``repro.kernels.w4a16_gemv.ops.w4a16_gemv``: x ``[w]`` or ``[w, b]`` ->
f32 ``[h]`` or ``[h, b]``.  The Pallas tiling (``tile_h`` / ``tile_w``)
only shapes the TPU grid, so the port takes no tile arguments.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref
from repro_torch.quant.int4 import GROUP, QuantizedLinear4

GEMV_MAX_M = 8
X_DTYPES = (torch.bfloat16, torch.float32)
LAUNCHES = {"w4a16_gemv": 0, "w4a16_gemm": 0}


def variant(m: int) -> str:
    """The kernel a CUDA product of ``m`` rows launches."""
    return "w4a16_gemv" if m <= GEMV_MAX_M else "w4a16_gemm"


def w4a16_gemm(x: torch.Tensor, w_p4: torch.Tensor,
               scale4: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return w4a16_gemm_ref(x, w_p4, scale4)
    if x.device.type != "cuda" or w_p4.device != x.device \
            or scale4.device != x.device:
        raise ValueError(f"w4a16_gemm: operands on {x.device}, "
                         f"{w_p4.device}, {scale4.device}")
    if x.dtype not in X_DTYPES or w_p4.dtype != torch.uint8 \
            or scale4.dtype != torch.float32:
        raise TypeError(f"w4a16_gemm takes bf16 or f32 x, uint8 w_p4, f32 "
                        f"scale4; got {x.dtype}, {w_p4.dtype}, "
                        f"{scale4.dtype}")
    if x.dim() != 2 or w_p4.dim() != 2 or x.shape[1] != 2 * w_p4.shape[1]:
        raise ValueError(f"w4a16_gemm shapes {tuple(x.shape)} . "
                         f"{tuple(w_p4.shape)} (packed)^T do not contract")
    m, k = x.shape
    n = w_p4.shape[0]
    g = min(GROUP, k)
    ng = -(-k // g)
    if tuple(scale4.shape) != (n, ng):
        raise ValueError(f"w4a16_gemm: scale4 {tuple(scale4.shape)}, "
                         f"expected {(n, ng)}")
    if not (x.is_contiguous() and w_p4.is_contiguous()
            and scale4.is_contiguous()):
        raise ValueError("w4a16_gemm takes contiguous operands")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    name = variant(m)
    vec = int(k % 32 == 0 and x.data_ptr() % 16 == 0
              and w_p4.data_ptr() % 16 == 0)
    entry = getattr(build.library(), f"repro_{name}")
    status = entry(x.data_ptr(), w_p4.data_ptr(), scale4.data_ptr(),
                   out.data_ptr(), m, n, k, g, ng,
                   int(x.dtype == torch.float32), vec,
                   build.stream_handle(x.device))
    build.check(status, name)
    LAUNCHES[name] += 1
    return out


def w4a16_gemv(q: QuantizedLinear4, x: torch.Tensor) -> torch.Tensor:
    """W4A16 GeMV/GeMM: x [w] or [w, b] float -> f32 [h] or [h, b]."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    xt = x.T if x.dtype in X_DTYPES else x.T.float()
    y = w4a16_gemm(xt.contiguous(), q.w_packed, q.scale).T
    return y[:, 0] if squeeze else y
