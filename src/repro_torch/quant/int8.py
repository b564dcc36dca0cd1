"""W8A8 symmetric quantization (the paper's default), counterpart of
``repro.quant.int8``.

Per-output-channel weight scales; per-column (per-token) dynamic activation
scales.  Each formula is the one its JAX caller actually runs:
``quantize_weight`` runs eagerly there and divides by 127.0;
``quantize_activation`` spells out the float32 reciprocal, as XLA turns a
constant division into under ``jit``.  Products accumulate exactly in int32
and dequantize at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# float32(1/127) as a Python float: the product of two float32 values is
# exact in double, so ``t * INV127`` rounds once to float32 whichever
# precision the multiply runs in, giving float32's ``t * f32(1/127)``
INV127 = float(np.float32(1.0 / 127.0))


class QuantizedLinear(NamedTuple):
    w_q: torch.Tensor    # int8 [h, w]
    scale: torch.Tensor  # f32 [h] per output channel


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """w: [h, w] float -> int8 with a per-row symmetric scale."""
    wf = w.float()
    absmax = wf.abs().amax(1, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-8)
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedLinear(w_q=w_q, scale=scale[:, 0].float())


def quantize_activation(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [w] or [w, b] float -> (int8 codes, per-column f32 scale); a 1-D
    input gets a scalar scale, a batched one a scale per column b (absmax
    over the contraction axis 0)."""
    xf = x.float()
    absmax = xf.abs().amax() if xf.dim() <= 1 else xf.abs().amax(0)
    scale = torch.clamp_min(absmax * INV127, 1e-8)
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def dequantize(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return w_q.float() * scale[:, None]


def int8_matvec(q: QuantizedLinear, x: torch.Tensor) -> torch.Tensor:
    """W8A8 GeMV: int8 x int8 -> exact int32 sums -> f32 dequant (the plain
    product; ``kernels.int8_pagegemv.ops.paged_int8_gemv`` is the kernel
    path)."""
    from repro_torch.kernels.int8_pagegemv.ref import paged_int8_gemm_ref

    x_q, x_scale = quantize_activation(x)
    x2 = x_q if x_q.dim() == 2 else x_q[:, None]
    acc = paged_int8_gemm_ref(q.w_q, x2).float()
    if x.dim() <= 1:
        return acc[:, 0] * q.scale * x_scale
    return acc * q.scale[:, None] * x_scale[None, :]
