"""W4A16 quantization (paper section VIII-B, Fig. 11): 4-bit weights packed
two to a byte with group-wise scales, 16-bit activations.  Counterpart of
``repro.quant.int4``; every function runs eagerly in JAX, and its formula
is carried over as written (true divisions, round half to even).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

GROUP = 128


class QuantizedLinear4(NamedTuple):
    w_packed: torch.Tensor  # uint8 [h, w // 2], two nibbles per byte
    scale: torch.Tensor     # f32 [h, ceil(w / g)], g = min(GROUP, w)
    h: int
    w: int


def pack_nibbles(w_q: torch.Tensor) -> torch.Tensor:
    """int4 values in int8 storage [-8, 7] -> uint8 pairs: the even column
    in the low nibble, the odd column in the high one, each plus 8."""
    u = (w_q.to(torch.int16) + 8).to(torch.uint8)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = ((packed >> 4) & 0xF).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)


def quantize_weight4(w: torch.Tensor, group: int = GROUP) -> QuantizedLinear4:
    """w: [h, w] float (w even) -> packed nibbles with one scale per group
    of g = min(group, w) columns; a ragged last group is zero-padded for
    its absmax, as the JAX version pads it."""
    h, width = w.shape
    if width % 2:
        raise ValueError(f"quantize_weight4 needs an even width, got {width}")
    g = min(group, width)
    ng = -(-width // g)
    wp = torch.nn.functional.pad(w.float(), (0, ng * g - width))
    wg = wp.reshape(h, ng, g)
    absmax = wg.abs().amax(2, keepdim=True)
    scale = torch.clamp_min(absmax / 7.0, 1e-8)
    w_q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int8)
    w_q = w_q.reshape(h, ng * g)[:, :width]
    return QuantizedLinear4(w_packed=pack_nibbles(w_q),
                            scale=scale[:, :, 0].float(), h=h, w=width)


def dequantize4(q: QuantizedLinear4, group: int = GROUP) -> torch.Tensor:
    """f32 [h, w] weights: each nibble times its group's scale."""
    w_q = unpack_nibbles(q.w_packed)[:, :q.w].float()
    g = min(group, q.w)
    ng = q.scale.shape[1]
    w_q = torch.nn.functional.pad(w_q, (0, ng * g - q.w)).reshape(q.h, ng, g)
    return (w_q * q.scale[:, :, None]).reshape(q.h, ng * g)[:, :q.w]


def int4_matvec(q: QuantizedLinear4, x: torch.Tensor) -> torch.Tensor:
    """W4A16 GeMV, plain: dequantize, then a float32 product; x is [w] or
    [w, b].  ``kernels.w4a16_gemv.ops.w4a16_gemv`` is the kernel path."""
    return dequantize4(q) @ x.float()
