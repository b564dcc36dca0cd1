"""Hybrid NPU+flash GeMV (paper C1), counterpart of
``repro.core.hybrid_gemv``.

A weight matrix is split by the section V plan into a *flash region*
(``flash_rows`` rows, computed in-flash by the compute cores behind the
outlier-ECC decode) and an *NPU region* (the remaining rows, whose weights
stream over the channel).  Both regions compute the same W8A8 product.

On the card, the B5 kernel (``kernels.ecc_decode``) decodes the flash
region's pages and the B2 kernel, through ``paged_int8_gemv``, multiplies
both regions (JAX runs the plain int8 product for the NPU rows; the
function is the same).  ``use_kernel=False`` takes the plain PyTorch
versions on any device; on CPU tensors the wrappers take them anyway.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import ecc as ecc_mod
from repro_torch.core import tiling
from repro_torch.core.hw import FlashSpec
from repro_torch.quant.int8 import quantize_weight


class HybridWeights(NamedTuple):
    """A planned, quantized, (optionally) ECC-protected weight matrix."""

    flash_wq: torch.Tensor        # int8 [flash_rows, w]
    flash_scale: torch.Tensor     # f32  [flash_rows]
    npu_wq: torch.Tensor          # int8 [npu_rows, w]
    npu_scale: torch.Tensor       # f32  [npu_rows]
    ecc: Optional[ecc_mod.PageECC]  # sidecar of the flash region's pages
    tile_h: int
    tile_w: int


def plan_and_quantize(w: torch.Tensor, flash: FlashSpec,
                      with_ecc: bool = False,
                      plan: tiling.MatrixPlan | None = None) -> HybridWeights:
    """Quantize and split a float weight matrix [h, w] per the section V
    plan; with ``with_ecc`` encode the flash region's pages."""
    h, width = w.shape
    plan = plan or tiling.plan_matrix(h, width, flash)
    q = quantize_weight(w)
    fr = plan.flash_rows
    flash_wq, npu_wq = q.w_q[:fr], q.w_q[fr:]
    ecc = None
    if with_ecc and fr:
        ecc = ecc_mod.encode_pages(_to_pages(flash_wq))
    return HybridWeights(flash_wq=flash_wq, flash_scale=q.scale[:fr],
                         npu_wq=npu_wq, npu_scale=q.scale[fr:], ecc=ecc,
                         tile_h=plan.tile.h, tile_w=plan.tile.w)


def _to_pages(w_q: torch.Tensor,
              page_elems: int = ecc_mod.PAGE_ELEMS) -> torch.Tensor:
    """int8 [r, w] -> its bytes as uint8 pages [n, page_elems], the last
    page zero-padded."""
    flat = w_q.reshape(-1).view(torch.uint8)
    pad = (-flat.numel()) % page_elems
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, page_elems)


def _from_pages(pages: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    n = shape[0] * shape[1]
    return pages.reshape(-1)[:n].view(torch.int8).reshape(shape)


def corrupt_flash_region(hw: HybridWeights, ber: float,
                         gen: torch.Generator,
                         corrupt_ecc: bool = True) -> HybridWeights:
    """Inject NAND bit flips into the flash-resident region (and its ECC),
    drawing from ``gen``."""
    noisy = ecc_mod.inject_bitflips(_to_pages(hw.flash_wq), ber, gen)
    new_ecc = hw.ecc
    if hw.ecc is not None and corrupt_ecc:
        new_ecc = ecc_mod.inject_ecc_bitflips(hw.ecc, ber, gen)
    return hw._replace(flash_wq=_from_pages(noisy, hw.flash_wq.shape),
                       ecc=new_ecc)


def decoded_flash(hw: HybridWeights, use_kernel: bool = True) -> torch.Tensor:
    """The flash region's int8 weights after the ECC decode (as stored,
    when the matrix has no sidecar): B5 on the card, or its plain
    version."""
    if hw.ecc is None or not hw.flash_wq.shape[0]:
        return hw.flash_wq
    pages = _to_pages(hw.flash_wq)
    if use_kernel:
        from repro_torch.kernels.ecc_decode.ops import ecc_decode
        corrected = ecc_decode(pages, hw.ecc)
    else:
        corrected = ecc_mod.decode_pages(pages, hw.ecc)
    return _from_pages(corrected, hw.flash_wq.shape)


def hybrid_gemv(hw: HybridWeights, x: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
    """y = W x through the two regions; the ECC decode precedes the flash
    region.  x: [w] or [w, b] float -> f32 [h] or [h, b]."""
    if use_kernel:
        from repro_torch.kernels.int8_pagegemv.ops import paged_int8_gemv
    else:
        from repro_torch.kernels.int8_pagegemv.ref import (
            paged_int8_gemv_ref as paged_int8_gemv)
    flash_wq = decoded_flash(hw, use_kernel)
    parts = []
    if flash_wq.shape[0]:
        parts.append(paged_int8_gemv(flash_wq, hw.flash_scale, x))
    if hw.npu_wq.shape[0]:
        parts.append(paged_int8_gemv(hw.npu_wq, hw.npu_scale, x))
    return torch.cat(parts) if len(parts) > 1 else parts[0]
