"""Wrapper of the on-die ECC decode kernel (``csrc/ecc_decode.cu``, B5).

``ecc_decode(pages, ecc)`` corrects uint8 pages ``[B, P]`` given their
sidecars (``core.ecc.PageECC``: threshold uint8 ``[B, 9]``, addr int32
``[B, K]``, addr_parity uint8 ``[B, K]``, copies uint8 ``[B, K, 2]``) and
returns new pages.  It computes ``repro.kernels.ecc_decode.ops.ecc_decode_op``:
the threshold vote, the Hamming correction of the addresses, the value
vote, the clamp of unprotected values above the threshold and the restore
of the protected ones, all inside the kernel.  A CPU tensor takes the plain
version (``ref.ecc_decode_ref``); a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.ecc import PageECC
from repro_torch.kernels import build
from repro_torch.kernels.ecc_decode.ref import ecc_decode_ref

LAUNCHES = {"ecc_decode": 0}
MAX_ENTRIES = 256       # one thread of the kernel's CTA per entry
MAX_PAGE = 48 * 1024    # the page is held in registers, <= 12 x 16 B a thread


def ecc_decode(pages: torch.Tensor, ecc: PageECC) -> torch.Tensor:
    if pages.device.type == "cpu":
        return ecc_decode_ref(pages, ecc)
    if pages.device.type != "cuda":
        raise ValueError(f"ecc_decode: pages on {pages.device}")
    b, p = pages.shape
    k = ecc.addr.shape[-1]
    parts = (pages, ecc.threshold, ecc.addr, ecc.addr_parity, ecc.copies)
    dtypes = (torch.uint8, torch.uint8, torch.int32, torch.uint8, torch.uint8)
    shapes = ((b, p), (b, ecc.threshold.shape[-1]), (b, k), (b, k),
              (b, k, 2))
    for t, dt, shape in zip(parts, dtypes, shapes):
        if t.device != pages.device or t.dtype != dt \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"ecc_decode: expected contiguous {dt} {shape} on "
                f"{pages.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if p % 16 or p > MAX_PAGE or k > MAX_ENTRIES \
            or pages.data_ptr() % 16:
        raise ValueError(f"ecc_decode: page of {p} bytes (a multiple of 16 "
                         f"up to {MAX_PAGE}, 16-byte aligned) with {k} "
                         f"entries (<= {MAX_ENTRIES}) is not supported")
    out = torch.empty_like(pages)
    if b == 0:
        return out
    status = build.library().repro_ecc_decode(
        pages.data_ptr(), ecc.threshold.data_ptr(), ecc.addr.data_ptr(),
        ecc.addr_parity.data_ptr(), ecc.copies.data_ptr(), out.data_ptr(),
        b, p, k, ecc.threshold.shape[-1], build.stream_handle(pages.device))
    build.check(status, "ecc_decode")
    LAUNCHES["ecc_decode"] += 1
    return out
