"""Outlier-oriented on-die error correction (paper section VI), counterpart
of ``repro.core.ecc``, bit for bit.

Per 16 KB page of INT8 weights (16384 elements):

* the top 1% |magnitude| values (163 entries) are "outliers";
* the ECC sidecar stores, per page, the protection threshold (the smallest
  |outlier|) replicated 9x, and per outlier a 14-bit address, its 5-bit
  Hamming parity and N=2 copies of the value: 722 B, inside the page's
  1664 B spare area;
* decode: the per-bit majority of {in-page value, copy0, copy1} restores
  each protected value, and any unprotected value whose magnitude exceeds
  the threshold (a fake outlier minted by a bit flip) is clamped to 0.

Pages batch along a leading axis.  Three differences from the JAX module,
none in the function computed:

* addresses are int32 tensors (torch has no uint16 shifts, compares or
  ``index_put`` on the CPU); ``bridge.ecc_from_numpy`` converts JAX's
  uint16 at the boundary;
* ``encode_pages`` reproduces ``jax.lax.top_k``'s order (magnitude
  descending, lower index first among ties) by ranking the unique key
  ``magnitude * P + (P - 1 - index)``;
* where two sidecar entries name the same address after correction, JAX's
  scatter order is implementation-defined; ``decode_pages`` fixes it as
  "the last entry wins", which is also what the B5 kernel does.

Bit flips are drawn from an explicit ``torch.Generator``; its bits differ
from ``jax.random``'s, so parity tests inject in JAX and feed both.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

PAGE_ELEMS = 16384
OUTLIER_FRACTION = 0.01
THRESHOLD_COPIES = 9
VALUE_COPIES = 2  # N in the paper (even)
ADDR_BITS = 14
HAMMING_PARITY_BITS = 5
# bytes per draw of ``inject_bitflips``: bounds its per-bit scratch tensor
FLIP_CHUNK = 1 << 22


def n_outliers(page_elems: int = PAGE_ELEMS) -> int:
    return int(page_elems * OUTLIER_FRACTION)


def ecc_size_bits(page_elems: int = PAGE_ELEMS) -> int:
    """Paper: 8*9 + (14 + 5 + 8*N) * n_outliers bits (722 B for a 16KB page)."""
    per_entry = ADDR_BITS + HAMMING_PARITY_BITS + 8 * VALUE_COPIES
    return 8 * THRESHOLD_COPIES + per_entry * n_outliers(page_elems)


class PageECC(NamedTuple):
    """ECC sidecar for a batch of pages. Leading dims are batch dims."""

    threshold: torch.Tensor    # (..., 9)  uint8 magnitude copies
    addr: torch.Tensor         # (..., K)  int32, 14-bit addresses
    addr_parity: torch.Tensor  # (..., K)  uint8, 5-bit Hamming parity
    copies: torch.Tensor       # (..., K, N) uint8 bit patterns of the values


# --------------------------------------------------------------------------
# Hamming(19,14) single-error-correcting code over the 14-bit address.
# --------------------------------------------------------------------------


@functools.lru_cache(None)
def _hamming_layout():
    """(data_positions, parity_positions) in the 1-based 19-bit codeword:
    powers of two hold parity, the rest the 14 data bits in order."""
    parity_pos = [1, 2, 4, 8, 16]
    data_pos = [p for p in range(1, 20) if p not in parity_pos]
    return tuple(data_pos), tuple(parity_pos)


def hamming_encode(addr: torch.Tensor) -> torch.Tensor:
    """addr: int with 14 significant bits -> 5-bit parity, uint8."""
    data_pos, parity_pos = _hamming_layout()
    addr = addr.to(torch.int32)
    parity = torch.zeros_like(addr)
    for i, pp in enumerate(parity_pos):
        acc = torch.zeros_like(addr)
        for k, dp in enumerate(data_pos):
            if dp & pp:
                acc = acc ^ ((addr >> k) & 1)
        parity = parity | (acc << i)
    return parity.to(torch.uint8)


def hamming_correct(addr: torch.Tensor, parity: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Correct single-bit errors in (addr, parity); return (int32 addr,
    valid).  ``valid`` is False when the syndrome points outside the
    codeword (a detectable multi-bit error); double-bit errors may alias
    to a miscorrection (inherent to SEC codes)."""
    data_pos, parity_pos = _hamming_layout()
    addr = addr.to(torch.int32)
    parity = parity.to(torch.int32)
    syndrome = torch.zeros_like(addr)
    for i, pp in enumerate(parity_pos):
        acc = (parity >> i) & 1
        for k, dp in enumerate(data_pos):
            if dp & pp:
                acc = acc ^ ((addr >> k) & 1)
        syndrome = syndrome | (acc << i)
    corrected = addr
    for k, dp in enumerate(data_pos):
        corrected = torch.where(syndrome == dp, corrected ^ (1 << k),
                                corrected)
    return corrected, syndrome <= 19


# --------------------------------------------------------------------------
# Bit-level helpers
# --------------------------------------------------------------------------


def _majority3_u8(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    return ((a & b) | (a & c) | (b & c)).to(torch.uint8)


def _majority_bits(copies: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-bit majority over an odd number of uint8 copies along ``axis``."""
    axis = axis % copies.dim()
    n = copies.shape[axis]
    bits = torch.stack([(copies >> k) & 1 for k in range(8)], dim=-1)
    maj = (bits.to(torch.int32).sum(axis) > n // 2).to(torch.uint8)
    out = torch.zeros(maj.shape[:-1], dtype=torch.uint8, device=copies.device)
    for k in range(8):
        out = out | (maj[..., k] << k)
    return out


def _abs_i8(v_u8: torch.Tensor) -> torch.Tensor:
    """|value| of an int8 bit pattern, in int32 (|-128| = 128)."""
    return v_u8.view(torch.int8).to(torch.int32).abs()


# --------------------------------------------------------------------------
# Encode / decode
# --------------------------------------------------------------------------


def encode_pages(pages_u8: torch.Tensor, batch: int = 4096) -> PageECC:
    """The ECC sidecars of a batch of pages of int8 bit patterns (uint8
    [B, P]), ``batch`` pages at a time.

    ``jax.lax.top_k`` orders by magnitude descending and, among equal
    magnitudes, by index ascending; ``torch.topk`` leaves ties in no fixed
    order.  Ranking the unique key ``mag * P + (P - 1 - index)`` instead
    gives JAX's selection and order on any device.
    """
    b, p = pages_u8.shape
    k = n_outliers(p)
    dev = pages_u8.device
    rev = (p - 1) - torch.arange(p, dtype=torch.int32, device=dev)
    parts = []
    for s in range(0, b, batch):
        chunk = pages_u8[s:s + batch]
        key = _abs_i8(chunk) * p + rev
        top = torch.topk(key, k, dim=-1, sorted=True).values
        parts.append((top // p, (p - 1) - top % p))
    top_mags = torch.cat([m for m, _ in parts]) if parts else \
        torch.zeros((0, k), dtype=torch.int32, device=dev)
    addr = torch.cat([i for _, i in parts]) if parts else top_mags.clone()
    threshold = torch.clamp_max(top_mags[:, -1:], 255).to(torch.uint8)
    vals = torch.gather(pages_u8, 1, addr.long())
    return PageECC(
        threshold=threshold.expand(b, THRESHOLD_COPIES).contiguous(),
        addr=addr.to(torch.int32).contiguous(),
        addr_parity=hamming_encode(addr),
        copies=vals[:, :, None].expand(b, k, VALUE_COPIES).contiguous())


def encode_page(page_u8: torch.Tensor) -> PageECC:
    """The ECC sidecar of one page (uint8 [P])."""
    e = encode_pages(page_u8[None])
    return PageECC(*(t[0] for t in e))


def decode_pages(pages_u8: torch.Tensor, ecc: PageECC) -> torch.Tensor:
    """Correct a batch of (possibly corrupted) pages uint8 [B, P] given
    their (possibly corrupted) sidecars: the plain version of the B5
    kernel (``kernels.ecc_decode``).

    As ``repro.core.ecc.decode_page``: a position is protected when a valid
    entry names it; unprotected values above the voted threshold become 0;
    each entry then writes its voted value if valid, else the (clamped)
    value already there.  Where entries collide, the last one wins, for
    the protected mask as for the write.
    """
    b, p = pages_u8.shape
    dev = pages_u8.device
    threshold = _majority_bits(ecc.threshold, axis=-1).to(torch.int32)
    addr, valid = hamming_correct(ecc.addr, ecc.addr_parity)
    addr = torch.clamp_max(addr, p - 1).long()
    k = addr.shape[1]
    # the last entry naming each address
    entry = torch.arange(k, device=dev).expand(b, k)
    last_at = torch.full((b, p), -1, dtype=torch.long, device=dev)
    last_at.scatter_reduce_(1, addr, entry, reduce="amax")
    is_last = torch.gather(last_at, 1, addr) == entry
    flat = (addr + torch.arange(b, device=dev)[:, None] * p)[is_last]

    protected = torch.zeros(b * p, dtype=torch.bool, device=dev)
    protected[flat] = valid[is_last]
    mags = _abs_i8(pages_u8)
    clamp = (mags > threshold[:, None]) & ~protected.view(b, p)
    out = torch.where(clamp, torch.zeros_like(pages_u8), pages_u8)

    in_page = torch.gather(pages_u8, 1, addr)
    voted = _majority3_u8(in_page, ecc.copies[..., 0], ecc.copies[..., 1])
    restored = torch.where(valid, voted, torch.gather(out, 1, addr))
    out = out.reshape(-1)
    out[flat] = restored[is_last]
    return out.view(b, p)


def decode_page(page_u8: torch.Tensor, ecc: PageECC) -> torch.Tensor:
    return decode_pages(page_u8[None], PageECC(*(t[None] for t in ecc)))[0]


# --------------------------------------------------------------------------
# Error injection (the paper's "flash error models of varying intensities")
# --------------------------------------------------------------------------


def _flip_mask(n: int, bits: int, ber: float, gen: torch.Generator,
               device) -> torch.Tensor:
    """int32 [n]: bit j set with probability ``ber``, each independently,
    for the low ``bits`` bits."""
    flips = torch.rand((n, bits), generator=gen, device=device) < ber
    weights = 1 << torch.arange(bits, dtype=torch.int32, device=device)
    return (flips.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def _inject(arr: torch.Tensor, bits: int, ber: float,
            gen: torch.Generator) -> torch.Tensor:
    flat = arr.reshape(-1)
    out = flat.clone()
    if ber > 0:
        for s in range(0, flat.numel(), FLIP_CHUNK):
            n = min(FLIP_CHUNK, flat.numel() - s)
            mask = _flip_mask(n, bits, ber, gen, flat.device)
            out[s:s + n] ^= mask.to(flat.dtype)
    return out.view(arr.shape)


def inject_bitflips(arr_u8: torch.Tensor, ber: float,
                    gen: torch.Generator) -> torch.Tensor:
    """Flip each bit of ``arr_u8`` independently with probability ``ber``,
    drawing from ``gen`` (on the array's device) a chunk of bytes at a
    time, so the per-bit draw never spans more than ``FLIP_CHUNK`` bytes."""
    return _inject(arr_u8, 8, ber, gen)


def inject_ecc_bitflips(ecc: PageECC, ber: float,
                        gen: torch.Generator) -> PageECC:
    """Corrupt the ECC sidecar itself (it lives in the same flash)."""
    thr = inject_bitflips(ecc.threshold, ber, gen)
    copies = inject_bitflips(ecc.copies, ber, gen)
    parity = inject_bitflips(ecc.addr_parity, ber, gen) & 0x1F
    addr = _inject(ecc.addr, ADDR_BITS, ber, gen)
    return PageECC(threshold=thr, addr=addr, addr_parity=parity,
                   copies=copies)


def protected_flip_rate(ber: float, n_copies: int = VALUE_COPIES) -> float:
    """Closed form f_prot = C(N+1, N/2+1) x^{N/2+1} + ... (paper section
    VI); N=2 -> ~3x^2."""
    n = n_copies
    total = 0.0
    for i in range(n // 2 + 1, n + 2):
        total += math.comb(n + 1, i) * ber**i * (1 - ber) ** (n + 1 - i)
    return total
