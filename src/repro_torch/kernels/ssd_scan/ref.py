"""Plain PyTorch version of the SSD intra-chunk kernel (B6): the port's copy
of ``repro.kernels.ssd_scan.ref``, the ``y_diag`` term of
``models/ssm.py::ssd_chunked``.

``ssd_intra_chunk_ref`` works in the Pallas kernel's layout (heads and
chunks leading); ``ssd_intra_chunk_model_ref`` is the same function in the
model's layout, x ``[B, S, H, P]``, a ``[B, S, H]``, B / C ``[B, S, G, N]``,
through the transposes of the JAX front end (``ops.py``).  Both compute in
``dtype`` (float32 by default, as the reference does; float64 gives a
yardstick that is free of float32 rounding).

``ssd_intra_chunk_split_ref`` rehearses the roundings of the bf16
tensor-core kernel: C B^T of bf16 inputs with float32 sums, cs in double,
S = (C B^T) o L in float32 split into bf16 terms (three, as the kernel:
exactly), S x summed in float32.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., T] -> lower-triangular pairwise sums a(j..i] as [..., T, T]
    (cumsum differences), NEG_INF above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, NEG_INF))


def ssd_intra_chunk_ref(a: torch.Tensor, b_mat: torch.Tensor,
                        c_mat: torch.Tensor, x: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a: [BH, C, Q]; b/c: [BG, C, Q, N]; x: [BH, C, Q, P] -> [BH, C, Q, P].

    Heads fold onto groups as the Pallas kernel's index map does: row i of
    the BH axis reads group row ``i // (BH // BG)``."""
    rep = a.shape[0] // b_mat.shape[0]
    b_full = torch.repeat_interleave(b_mat, rep, dim=0)
    c_full = torch.repeat_interleave(c_mat, rep, dim=0)
    ell = torch.exp(_segsum(a.to(dtype)))
    ell = torch.where(torch.isfinite(ell), ell, torch.zeros_like(ell))
    s = torch.einsum("gcln,gcsn->gcls", c_full.to(dtype),
                     b_full.to(dtype)) * ell
    return torch.einsum("gcls,gcsp->gclp", s, x.to(dtype))


def ssd_intra_chunk_model_ref(x: torch.Tensor, a: torch.Tensor,
                              b_mat: torch.Tensor, c_mat: torch.Tensor,
                              chunk: int,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The same function in the model's layout; S must divide by ``chunk``.
    Returns y_diag [B, S, H, P] in ``dtype``."""
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4) \
        .reshape(b * h, nc, chunk, p)
    ar = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2) \
        .reshape(b * h, nc, chunk)
    br = b_mat.reshape(b, nc, chunk, g, n).permute(0, 3, 1, 2, 4) \
        .reshape(b * g, nc, chunk, n)
    cr = c_mat.reshape(b, nc, chunk, g, n).permute(0, 3, 1, 2, 4) \
        .reshape(b * g, nc, chunk, n)
    y = ssd_intra_chunk_ref(ar, br, cr, xr, dtype)
    return y.reshape(b, h, nc, chunk, p).permute(0, 2, 3, 1, 4) \
        .reshape(b, s, h, p)


def ssd_intra_chunk_split_ref(x: torch.Tensor, a: torch.Tensor,
                              b_mat: torch.Tensor, c_mat: torch.Tensor,
                              chunk: int, terms: int = 3) -> torch.Tensor:
    """The model-layout function with the bf16 kernel's roundings: the
    products of the (bf16) inputs are exact in float32 and summed in
    float32; cs is summed in double, cs log2(e) kept as float32 hi + lo,
    and L = exp2((hi_i - hi_j) + (lo_i - lo_j)) in float32;
    S = (C B^T) o L is rounded to float32 and written as ``terms`` bf16
    values, each the top 8 significant bits of what the earlier ones leave
    (three hold S exactly); each term's product with x is summed in
    float32.  Returns y_diag float32."""
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc, rep = s // chunk, h // g
    xr = x.float().reshape(b, nc, chunk, h, p)
    cs2 = a.double().reshape(b, nc, chunk, h).cumsum(2) * math.log2(math.e)
    hi = cs2.float()
    lo = (cs2 - hi.double()).float()
    bm = b_mat.float().reshape(b, nc, chunk, g, n)
    cm = c_mat.float().reshape(b, nc, chunk, g, n)
    cbt = torch.einsum("bcign,bcjgn->bcgij", cm, bm)          # float32
    cbt = torch.repeat_interleave(cbt, rep, dim=2)             # [b,c,h,i,j]
    def pairwise(v):   # v_i - v_j as [b, c, h, i, j]
        return (v[:, :, :, None, :] - v[:, :, None, :, :]).permute(
            0, 1, 4, 2, 3)

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ell = torch.exp2(pairwise(hi) + pairwise(lo))
    sm = torch.where(mask.to(x.device), cbt * ell, torch.zeros_like(cbt))
    y = torch.zeros((b, nc, chunk, h, p), dtype=torch.float32,
                    device=x.device)
    rest = sm
    for _ in range(terms):
        term = (rest.view(torch.int32) & -65536).view(torch.float32)
        rest = rest - term
        y = y + torch.einsum("bchij,bcjhp->bcihp", term, xr)
    return y.reshape(b, s, h, p)
