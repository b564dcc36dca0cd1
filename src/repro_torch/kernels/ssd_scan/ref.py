"""Plain PyTorch version of the SSD intra-chunk kernel (B6): the port's copy
of ``repro.kernels.ssd_scan.ref``, the ``y_diag`` term of
``models/ssm.py::ssd_chunked``.

``ssd_intra_chunk_ref`` works in the Pallas kernel's layout (heads and
chunks leading); ``ssd_intra_chunk_model_ref`` is the same function in the
model's layout, x ``[B, S, H, P]``, a ``[B, S, H]``, B / C ``[B, S, G, N]``,
through the transposes of the JAX front end (``ops.py``).  Both compute in
``dtype`` (float32 by default, as the reference does; float64 gives a
yardstick that is free of float32 rounding).
"""

from __future__ import annotations

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
