"""Plain PyTorch version of the grouped GEMM (``jax.lax.ragged_dot``): the
CPU path and the kernel's oracle on the card."""

from __future__ import annotations

import torch

from repro_torch.models.layers import fixed_row_matmul


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """out [R, N] in x's dtype, ``out[r] = x[r] @ w[e(r)]`` for rows sorted
    by expert, ``group_sizes[e]`` rows for expert e; rows past the groups'
    sum are 0, as ``ragged_dot`` leaves them.  Each output is accumulated
    in float32 and rounded to x's dtype once.

    The group sizes are read on the host (each is clamped to [0, rows
    left], as the kernel clamps them).  Each expert's rows go through
    products of ``layers.FIXED_ROWS`` rows each, zero-padded, so a row's
    bits do not depend on its group's size or its place in it."""
    r, n = x.shape[0], w.shape[2]
    out = torch.zeros((r, n), dtype=x.dtype, device=x.device)
    start = 0
    for e, g in enumerate(group_sizes.tolist()):
        g = min(max(int(g), 0), r - start)
        if g:
            rows = slice(start, start + g)
            out[rows] = fixed_row_matmul(x[rows].float(),
                                         w[e].float()).to(x.dtype)
        start += g
    return out
