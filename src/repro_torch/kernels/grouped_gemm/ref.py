"""Plain PyTorch versions of the grouped GEMM (``jax.lax.ragged_dot``) and
of its gradient (``jax.vjp`` of it): the CPU path and the kernels' oracles
on the card."""

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
    bits do not depend on its group's size or its place in it.

    The experts are taken from one ``unbind`` of w, so autograd stacks
    their weight gradients once, not one [E, K, N] tensor per expert."""
    r, n = x.shape[0], w.shape[2]
    out = torch.zeros((r, n), dtype=x.dtype, device=x.device)
    experts = w.unbind(0)
    for e, start, g in _clamped_spans(group_sizes, r):
        rows = slice(start, start + g)
        out[rows] = fixed_row_matmul(x[rows].float(),
                                     experts[e].float()).to(x.dtype)
    return out


def _clamped_spans(group_sizes: torch.Tensor, r: int):
    """(expert, first row, rows) of each non-empty group, each size clamped
    to [0, rows left]."""
    spans, start = [], 0
    for e, g in enumerate(group_sizes.tolist()):
        g = min(max(int(g), 0), r - start)
        if g:
            spans.append((e, start, g))
        start += g
    return spans


def grouped_gemm_dx_ref(dy: torch.Tensor, w: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """The gradient of ``grouped_gemm_ref`` with respect to x: dx [R, K] in
    dy's dtype, ``dx[r] = dy[r] @ w[e(r)]^T``; rows past the groups' sum are
    0.  Each row through ``layers.FIXED_ROWS``-row products, accumulated in
    float32 and rounded to dy's dtype once."""
    r, k = dy.shape[0], w.shape[1]
    dx = torch.zeros((r, k), dtype=dy.dtype, device=dy.device)
    for e, start, g in _clamped_spans(group_sizes, r):
        rows = slice(start, start + g)
        dx[rows] = fixed_row_matmul(dy[rows].float(),
                                    w[e].float().T).to(dy.dtype)
    return dx


def grouped_gemm_dw_ref(x: torch.Tensor, dy: torch.Tensor,
                        group_sizes: torch.Tensor,
                        e: int | None = None) -> torch.Tensor:
    """The gradient of ``grouped_gemm_ref`` with respect to w: dw [E, K, N]
    in x's dtype, ``dw[e] = x_e^T @ dy_e`` over expert e's rows (float32
    sums, rounded once); ``e`` experts (default: one per group size), and an
    expert with no rows, or past the group sizes, gets exact zeros."""
    r, k, n = x.shape[0], x.shape[1], dy.shape[1]
    e = len(group_sizes) if e is None else e
    dw = torch.zeros((e, k, n), dtype=x.dtype, device=x.device)
    for ex, start, g in _clamped_spans(group_sizes, r):
        if ex < e:
            rows = slice(start, start + g)
            dw[ex] = (x[rows].float().T @ dy[rows].float()).to(x.dtype)
    return dw
