"""Wrappers of the grouped GEMM kernels, the MoE family's routed-expert
product, ``jax.lax.ragged_dot``, and its gradient.

``grouped_gemm(x, w, group_sizes)`` returns ``out [R, N]``, ``out[r] =
x[r] @ w[e(r)]`` for x ``[R, K]`` sorted by expert, w ``[E, K, N]`` and
int32 ``group_sizes [E]``; rows past the groups' sum are 0.  A CPU tensor
takes the plain version (``ref.grouped_gemm_ref``, which reads the group
sizes on the host; autograd differentiates it).  On a CUDA tensor the
kernels read the group sizes on the device: a launch reads nothing back,
so a CUDA graph can hold it.

* bf16 x and w (serving) launch ``csrc/grouped_gemm.cu`` (wgmma fed by
  TMA; K and N multiples of 8).  It has no backward: a call that autograd
  would differentiate raises ``NotImplementedError``.  Launches:
  ``grouped_gemm``.
* float32 x and w (training) go through ``GroupedGemmF32``, a
  ``torch.autograd.Function`` over ``csrc/grouped_gemm_f32.cu``: the
  forward kernel, and in the backward the dX kernel (``dx = dy @ w^T``)
  and the dW kernel (``dw[e] = x_e^T @ dy_e``), each only where autograd
  asks for that gradient.  K and N multiples of 4.  Launches:
  ``grouped_gemm_f32``, ``grouped_gemm_f32_dx``, ``grouped_gemm_f32_dw``.

Any other type on the card raises, as do a K or N off the kernel's grid, a
base off the 16-byte grid and a non-contiguous operand.  No CUDA path falls
back to the plain version: a build or launch failure raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_gemm.ref import (grouped_gemm_dw_ref,
                                                  grouped_gemm_dx_ref,
                                                  grouped_gemm_ref)

LAUNCHES = {"grouped_gemm": 0, "grouped_gemm_f32": 0,
            "grouped_gemm_f32_dx": 0, "grouped_gemm_f32_dw": 0}


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor,
                    group_sizes: torch.Tensor) -> None:
    """a and b on one CUDA device, int32 group sizes beside them, all
    contiguous."""
    if a.device.type != "cuda" or b.device != a.device \
            or group_sizes.device != a.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}, "
                         f"group_sizes on {group_sizes.device}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError(f"{name} takes contiguous operands")


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w, group_sizes)
    if x.device.type == "cuda" and x.dtype == torch.float32 \
            and w.dtype == torch.float32:
        return GroupedGemmF32.apply(x, w, group_sizes)
    _check_operands("grouped_gemm", x, w, group_sizes)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_gemm takes bf16 or float32 x and w on the "
                        f"card, got {x.dtype}, {w.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "grouped_gemm: the bf16 kernel (csrc/grouped_gemm.cu) has no "
            "backward; train in float32 (GroupedGemmF32)")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] \
            or group_sizes.shape != (w.shape[0],):
        raise ValueError(f"grouped_gemm shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} do not match")
    r, k = x.shape
    e, n = w.shape[0], w.shape[2]
    if k % 8 or n % 8 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"grouped_gemm copies 16-byte rows: K {k} and N {n} "
                         f"must be multiples of 8 and the bases 16-byte "
                         f"aligned")
    out = torch.empty((r, n), dtype=x.dtype, device=x.device)
    if r == 0:
        return out
    status = build.library().repro_grouped_gemm(
        x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        r, k, n, e, build.stream_handle(x.device))
    build.check(status, "grouped_gemm")
    LAUNCHES["grouped_gemm"] += 1
    return out


# ---------------------------------------------------------------------------
# float32 forward, dX and dW (csrc/grouped_gemm_f32.cu)
# ---------------------------------------------------------------------------


def _check_f32(name: str, a: torch.Tensor, b: torch.Tensor,
               group_sizes: torch.Tensor, k: int, n: int) -> None:
    """What the float32 kernels take beside ``_check_operands``: float32 a
    and b, K and N multiples of 4 and 16-byte aligned bases (16-byte
    copies)."""
    _check_operands(name, a, b, group_sizes)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 operands, got {a.dtype}, "
                        f"{b.dtype}")
    if k % 4 or n % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name} copies 16-byte rows: K {k} and N {n} must "
                         f"be multiples of 4 and the bases 16-byte aligned")


def _check_w(name: str, rows: torch.Tensor, w: torch.Tensor,
             group_sizes: torch.Tensor, axis: int) -> None:
    """rows [R, w.shape[axis]], w [E, K, N], group_sizes [E]."""
    if rows.dim() != 2 or w.dim() != 3 or rows.shape[1] != w.shape[axis] \
            or group_sizes.shape != (w.shape[0],):
        raise ValueError(f"{name} shapes {tuple(rows.shape)}, w "
                         f"{tuple(w.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} do not match")


def grouped_gemm_f32_fwd(x: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """The forward kernel: out [R, N] float32, ``out[r] = x[r] @
    w[e(r)]``, rows past the groups' sum 0 (the plain version on the
    CPU)."""
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w, group_sizes)
    _check_w("grouped_gemm_f32", x, w, group_sizes, 1)
    r, k = x.shape
    e, n = w.shape[0], w.shape[2]
    _check_f32("grouped_gemm_f32", x, w, group_sizes, k, n)
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    status = build.library().repro_grouped_f32_fwd(
        x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        r, k, n, e, build.stream_handle(x.device))
    build.check(status, "grouped_gemm_f32")
    LAUNCHES["grouped_gemm_f32"] += 1
    return out


def grouped_gemm_f32_dx(dy: torch.Tensor, w: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """The dX kernel: dx [R, K] float32, ``dx[r] = dy[r] @ w[e(r)]^T``,
    rows past the groups' sum 0 (the plain version on the CPU)."""
    if dy.device.type == "cpu":
        return grouped_gemm_dx_ref(dy, w, group_sizes)
    _check_w("grouped_gemm_f32_dx", dy, w, group_sizes, 2)
    r, n = dy.shape
    e, k = w.shape[0], w.shape[1]
    _check_f32("grouped_gemm_f32_dx", dy, w, group_sizes, k, n)
    dx = torch.empty((r, k), dtype=torch.float32, device=dy.device)
    if r == 0:
        return dx
    status = build.library().repro_grouped_f32_dx(
        dy.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), dx.data_ptr(),
        r, k, n, e, build.stream_handle(dy.device))
    build.check(status, "grouped_gemm_f32_dx")
    LAUNCHES["grouped_gemm_f32_dx"] += 1
    return dx


def grouped_gemm_f32_dw(x: torch.Tensor, dy: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """The dW kernel: dw [E, K, N] float32 (E = len(group_sizes)),
    ``dw[e] = x_e^T @ dy_e`` over expert e's rows, exact zeros for an
    expert without rows (the plain version on the CPU).  Launched for R ==
    0 too: it writes every expert's zeros."""
    if x.device.type == "cpu":
        return grouped_gemm_dw_ref(x, dy, group_sizes)
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0] \
            or group_sizes.dim() != 1:
        raise ValueError(f"grouped_gemm_f32_dw shapes x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} do not match")
    r, k = x.shape
    n, e = dy.shape[1], group_sizes.shape[0]
    _check_f32("grouped_gemm_f32_dw", x, dy, group_sizes, k, n)
    dw = torch.empty((e, k, n), dtype=torch.float32, device=x.device)
    if e == 0:
        return dw
    status = build.library().repro_grouped_f32_dw(
        x.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(), dw.data_ptr(),
        r, k, n, e, build.stream_handle(x.device))
    build.check(status, "grouped_gemm_f32_dw")
    LAUNCHES["grouped_gemm_f32_dw"] += 1
    return dw


class GroupedGemmF32(torch.autograd.Function):
    """The float32 grouped product whose gradient is the dX and dW
    kernels' (their plain versions on CPU tensors).  Saves x, w and the
    group sizes; the backward runs dX and dW only where
    ``ctx.needs_input_grad`` asks."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return grouped_gemm_f32_fwd(x, w, group_sizes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_gemm_f32_dx(dy, w, group_sizes) \
            if ctx.needs_input_grad[0] else None
        dw = grouped_gemm_f32_dw(x, dy, group_sizes) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None
