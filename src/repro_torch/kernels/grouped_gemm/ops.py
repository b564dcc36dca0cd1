"""Wrapper of the grouped GEMM kernel (``csrc/grouped_gemm.cu``), the MoE
family's routed-expert product, ``jax.lax.ragged_dot``.

``grouped_gemm(x, w, group_sizes)`` returns ``out [R, N]``, ``out[r] =
x[r] @ w[e(r)]`` for x ``[R, K]`` sorted by expert, w ``[E, K, N]`` and
int32 ``group_sizes [E]``; rows past the groups' sum are 0.  A CPU tensor
takes the plain version (``ref.grouped_gemm_ref``, which reads the group
sizes on the host); a CUDA tensor launches the kernel, which reads them on
the device: the launch reads nothing back, so a CUDA graph can hold it.
The kernel takes bf16 x and w only (float32 oracles run on the CPU); any
other type on the card raises, as does a K or N that is not a multiple of
8 or a base off the 16-byte grid.  ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

LAUNCHES = {"grouped_gemm": 0}


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w, group_sizes)
    if x.device.type != "cuda" or w.device != x.device \
            or group_sizes.device != x.device:
        raise ValueError(f"grouped_gemm: x on {x.device}, w on {w.device}, "
                         f"group_sizes on {group_sizes.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_gemm takes bf16 x and w on the card, got "
                        f"{x.dtype}, {w.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] \
            or group_sizes.shape != (w.shape[0],):
        raise ValueError(f"grouped_gemm shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} do not match")
    if not (x.is_contiguous() and w.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError("grouped_gemm takes contiguous operands")
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
