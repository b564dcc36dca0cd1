"""Wrapper of the SSD intra-chunk kernel (``csrc/ssd_scan.cu``, B6).

``ssd_intra_chunk(x, a, b_mat, c_mat, chunk)`` returns the ``y_diag`` term
of ``models/ssm.py::ssd_chunked`` in the model's layout: x ``[B, S, H, P]``,
a ``[B, S, H]`` float32, B / C ``[B, S, G, N]``, y_diag ``[B, S, H, P]``
float32.  A CPU tensor takes the plain version
(``ref.ssd_intra_chunk_model_ref``); a CUDA tensor launches the kernel, which
reads all four inputs through their strides.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_model_ref

HEAD_DIMS = (16, 32, 64, 128)   # P
MAX_CHUNK = 128                 # Q
MAX_STATE = 256                 # N
LAUNCHES = {"ssd_intra_chunk": 0}


def ssd_intra_chunk(x: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor, chunk: int) -> torch.Tensor:
    """S must divide by ``chunk``; heads fold onto groups as
    ``g = h // (H // G)``."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_model_ref(x, a, b_mat, c_mat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: tensor on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or float32, got {x.dtype}")
    for name, t, dims in (("x", x, 4), ("b_mat", b_mat, 4),
                          ("c_mat", c_mat, 4), ("a", a, 3)):
        want = torch.float32 if name == "a" else x.dtype
        if t.dtype != want or t.device != x.device or t.dim() != dims:
            raise TypeError(f"{name} must be a {dims}-d {want} tensor on "
                            f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
        if name != "a" and t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous, got "
                             f"strides {t.stride()}")
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if a.shape != (b, s, h) or b_mat.shape[:2] != (b, s) \
            or c_mat.shape != b_mat.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, a {tuple(a.shape)}, B "
                         f"{tuple(b_mat.shape)}, C {tuple(c_mat.shape)} do "
                         f"not match")
    if p not in HEAD_DIMS or h % g or n > MAX_STATE or not 0 < chunk <= \
            MAX_CHUNK or s % chunk:
        raise ValueError(f"unsupported shape S={s} H={h} G={g} N={n} P={p} "
                         f"chunk={chunk}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    if b == 0 or s == 0:
        return y
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *a.stride(),
                                       *b_mat.stride()[:3],
                                       *c_mat.stride()[:3])
    status = build.library().repro_ssd_intra_chunk(
        x.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        y.data_ptr(), b, s, h, g, n, p, chunk,
        int(x.dtype == torch.bfloat16), strides,
        build.stream_handle(x.device))
    build.check(status, "ssd_intra_chunk")
    LAUNCHES["ssd_intra_chunk"] += 1
    return y
