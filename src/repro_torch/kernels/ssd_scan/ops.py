"""Wrapper of the SSD intra-chunk kernel (``csrc/ssd_scan.cu``, B6).

``ssd_intra_chunk(x, a, b_mat, c_mat, chunk)`` returns the ``y_diag`` term
of ``models/ssm.py::ssd_chunked`` in the model's layout: x ``[B, S, H, P]``,
a ``[B, S, H]`` float32, B / C ``[B, S, G, N]``, y_diag ``[B, S, H, P]``
float32.  A CPU tensor takes the plain version
(``ref.ssd_intra_chunk_model_ref``); a CUDA tensor launches the kernel, which
reads all four inputs through their strides.  bf16 inputs go to the
tensor-core kernel, which copies x, B and C with 16-byte ``cp.async``: their
bases and strides must be 16-byte aligned (the model's views into the conv
output are), and a view that is not raises.  float32 inputs go to the
CUDA-core kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_model_ref

HEAD_DIMS = (16, 32, 64, 128)   # P
MAX_CHUNK = 128                 # Q
MAX_STATE = 256                 # N
MAX_HEAD_BLOCK = 8              # heads per CTA of the tensor-core kernel
LAUNCHES = {"ssd_intra_chunk": 0}


def ctas_per_sm(p: int) -> int:
    """CTAs of the tensor-core kernel an SM holds at once (its launch
    bounds and shared memory: two where P <= 64)."""
    return 2 if p <= 64 else 1


def head_block(b: int, n_chunks: int, h: int, g: int, slots: int) -> int:
    """Heads per CTA of the tensor-core kernel: the fewest that keep the
    grid of (batch, chunk, head block) CTAs within one wave of ``slots``
    CTAs, at most MAX_HEAD_BLOCK and at most the heads of one group."""
    return max(1, min(MAX_HEAD_BLOCK, -(-b * n_chunks * h // slots), h // g))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned16(t: torch.Tensor) -> bool:
    """Base and every stride but the last a multiple of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * size % 16 == 0 for st in t.stride()[:-1])


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
    bf16 = x.dtype == torch.bfloat16
    if p not in HEAD_DIMS or h % g or n > MAX_STATE or not 0 < chunk <= \
            MAX_CHUNK or s % chunk or (bf16 and n % 8):
        raise ValueError(f"unsupported shape S={s} H={h} G={g} N={n} P={p} "
                         f"chunk={chunk}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    if b == 0 or s == 0:
        return y
    hpc = 0
    if bf16:
        for name, t in (("x", x), ("b_mat", b_mat), ("c_mat", c_mat)):
            if not _aligned16(t):
                raise ValueError(
                    f"{name}: the bf16 kernel copies 16-byte rows; base "
                    f"{t.data_ptr() % 16} bytes off the 16-byte grid or "
                    f"strides {t.stride()} not multiples of 8 elements")
        hpc = head_block(b, s // chunk, h, g,
                         _sm_count(x.get_device()) * ctas_per_sm(p))
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *a.stride(),
                                       *b_mat.stride()[:3],
                                       *c_mat.stride()[:3])
    status = build.library().repro_ssd_intra_chunk(
        x.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        y.data_ptr(), b, s, h, g, n, p, chunk, hpc, int(bf16), strides,
        build.stream_handle(x.device))
    build.check(status, "ssd_intra_chunk")
    LAUNCHES["ssd_intra_chunk"] += 1
    return y
