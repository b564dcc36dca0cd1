"""Wrapper of the prefill flash attention kernel
(``csrc/flash_attention.cu``), causal or bidirectional.

``flash_attention(q, k, v, causal=True)`` with q ``[B, S, H, D]`` and k/v
``[B, Skv, Hkv, D]`` in the model's layout: causal, Skv == S (prefill
self-attention); bidirectional, any Skv (the whisper encoder's
self-attention and its decoder's cross-attention over the encoder's rows).
A CPU tensor takes the plain version
(``models.attention.chunked_attention(causal)``), which autograd
differentiates.  On a CUDA tensor:

* bf16 launches B3 (wgmma fed by TMA), which reads all three through their
  strides, within TMA's rules: the last axis contiguous, the other strides
  multiples of 8 elements, 16-byte aligned bases.  The two modes count
  their launches apart: ``flash_attention`` and ``flash_attention_bidir``.
  B3 has no backward: a call that autograd would differentiate raises.
* float32 (training; causal self-attention, D 64 or 128) goes through
  ``AttentionF32``, a ``torch.autograd.Function`` over the float32 pair
  (``csrc/flash_attention_f32.cu``): the forward kernel saves O and each
  row's log-sum-exp, the backward runs the dK/dV kernel (after delta =
  rowsum(dO * O), ``attention_f32_dkdv``) and the dQ kernel
  (``attention_f32_dq``).  Launches: ``flash_attention_f32``,
  ``flash_attention_f32_dkdv``, ``flash_attention_f32_dq``.

No CUDA path falls back to the plain version: a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# head dims beside every multiple of 8 up to 64 (deepseek-v2-lite-16b's
# reduced qk head of 24 among them): 112 zamba2-7b's shared block, 192
# deepseek-v2-lite-16b's MLA prefill (qk 128 + 64, v padded to it)
HEAD_DIMS = (112, 128, 192)


def head_dim_ok(d: int) -> bool:
    if 0 < d <= 64:
        return d % 8 == 0
    return d in HEAD_DIMS
# head dims of the float32 pair: the dense and vlm families' (smollm-360m
# 64; llama2-7b, qwen2-vl-72b 128)
F32_HEAD_DIMS = (64, 128)
LAUNCHES = {"flash_attention": 0, "flash_attention_bidir": 0,
            "flash_attention_f32": 0, "flash_attention_f32_dkdv": 0,
            "flash_attention_f32_dq": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensor on {q.device}")
    if q.dtype == torch.float32:
        check_f32_inputs(q, k, v, causal)
        return AttentionF32.apply(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the bf16 kernel (csrc/flash_attention.cu, B3) "
            "has no backward; train in float32 (AttentionF32)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device or t.dim() != 4:
            raise TypeError(f"{name} must be a 4-d bf16 tensor on {q.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: last axis must be contiguous and the "
                             f"other strides multiples of 8, got {t.stride()}")
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape \
            or (causal and skv != s):
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (causal={causal})")
    if not head_dim_ok(d) or h % hkv:
        raise ValueError(f"unsupported head layout H={h} Hkv={hkv} D={d}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention: no keys to attend")
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    name = "flash_attention" if causal else "flash_attention_bidir"
    status = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, skv, h, hkv, d, strides, float(d ** -0.5), int(causal),
        build.stream_handle(q.device))
    build.check(status, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# float32 causal attention and its gradient (csrc/flash_attention_f32.cu)
# ---------------------------------------------------------------------------


def check_f32_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True) -> None:
    """What the float32 pair takes: causal self-attention, q ``[B, S, H,
    D]`` and k/v ``[B, S, Hkv, D]`` float32 on one device, H % Hkv == 0, D
    in ``F32_HEAD_DIMS``, the last axis contiguous and the base and every
    other stride on the 16-byte grid (the kernels read rows as float4).
    Raises ``TypeError`` / ``ValueError`` on anything else."""
    if not causal:
        raise ValueError("flash_attention: the float32 kernels are causal "
                         "only")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.device != q.device or t.dim() != 4:
            raise TypeError(f"{name} must be a 4-d float32 tensor on "
                            f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
        if t.stride(-1) != 1 or any(st % 4 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: last axis must be contiguous and the "
                             f"other strides multiples of 4 elements on a "
                             f"16-byte base, got {t.stride()}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (causal self-attention)")
    if d not in F32_HEAD_DIMS or hkv == 0 or h % hkv:
        raise ValueError(f"unsupported head layout H={h} Hkv={hkv} D={d} "
                         f"(float32 kernels: D in {F32_HEAD_DIMS})")


def _qkv_strides(q, k, v):
    return (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])


def attention_f32_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (O [B, S, H, D], lse [B, H, S]), both float32
    and contiguous.  Checked inputs (``check_f32_inputs``)."""
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return o, lse
    status = build.library().repro_attention_f32_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, _qkv_strides(q, k, v),
        float(d ** -0.5), build.stream_handle(q.device))
    build.check(status, "flash_attention_f32")
    LAUNCHES["flash_attention_f32"] += 1
    return o, lse


def _check_rows(q: torch.Tensor, **rows: torch.Tensor) -> None:
    """The backward's operands beside q: contiguous float32, each of o /
    do / dq shaped as q, lse / delta [B, H, S]."""
    b, s, h, d = q.shape
    for name, t in rows.items():
        want = (b, h, s) if name in ("lse", "delta") else (b, s, h, d)
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.shape != want:
            raise ValueError(f"the float32 backward kernels take {name} "
                             f"contiguous float32 {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def attention_f32_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dK/dV kernel, after delta = rowsum(dO * O) from the same C
    entry: (dk, dv [B, S, Hkv, D], delta [B, H, S]), float32 and
    contiguous; o, lse and do contiguous."""
    _check_rows(q, o=o, lse=lse, do=do)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dk = torch.empty((b, s, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return dk, dv, delta
    status = build.library().repro_attention_f32_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, h, hkv, d, _qkv_strides(q, k, v),
        float(d ** -0.5), build.stream_handle(q.device))
    build.check(status, "flash_attention_f32_dkdv")
    LAUNCHES["flash_attention_f32_dkdv"] += 1
    return dk, dv, delta


def attention_f32_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lse: torch.Tensor, do: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """The dQ kernel: dq [B, S, H, D] float32, contiguous; reads the delta
    ``attention_f32_dkdv`` wrote."""
    _check_rows(q, lse=lse, do=do, delta=delta)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return dq
    status = build.library().repro_attention_f32_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, k.shape[2],
        d, _qkv_strides(q, k, v), float(d ** -0.5),
        build.stream_handle(q.device))
    build.check(status, "flash_attention_f32_dq")
    LAUNCHES["flash_attention_f32_dq"] += 1
    return dq


class AttentionF32(torch.autograd.Function):
    """Causal float32 attention on the card whose gradient is the backward
    kernels'.  Saves q, k, v, O and lse; the backward recomputes P from
    lse, so no [S, S] tensor is kept."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = attention_f32_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dk, dv, delta = attention_f32_dkdv(q, k, v, o, lse, do)
        return attention_f32_dq(q, k, v, lse, do, delta), dk, dv
