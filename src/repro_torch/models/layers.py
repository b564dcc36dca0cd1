"""Shared model layers: norms, RoPE and M-RoPE, linear (float, W8A8 or
W4A16), MLP.

PyTorch counterparts of ``repro.models.layers``, formula for formula, so
that the same inputs give the same numbers up to float rounding order (and
bit for bit in the int8 product).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.int8_pagegemv.ops import int8_gemm
from repro_torch.kernels.w4a16_gemv.ops import w4a16_gemm
from repro_torch.quant.int8 import INV127


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Linear: params are {"w": [in, out] float}, the W8A8 form
# {"w_q": int8 [out, in], "scale": f32 [out]}, or the W4A16 form
# {"w_p4": uint8 [out, in//2], "scale4": f32 [out, ng]}
# (+ optional {"b": [out]} on any of them).
# ---------------------------------------------------------------------------


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in params:
        y = _w8a8_matmul(params["w_q"], params["scale"], x)
    elif "w_p4" in params:
        y = _w4a16_matmul(params["w_p4"], params["scale4"], x)
    else:
        y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def _w8a8_matmul(w_q: torch.Tensor, scale: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y[..., out] = dequant(int8 matmul), with per-token dynamic activation
    quantization: one scale per row of x, absmax over the feature axis.

    The JAX source spells the scale ``absmax / 127.0``, but the JAX engine
    only ever runs it under ``jit`` (its layers sit inside ``lax.scan``),
    where XLA rewrites a division by a constant as a multiply by the
    float32 reciprocal; the two differ in the last bit for ~4.5% of
    inputs.  The port computes what the jitted engine computes:
    ``absmax * float32(1/127)``.  The int8 x int8 -> int32 product is the
    B2 kernel on CUDA."""
    xf = x.float()
    absmax = torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-8)
    x_scale = absmax * INV127
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    lead = x.shape[:-1]
    acc = int8_gemm(x_q.reshape(-1, x.shape[-1]), w_q).reshape(
        *lead, w_q.shape[0])
    # (acc * scale) * x_scale, rounded as written, in place: at a prefill
    # group of qwen2-vl-72b each float32 [3072, 29568] copy is 363 MB
    y = acc.float()
    del acc
    return y.mul_(scale.float()).mul_(x_scale).to(x.dtype)


def _w4a16_matmul(w_p4: torch.Tensor, scale4: torch.Tensor,
                  x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y[..., out] = float32 x @ dequantized W4 weights, cast to
    ``out_dtype`` (default x's).  The JAX layer dequantizes and multiplies;
    the B4 kernel on CUDA computes the same product with the nibbles
    unpacked in registers, from x in its own dtype (bf16 -> float32 is
    exact, so no float32 copy of x is made)."""
    lead = x.shape[:-1]
    y = w4a16_gemm(x.reshape(-1, x.shape[-1]).contiguous(), w_p4, scale4)
    return y.reshape(*lead, w_p4.shape[0]).to(out_dtype or x.dtype)


def _w4a16_weight(w_p4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """Dequantize packed-nibble W4 weights to f32 [in, out]."""
    from repro_torch.quant.int4 import QuantizedLinear4, dequantize4

    q = QuantizedLinear4(w_packed=w_p4, scale=scale4, h=w_p4.shape[0],
                         w=2 * w_p4.shape[1])
    return dequantize4(q).T


def dense_weight(params: dict) -> torch.Tensor:
    """Materialize the float [in, out] weight of a (possibly quantized)
    linear."""
    if "w" in params:
        return params["w"]
    if "w_p4" in params:
        return _w4a16_weight(params["w_p4"], params["scale4"])
    return (params["w_q"].float() * params["scale"][:, None].float()).T


def init_linear(gen: torch.Generator, d_in: int, d_out: int, use_bias: bool,
                dtype: torch.dtype, device: torch.device) -> dict:
    # scaled in place: one float32 draw alive, the same bits
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device).mul_(d_in ** -0.5)
    p = {"w": w.to(dtype)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


# rows per float32 product where a row's bits must not depend on the rows
# around it: a library GEMM may pick its algorithm, and so its summation
# order, by the row count, so every product has this many rows (the last
# block zero-padded)
FIXED_ROWS = 8


def fixed_row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, V] as products of FIXED_ROWS rows each."""
    xf = x.reshape(-1, x.shape[-1])
    m = xf.shape[0]
    if m == 0:
        return x @ w
    xf = torch.cat([xf, xf.new_zeros(((-m) % FIXED_ROWS, xf.shape[1]))])
    out = torch.cat([xf[i:i + FIXED_ROWS] @ w
                     for i in range(0, len(xf), FIXED_ROWS)])
    return out[:m].reshape(*x.shape[:-1], w.shape[1])


def fixed_row_bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per group g, x[g] [M, K] @ w[g] [K, N] -> [G, M, N], as batched
    products of FIXED_ROWS rows each (the rows zero-padded), so a row's
    bits do not depend on the row count."""
    g, m, k = x.shape
    if m == 0:
        return x.new_zeros((g, 0, w.shape[2]))
    x = torch.cat([x, x.new_zeros((g, (-m) % FIXED_ROWS, k))], dim=1)
    out = torch.cat([torch.bmm(x[:, i:i + FIXED_ROWS], w)
                     for i in range(0, x.shape[1], FIXED_ROWS)], dim=1)
    return out[:, :m]


# ---------------------------------------------------------------------------
# RoPE (interleaved pairs x[0::2], x[1::2], as the JAX package rotates them)
# ---------------------------------------------------------------------------


def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] int. Rotate the first
    ``fraction * D`` dims; the rotation runs in float32 (bf16 * f32
    promotes) and casts back to x's dtype."""
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    freqs = rope_freqs(d_rot, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # [B, S, d_rot/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head dim cut into 3 sections (``d//3`` rounded
    down to even, twice, the rest in the third: 42/42/44 at D 128), each
    rotated by ``apply_rope`` with its own frequencies over its own
    position stream (temporal, height, width).  x: [B, S, H, D];
    positions3: [3, B, S] int."""
    d = x.shape[-1]
    sec = d // 3 - (d // 3) % 2
    secs = [sec, sec, d - 2 * sec - (d - 2 * sec) % 2]
    outs, off = [], 0
    for i, ds in enumerate(secs):
        outs.append(apply_rope(x[..., off:off + ds], positions3[i], theta))
        off += ds
    if off < d:
        outs.append(x[..., off:])
    return torch.cat(outs, dim=-1)


def mrope_grid_side(n_vision: int) -> int:
    """Vision-grid side length; also the first text position's offset (the
    text token at cache index ``idx`` sits at ``idx - n_vision + side`` in
    every stream), which decode continues."""
    return max(int(math.sqrt(max(n_vision, 1))), 1)


def mrope_positions(batch: int, seq: int, n_vision: int,
                    device=None) -> torch.Tensor:
    """M-RoPE position streams [3, batch, seq] (int64): vision tokens on a
    ``side x side`` grid at t = 0, text tokens sequential in all three
    streams from ``side`` on."""
    side = mrope_grid_side(n_vision)
    idx = torch.arange(seq, device=device)
    is_vis = idx < n_vision
    text = idx - n_vision + side
    pos = torch.stack([torch.where(is_vis, 0, text),
                       torch.where(is_vis, idx // side, text),
                       torch.where(is_vis, idx % side, text)])   # [3, S]
    return pos[:, None, :].expand(3, batch, seq)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn(params: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:
        g = linear(params["gate"], x)
        u = linear(params["up"], x)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(linear(params["up"], x).float(),
                   approximate="tanh").to(x.dtype)
    return linear(params["down"], h)


def init_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: int,
             dtype: torch.dtype, device: torch.device) -> dict:
    p = {"up": init_linear(gen, cfg.d_model, d_ff, cfg.use_bias, dtype,
                           device),
         "down": init_linear(gen, d_ff, cfg.d_model, cfg.use_bias, dtype,
                             device)}
    if cfg.gated_ffn:
        p["gate"] = init_linear(gen, cfg.d_model, d_ff, cfg.use_bias, dtype,
                                device)
    return p
