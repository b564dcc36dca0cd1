"""Convert float model params to the quantized serving form.

Counterpart of ``repro.quant.convert``.  For ``mode="w8a8"`` every linear
param dict ``{"w": [in, out]}`` becomes ``{"w_q": int8 [out, in],
"scale": f32 [out]}``; for ``mode="w4a16"`` ``{"w_p4": uint8 [out, in//2],
"scale4": f32 [out, ng]}`` (bias kept in both); embeddings and norms stay
in their float dtype.  As in JAX, a subtree under a key named ``router``
keeps full precision at any depth (``_path_exempt``), and the MoE family's
routed expert stacks ``up`` / ``gate`` / ``down`` (bare ``[E, in, out]``
tensors, not linear dicts) stay bf16 for the grouped GEMM; its shared
experts are linear dicts and quantize like any other.

W4A16 follows the reference's outcome, defect included: JAX stacks the
layer linears (``layers`` ``[L, in, out]``; the hybrid family's ``groups``
``[G, every, in, out]`` and ``tail`` ``[T, in, out]``) and ``_quantize_w4``
falls back to W8A8 for any stacked (or odd-width) weight, so only the
unstacked linears come out W4A16: ``lm_head`` and, on the hybrid family,
the ``shared`` block's (the moe family's shared experts sit in the stacked
``layers`` and come out W8A8).  The port keeps those stacks as lists, so it
applies the same fallback to everything under ``models.model.STACKED``.
The Mamba block's conv taps, ``dt_bias``, ``a_log``, ``d_skip`` and
``norm`` are not linear dicts and stay float, as in JAX.

Quantization runs on the tensors' own device, one weight matrix at a time;
with ``consume=True`` each float matrix is dropped from the input as soon
as its quantized form exists, so peak memory stays near the float model
plus one matrix.
"""

from __future__ import annotations

import torch

from repro_torch.models.model import STACKED


def _quantize_w(w: torch.Tensor) -> dict:
    """w: [in, out] float -> per-output-channel symmetric int8 [out, in].

    One float32 copy of ``w`` is the only temporary (1.66 GB for
    command-r-plus-104b's 12,288 x 33,792 FFN matrices): the row absmax is
    max(max, -min) and the division, rounding and clamp run in place on
    the copy, the same values as out of place."""
    wt = w.to(torch.float32, copy=True).T               # [out, in]
    absmax = torch.maximum(wt.amax(-1), wt.amin(-1).neg_())
    scale = torch.clamp_min(absmax / 127.0, 1e-8)
    w_q = wt.div_(scale[:, None]).round_().clamp_(-127, 127)
    return {"w_q": w_q.to(torch.int8).contiguous(),
            "scale": scale.to(torch.float32)}


def _quantize_w4(w: torch.Tensor, stacked: bool) -> dict:
    """W4A16 where the reference makes it, else W8A8 (see the module
    docstring): stacked layer weights and odd input widths fall back."""
    from repro_torch.quant.int4 import quantize_weight4

    if stacked or w.shape[0] % 2:
        return _quantize_w(w)
    q = quantize_weight4(w.float().T)
    return {"w_p4": q.w_packed.contiguous(), "scale4": q.scale}


def _path_exempt(key) -> bool:
    """True for a dict key that marks a quantization-exempt subtree (the
    MoE router: routing decisions are quantization-sensitive, and its
    weights are negligible)."""
    return key == "router"


def quantize_params(params, consume: bool = False, mode: str = "w8a8",
                    _stacked: bool = False):
    """Recursively rewrite linear dicts into quantized form (``mode``
    ``"w8a8"`` or ``"w4a16"``); a subtree under a ``router`` key is kept
    as it is.

    ``consume=True`` deletes each float weight from ``params`` once it is
    quantized (the input is left without its ``"w"`` entries).
    """
    if mode not in ("w8a8", "w4a16"):
        raise ValueError(f"unknown quantization mode: {mode!r}")
    if isinstance(params, dict):
        w = params.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            out = (_quantize_w(w) if mode == "w8a8"
                   else _quantize_w4(w, _stacked))
            for k, v in params.items():
                if k != "w":
                    out[k] = v
            if consume:
                del params["w"]
            return out
        return {k: v if _path_exempt(k) else
                quantize_params(v, consume, mode, _stacked or k in STACKED)
                for k, v in params.items()}
    if isinstance(params, list):
        return [quantize_params(v, consume, mode, _stacked) for v in params]
    return params
