"""Convert float model params to the quantized serving form.

Counterpart of ``repro.quant.convert``.  For ``mode="w8a8"`` every linear
param dict ``{"w": [in, out]}`` becomes ``{"w_q": int8 [out, in],
"scale": f32 [out]}``; for ``mode="w4a16"`` ``{"w_p4": uint8 [out, in//2],
"scale4": f32 [out, ng]}`` (bias kept in both); embeddings and norms stay
in their float dtype.  (The JAX version also exempts MoE routers; the port
has no router yet.)

W4A16 follows the reference's outcome, defect included: JAX stacks the
layer linears ``[L, in, out]`` and ``_quantize_w4`` falls back to W8A8 for
any stacked (or odd-width) weight, so on the dense family only ``lm_head``
comes out W4A16.  The port's layers are an unstacked list, so it applies
the same fallback to everything under ``"layers"``.

Quantization runs on the tensors' own device, one weight matrix at a time;
with ``consume=True`` each float matrix is dropped from the input as soon
as its quantized form exists, so peak memory stays near the float model
plus one matrix.
"""

from __future__ import annotations

import torch


def _quantize_w(w: torch.Tensor) -> dict:
    """w: [in, out] float -> per-output-channel symmetric int8 [out, in]."""
    wt = w.float().T                                    # [out, in]
    absmax = wt.abs().amax(-1)
    scale = torch.clamp_min(absmax / 127.0, 1e-8)
    w_q = torch.clamp(torch.round(wt / scale[:, None]), -127, 127)
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


def quantize_params(params, consume: bool = False, mode: str = "w8a8",
                    _stacked: bool = False):
    """Recursively rewrite linear dicts into quantized form (``mode``
    ``"w8a8"`` or ``"w4a16"``).

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
        return {k: quantize_params(v, consume, mode,
                                   _stacked or k == "layers")
                for k, v in params.items()}
    if isinstance(params, list):
        return [quantize_params(v, consume, mode, _stacked) for v in params]
    return params
