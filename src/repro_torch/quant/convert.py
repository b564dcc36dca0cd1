"""Convert float model params to the W8A8 serving form.

Counterpart of ``repro.quant.convert`` (``mode="w8a8"``): every linear
param dict ``{"w": [in, out]}`` becomes ``{"w_q": int8 [out, in],
"scale": f32 [out]}`` (bias kept); embeddings and norms stay in their
float dtype.  (The JAX version also exempts MoE routers; the port has no
router yet.)  Quantization runs on the tensors' own device, one
weight matrix at a time; with ``consume=True`` each float matrix is dropped
from the input as soon as its int8 form exists, so peak memory stays near
the float model plus one matrix.  The W4A16 mode waits for its kernel.
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


def quantize_params(params, consume: bool = False):
    """Recursively rewrite linear dicts into W8A8 form.

    ``consume=True`` deletes each float weight from ``params`` once it is
    quantized (the input is left without its ``"w"`` entries).
    """
    if isinstance(params, dict):
        w = params.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            out = _quantize_w(w)
            for k, v in params.items():
                if k != "w":
                    out[k] = v
            if consume:
                del params["w"]
            return out
        return {k: quantize_params(v, consume) for k, v in params.items()}
    if isinstance(params, list):
        return [quantize_params(v, consume) for v in params]
    return params
