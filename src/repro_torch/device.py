"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is
present: nothing falls back to the CPU quietly.  The CPU is used only when
a caller asks for it (``device="cpu"``), and there every kernel wrapper
takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain versions on the CPU")
        # float32 products outside the kernels (the lm_head) run in full
        # float32, as the JAX reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
