"""Architecture registry: ``--arch <id>`` resolution for the port's drivers.

Only the configurations the port can serve are registered: the dense
family (smollm-360m and the paper's OPT / Llama-2 models).  The other
families join as their model code is ported.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.configs.smollm_360m import CONFIG as SMOLLM_360M

ARCHS: dict[str, ModelConfig] = {SMOLLM_360M.name: SMOLLM_360M,
                                 **PAPER_MODELS}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
