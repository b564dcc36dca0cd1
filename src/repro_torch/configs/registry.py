"""Architecture registry: ``--arch <id>`` resolution for the port's drivers.

The configurations whose model code the port has: the dense family
(smollm-360m; chatglm3-6b, its rotary on half of each head and a bias on
every q/k/v and FFN linear, 32 query heads over 2 kv heads; internlm2-20b,
48 over 8; the paper's OPT / Llama-2 models), the moe family
(qwen2-moe-a2.7b) and the hybrid family (zamba2-7b), served through the
paged engine or in wave mode, the ssm family (mamba2-130m) and the audio
family (whisper-small), both served in wave mode.  The vlm and mla_moe
families join as their model code is ported.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.chatglm3_6b import CONFIG as CHATGLM3_6B
from repro_torch.configs.internlm2_20b import CONFIG as INTERNLM2_20B
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from repro_torch.configs.smollm_360m import CONFIG as SMOLLM_360M
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (SMOLLM_360M, CHATGLM3_6B, INTERNLM2_20B,
                        QWEN2_MOE_A2_7B, ZAMBA2_7B, MAMBA2_130M,
                        WHISPER_SMALL)}
ARCHS.update(PAPER_MODELS)


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
