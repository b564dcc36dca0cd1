"""Model configuration: the architecture description every layer reads.

The port's own copy of ``repro.configs.base.ModelConfig``: the same fields
and the same ``reduced()`` smoke-test shrink, so a config built here and
one built in the JAX package describe the same model.  The analytic
parameter counts of the JAX version (which need its planner) are not
carried over.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | mla_moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # --- positional / structural flags ---
    rope_theta: float = 1.0e4
    rope_fraction: float = 1.0  # chatglm3 "2d rope": rotary on half the head dim
    rope_mode: str = "standard"  # standard | mrope | learned | none
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r: attn and FFN in parallel
    use_bias: bool = False
    gated_ffn: bool = True  # SwiGLU-style; False -> 2-matrix GELU MLP
    norm: str = "rms"  # "rms" | "ln"
    norm_eps: float = 1e-5

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- vlm (qwen2-vl) ---
    n_vision_tokens: int = 0

    sub_quadratic: bool = False

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration of the same family (runs on 1 CPU)."""
        scale = {
            "n_layers": min(self.n_layers, 2),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(max(self.n_kv_heads, 1), 2) if self.n_heads else 0,
            "d_head": 16,
            "d_ff": 128,
            "vocab_size": 256,
        }
        extra = {}
        if self.n_experts:
            extra.update(n_experts=8, top_k=min(self.top_k, 2), moe_d_ff=32,
                         n_shared_experts=min(self.n_shared_experts, 1))
        if self.first_k_dense:
            extra.update(first_k_dense=1, dense_d_ff=128)
        if self.kv_lora_rank:
            extra.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                         v_head_dim=16)
        if self.ssm_state:
            extra.update(ssm_state=16, ssm_headdim=16, ssm_ngroups=1)
        if self.shared_attn_every:
            extra.update(shared_attn_every=2, n_layers=5)
        if self.is_encoder_decoder:
            extra.update(n_encoder_layers=2, encoder_seq=16)
        if self.n_vision_tokens:
            extra.update(n_vision_tokens=8)
        return dataclasses.replace(self, name=self.name + "-reduced",
                                   **{**scale, **extra})
