"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) d_ff=1408 vocab=151936; 60 routed top-4 +
4 shared experts (the HF model's single 5632-wide shared expert == 4×1408;
we implement 4 shared experts of moe_d_ff each, equivalent capacity).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    rope_theta=1.0e6,
    use_bias=True,  # qwen qkv bias
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
)
