"""deepseek-v2-lite-16b [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff=1408(MoE) vocab=102400; MLA kv_lora=512;
2 shared + 64 routed experts, top-6 (assignment header; the "160 routed" tail
note conflicts — we follow the primary spec, matching HF DeepSeek-V2-Lite).
First layer is dense with d_ff=10944 (HF config: first_k_dense_replace=1).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=192,  # qk_nope(128) + qk_rope(64)
    d_ff=1408,
    vocab_size=102400,
    rope_theta=1.0e4,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
    dense_d_ff=10944,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
