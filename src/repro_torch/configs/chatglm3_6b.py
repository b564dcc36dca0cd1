"""chatglm3-6b [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024. "RoPE 2d": rotary
applied to half of each head dim (rope_fraction=0.5). QKV bias (chatglm
uses add_qkv_bias=True).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_theta=1.0e4,
    rope_fraction=0.5,
    use_bias=True,
)
