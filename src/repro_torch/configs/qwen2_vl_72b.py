"""qwen2-vl-72b [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. M-RoPE; dynamic
resolution.  The vision frontend is a stub: the prefill takes precomputed
patch embeddings (n_vision_tokens, d_model) that are prepended to the text
sequence; M-RoPE positions (temporal/h/w) are computed for both segments.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1.0e6,
    rope_mode="mrope",
    use_bias=True,
    n_vision_tokens=256,
)
