"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, llama-arch small.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=1.0e4,
    tie_embeddings=True,
)
