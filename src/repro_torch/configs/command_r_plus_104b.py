"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-plus; unverified].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000; GQA, no-bias,
Cohere parallel attention+FFN block, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75e4,
    parallel_block=True,
    tie_embeddings=True,
)
