"""mamba2-130m [arXiv:2405.21060; unverified].

24L d_model=768 attention-free, vocab=50280, ssm_state=128, SSD (state-space
duality) with headdim=64 (nheads = 2*768/64 = 24), ngroups=1, conv=4.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    rope_mode="none",
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
    sub_quadratic=True,
)
