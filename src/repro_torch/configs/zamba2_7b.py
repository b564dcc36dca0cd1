"""zamba2-7b [arXiv:2411.15242; unverified].

81 Mamba2 layers, d_model=3584, d_ff=14336, vocab=32000, ssm_state=64, plus a
SHARED attention block (32H, kv=32, d_head 112) applied every 6 mamba
layers (weights reused at each application, Zamba2's shared-block design).
Layout: 13 x (6 mamba + shared attn) + 3 tail mamba layers.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1.0e4,
    ssm_state=64,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_expand=2,
    shared_attn_every=6,
    sub_quadratic=True,
)
