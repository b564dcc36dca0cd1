"""whisper-small [arXiv:2212.04356; unverified].

12L enc + 12L dec, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
Encoder-decoder with the conv audio front end stubbed: the model takes
precomputed frame embeddings (encoder_seq=1500, d_model).  Learned
positions.  The port's copy of ``repro.configs.whisper_small``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    rope_mode="learned",
    use_bias=True,
    gated_ffn=False,
    norm="ln",
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq=1500,
)
