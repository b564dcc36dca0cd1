"""The paper's own evaluation models (OPT family [arXiv:2205.01068] and
Llama-2 family [arXiv:2307.09288])."""

from repro_torch.configs.base import ModelConfig


def _opt(name, n_layers, d_model, n_heads, vocab=50272):
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, d_ff=4 * d_model,
        vocab_size=vocab, rope_mode="learned", use_bias=True,
        gated_ffn=False, norm="ln", tie_embeddings=True,
    )


OPT_6_7B = _opt("opt-6.7b", 32, 4096, 32)
OPT_13B = _opt("opt-13b", 40, 5120, 40)
OPT_30B = _opt("opt-30b", 48, 7168, 56)
OPT_66B = _opt("opt-66b", 64, 9216, 72)

LLAMA2_7B = ModelConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=11008, vocab_size=32000)
LLAMA2_13B = ModelConfig(
    name="llama2-13b", family="dense", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=40, d_ff=13824, vocab_size=32000)
LLAMA2_70B = ModelConfig(
    name="llama2-70b", family="dense", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab_size=32000)

PAPER_MODELS = {
    m.name: m for m in [OPT_6_7B, OPT_13B, OPT_30B, OPT_66B,
                        LLAMA2_7B, LLAMA2_13B, LLAMA2_70B]
}
