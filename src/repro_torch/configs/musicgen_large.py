"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens, 4 codebooks with delay interleaving.
The frontend is a stub: the batch carries precomputed frame embeddings
(``frames``); the model owns per-codebook LM heads. [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="musicgen-large", family="audio", block_type="attn",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048, rope_theta=10_000.0,
        frontend="audio", n_codebooks=4,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, n_codebooks=2,
    )


register("musicgen-large", full, smoke)
