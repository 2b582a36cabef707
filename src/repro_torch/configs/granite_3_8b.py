"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

GQA dense decoder. [hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-8b", family="dense", block_type="attn",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab_size=49155, rope_theta=10_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )


register("granite-3-8b", full, smoke)
