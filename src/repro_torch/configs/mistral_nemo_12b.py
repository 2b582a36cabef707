"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

128k-context dense decoder, head_dim=128. [hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="mistral-nemo-12b", family="dense", block_type="attn",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )


register("mistral-nemo-12b", full, smoke)
