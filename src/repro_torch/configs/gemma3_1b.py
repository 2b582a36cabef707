"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global sliding-window attention (window 512), 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma3-1b", family="dense", block_type="attn",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab_size=262144, rope_theta=1_000_000.0,
        tie_embeddings=True,
        local_window=512, global_every=6,   # layers 6,12,18,24 global; rest local
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, local_window=16, global_every=2,
    )


register("gemma3-1b", full, smoke)
