"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Width/depth-pruned Nemotron-4. [arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="minitron-8b", family="dense", block_type="attn",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=16384, vocab_size=256000, rope_theta=10_000.0,
        # 256k vocab: chunked vocab loss is the default-on lever here (§Perf)
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )


register("minitron-8b", full, smoke)
