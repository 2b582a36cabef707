"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.

RWKV-6 "Finch": data-dependent decay WKV recurrence, head_dim 64.
[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-7b", family="ssm", block_type="rwkv",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab_size=65536,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
    )


register("rwkv6-7b", full, smoke)
