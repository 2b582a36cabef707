"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Parallel attention + Mamba heads fused per layer; ssm_state=16; sliding-window
attention on all but 3 global layers. [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="hymba-1.5b", family="hybrid", block_type="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab_size=32001, rope_theta=10_000.0,
        local_window=1024, global_every=16,  # layers 16, 32 global (+ first handled as local)
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, local_window=16, global_every=2,
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    )


register("hymba-1.5b", full, smoke)
