"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.

16 experts, top-4, fine-grained MoE. [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="dbrx-132b", family="moe", block_type="attn",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab_size=100352, rope_theta=500_000.0,
        moe=MoEConfig(n_experts=16, top_k=4, expert_d_ff=10752),
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=96),
    )


register("dbrx-132b", full, smoke)
