"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 vocab=102400.

MLA (kv_lora=512), 2 shared + 160 routed experts top-6, first layer dense
(d_ff 12288). [arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                     register)


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-v2-236b", family="moe", block_type="attn",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288,                # dense-FFN layers (layer 1)
        vocab_size=102400, rope_theta=10_000.0,
        moe=MoEConfig(n_experts=160, top_k=6, n_shared=2,
                      expert_d_ff=1536, first_dense_layers=1),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1,
                      expert_d_ff=32, first_dense_layers=1),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    )


register("deepseek-v2-236b", full, smoke)
