"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

InternViT-6B frontend + InternLM2-20B backbone.  The frontend is a stub:
the batch carries precomputed ViT patch embeddings (``vision_embeds``),
which are projected and prepended to the token embeddings.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-26b", family="vlm", block_type="attn",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92553, rope_theta=1_000_000.0,
        frontend="vision", n_vision_tokens=256,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, n_vision_tokens=8,
    )


register("internvl2-26b", full, smoke)
