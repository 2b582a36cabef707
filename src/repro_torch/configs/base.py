"""Config system of the LM scaffolding, field for field the reference's.

Every architecture is a :class:`ModelConfig`; the registry maps
``--arch <id>`` to a config factory.  Configs are plain frozen dataclasses
so they hash and print reproducibly, and a reference config file copies
over unchanged.  Only the architectures whose model branches the port
runs are registered (see ``_ensure_loaded``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Shape suite assigned to the LM family (see task spec).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Families that may run the long-context decode shape (sub-quadratic path).
LONG_CONTEXT_OK = ("ssm", "hybrid", "swa")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0           # shared (always-on) experts, DeepSeek-style
    expert_d_ff: int = 0        # per-expert hidden size (fine-grained MoE)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading dense-FFN layers (DeepSeek-V2 layer 1)
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention geometry."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2             # d_inner = expand * d_model (mamba branch)
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    block_type: str             # attn | rwkv | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    # Sliding-window pattern: window size for "local" layers; every
    # `global_every`-th layer (1-indexed) is global.  0 window => all global.
    local_window: int = 0
    global_every: int = 0

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # Modality stubs (spec: frontend provides precomputed embeddings).
    frontend: Optional[str] = None      # None | 'audio' | 'vision'
    n_codebooks: int = 0                # audio: EnCodec codebooks
    n_vision_tokens: int = 0            # vlm: patch-embedding count

    # ---- performance levers (the reference's; on the card attention
    # always runs the flash kernel, whatever attention_impl says, and a
    # full-sequence SSM the selective-scan kernel, whatever ssm_impl
    # says) ----
    remat_policy: str = "full"          # none | full | dots
    attention_impl: str = "naive"       # naive | chunked  (chunked = online-softmax, O(S) memory)
    attention_chunk: int = 1024
    vocab_loss_chunk: int = 0           # 0 = dense logits; >0 = chunked logsumexp loss
    sequence_parallel: bool = False     # shard S on "model" between blocks
    time_mix_impl: str = "scan"         # rwkv wkv: scan | chunked
    rwkv_chunk: int = 64
    ssm_impl: str = "scan"              # selective scan: scan | associative | chunked
    parallel_strategy: str = "tp"       # tp (megatron) | fsdp (ZeRO-3 gather)
    scan_layers: bool = True
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @property
    def supports_long_context(self) -> bool:
        if self.block_type in ("rwkv",):
            return True
        if self.block_type == "hybrid":
            return True
        # 5:1 local:global sliding-window counts as sub-quadratic-dominant.
        return self.local_window > 0 and self.global_every > 1

    def shapes(self) -> Tuple[str, ...]:
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context:
            names.append("long_500k")
        return tuple(names)

    # ------------------------------------------------------------------
    # Parameter counting (for MODEL_FLOPS = 6 N D in the roofline).
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, V = self.d_model, self.vocab_size
        total = V * d                                # embedding
        if not self.tie_embeddings:
            total += V * d                           # lm head
        if self.frontend == "audio" and self.n_codebooks:
            total += (self.n_codebooks - 1) * V * d  # extra heads + embeds
        per_layer = 0
        # --- attention / mixer ---
        if self.block_type in ("attn", "hybrid"):
            hd = self.head_dim
            if self.mla is not None:
                m = self.mla
                per_layer += d * m.q_lora_rank
                per_layer += m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            else:
                per_layer += d * self.n_heads * hd            # q
                per_layer += 2 * d * self.n_kv_heads * hd     # k, v
                per_layer += self.n_heads * hd * d            # o
        if self.block_type == "rwkv":
            # r,k,v,g,o projections + decay/mix loras (approx, dominated by 5 d^2)
            per_layer += 5 * d * d + 6 * d * 96
        if self.block_type == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            per_layer += d * 2 * di + di * d + di * (self.ssm.d_state * 2 + 1) + di * self.ssm.d_conv
        # --- ffn ---
        if self.moe is not None and self.moe.n_experts:
            e_ff = self.moe.expert_d_ff or self.d_ff
            routed = 3 * d * e_ff * self.moe.n_experts
            shared = 3 * d * e_ff * self.moe.n_shared
            router = d * self.moe.n_experts
            n_moe = self.n_layers - self.moe.first_dense_layers
            total += n_moe * (routed + shared + router)
            total += self.moe.first_dense_layers * 3 * d * self.d_ff
            if active_only:
                total -= n_moe * routed
                total += n_moe * 3 * d * e_ff * self.moe.top_k
        else:
            if self.block_type == "rwkv":
                per_layer += 2 * d * self.d_ff        # rwkv channel-mix: 2 mats
            else:
                per_layer += 3 * d * self.d_ff        # swiglu: w1, w2, w3
        total += self.n_layers * per_layer
        total += self.n_layers * 2 * d                # norms
        return int(total)

    def kv_cache_bytes(self, batch: int, seq: int, dtype_bytes: int = 2) -> int:
        """Global KV-cache (or recurrent-state) footprint for decode."""
        if self.block_type == "rwkv":
            H = self.d_model // 64
            return self.n_layers * batch * H * 64 * 64 * 4 + self.n_layers * batch * self.d_model * 4
        per_tok = 0
        if self.mla is not None:
            per_tok = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
        else:
            per_tok = 2 * self.n_kv_heads * self.head_dim
        size = self.n_layers * batch * seq * per_tok * dtype_bytes
        if self.block_type == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * self.d_model
            size += self.n_layers * batch * di * self.ssm.d_state * 4
        return int(size)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(table)}")
    return table[arch_id]()


def list_archs() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # the other architectures register with their model branches
    # (ROADMAP, LM slices)
    from repro_torch.configs import (  # noqa: F401
        gemma3_1b, hymba_1_5b, rwkv6_7b)
