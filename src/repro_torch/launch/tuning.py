"""Per-cell performance configuration (the model cells' levers), kernel
tuning seeds and task-intrinsic work counts of the counting kernels.

Model-cell profiles (``cell_config``), the reference's two:

* ``baseline`` — the paper-faithful starting point: naive attention
  where the scores fit, chunked where an S² tensor never could, dense
  vocab loss, full remat, minimal grad-accum.
* ``tuned``    — the reference's hillclimbed settings (chunked
  online-softmax attention at 32k, remat policy, grad-accum, MoE
  grad-accum, sequence parallelism for the 32k prefill).

``shape_flops_bytes`` is shared by the algorithm cost model, the
cost-model policy's autotune seeding and the roofline bounds.

The tuning seeds (``kernel_candidates`` / ``estimate_cost_us`` /
``default_config`` / ``seed_order``) are the config spaces the autotuner
sweeps for the mining and serving kernels and a roofline cost model over
:mod:`repro_torch.launch.roofline` that orders the sweep and supplies the
cold-cache default: when :mod:`repro_torch.kernels.autotune` has no
measurement for a (kernel, shape bucket, device kind), the argmin of the
*estimated* costs is used, so a missing or corrupt cache degrades to the
roofline-seeded default instead of erroring.

The config space is the variant alone.  The reference's candidates also
name Pallas block shapes (``bn``/``bm``/``bi``/``bb``/``br``/``bw``); a
CUDA launcher here derives its launch geometry from the call's shape
(``geometry()`` beside each kernel), so there is no tile to tune.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.roofline import (B1_OPS, HBM_BW, INT8_OPS,
                                         LAUNCH_FLOOR_S)

_BIG_VOCAB = 100_000


def pick_vocab_chunk(vocab: int, target: int = 8192,
                     max_chunk: int = 16384) -> int:
    """Largest divisor of `vocab` ≤ max_chunk (0 if only trivial divisors):
    the chunked-logsumexp loss needs V % chunk == 0.  When the vocab is
    16-divisible we also keep the chunk aligned to the per-device vocab
    shard (V/16) so the reshape keeps its "model" sharding."""
    base = vocab // 16 if vocab % 16 == 0 else vocab
    for c in range(min(max_chunk, base), 0, -1):
        if base % c == 0 and vocab % c == 0:
            return c if c > 64 else 0
    return 0


def cell_config(cfg: ModelConfig, shape_name: str, profile: str
                ) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Returns (model config with profile overrides, extra step options),
    the reference's levers, lever for lever.

    The tuned profile sets ``time_mix_impl="chunked"`` and
    ``ssm_impl="associative"`` at ``train_4k`` and ``prefill_32k``, as the
    reference does.  The port accepts both and computes the one function
    they name: the sequential WKV recurrence (``models/rwkv6.py``) and
    the sequential selective scan (``models/ssm.py``), each a kernel on
    the card and its plain loop on the CPU."""
    opts: Dict[str, Any] = {"grad_accum": 1}
    over: Dict[str, Any] = {}

    if profile == "baseline":
        over["remat_policy"] = "full"
        if shape_name == "train_4k":
            # naive attention fits at 4k with grad-accum; S² is sharded
            over["attention_impl"] = "naive"
            opts["grad_accum"] = 8
        elif shape_name == "prefill_32k":
            # a 32k² f32 score tensor can never be resident -> chunked
            # even in the baseline
            over["attention_impl"] = "chunked"
            over["attention_chunk"] = 2048
        else:
            over["attention_impl"] = "naive"
        return cfg.replace(**over), opts

    # ---- tuned profile (the reference's final choices) ----
    over["remat_policy"] = "full"
    if shape_name == "train_4k":
        # the reference measured that at 4k, with head-sharded scores,
        # naive attention beats the chunked scan on HBM traffic, and that
        # sequence parallelism doubles the all-reduce volume of these
        # collective-bound cells -> both off.
        over["attention_impl"] = "naive"
        over["sequence_parallel"] = False
        opts["grad_accum"] = 8
        if cfg.moe is not None and cfg.moe.n_experts:
            opts["grad_accum"] = 16      # MoE dispatch working-set fit
    else:
        # 32k+ sequences: S² scores can never be resident -> online-softmax
        # chunks; these cells are memory-dominant, where sequence
        # parallelism's sharded residual saves win.
        over["attention_impl"] = "chunked"
        over["attention_chunk"] = 2048
        if shape_name == "prefill_32k":
            over["sequence_parallel"] = True
    if shape_name in ("train_4k", "prefill_32k"):
        # full-sequence recurrences: the reference's chunked WKV and
        # log-depth SSM scan (the baseline keeps its sequential scans)
        over["time_mix_impl"] = "chunked"
        over["ssm_impl"] = "associative"
    # Chunked logsumexp loss: the reference measured it net-negative at
    # these shapes, even for vocabs that are not 16-divisible (replicated
    # [T, V] logits fit at 4k and the chunk loop re-reads the weights).
    # The lever stays available (`vocab_loss_chunk`) for configs whose
    # logits do not fit.
    return cfg.replace(**over), opts

TUNABLE_KERNELS = ("support_count", "intersect_count", "rule_match")

# the implementations each kernel family can dispatch to (ops wrappers)
VARIANTS = {"support_count": ("packed", "mxu"),
            "intersect_count": ("packed",),
            "rule_match": ("packed", "mxu")}


def shape_flops_bytes(kernel: str, shape: Tuple[int, ...]
                      ) -> Tuple[float, float]:
    """Task-intrinsic (flops, bytes) for one kernel shape — the variant-
    independent work the containment test costs, used to price a
    formulation at a kernel's effective peak/bandwidth and to turn a
    measured wall into effective peak/bandwidth for CostModelPolicy
    seeding."""
    if kernel == "intersect_count":
        # one AND+popcount+add per word-pair ≙ the 2·32 bit-ops the dense
        # formulation would spend on those 32 items (64 flops per word)
        m, w = shape
        return 64.0 * m * w, float(8 * m * w + 4 * m)
    n, m, i = shape
    flops = 2.0 * n * m * i
    bytes_ = float(n * i + m * i + 4 * m + (4 * n * m
                                            if kernel == "rule_match" else 0))
    return flops, bytes_


def kernel_candidates(kernel: str, shape: Tuple[int, ...]
                      ) -> List[Dict[str, Any]]:
    """The swept config space for one kernel at one (padded) shape.

    support_count:   shape = (N, M, I) — transactions, candidates, items.
    intersect_count: shape = (M, W)    — candidate rows, packed tid words.
    rule_match:      shape = (B, R, I) — queries, rule rows, items.
    Every candidate is ``{"variant": ...}``; all compute bit-identical
    results (the tuner holds each to the oracle), so any of them is safe.
    """
    if kernel not in TUNABLE_KERNELS:
        raise ValueError(f"unknown tunable kernel {kernel!r} "
                         f"(known: {', '.join(TUNABLE_KERNELS)})")
    return [{"variant": v} for v in VARIANTS[kernel]]


def estimate_cost_us(kernel: str, shape: Tuple[int, ...],
                     config: Dict[str, Any]) -> float:
    """Roofline-seeded cost estimate (µs) of one launch of a variant.

    The larger of its operations at its unit's rate and its bytes (each
    input read once, each output written once) over HBM, plus the launch
    floor.  ``mxu`` reads int8 bitmaps and does 2·N·M·I ops on the int8
    tensor cores; ``packed`` reads 32 items a word and does N·M·I bit
    AND-popcount-adds on the binary ones.  The intersect kernel's one
    variant is priced by its bytes.
    """
    if kernel == "intersect_count":
        m, w = shape
        seconds = (8.0 * m * w + 4.0 * m) / HBM_BW
    else:
        n, m, i = shape
        out = 4.0 * n * m if kernel == "rule_match" else 4.0 * m
        if config["variant"] == "mxu":
            ops_s = 2.0 * n * m * i / INT8_OPS
            in_bytes = float(n * i + m * i)
        else:
            ops_s = float(n) * m * i / B1_OPS
            in_bytes = (n + m) * i / 8.0
        seconds = max(ops_s, (in_bytes + 4.0 * m + out) / HBM_BW)
    return (seconds + LAUNCH_FLOOR_S) * 1e6


def default_config(kernel: str, shape: Tuple[int, ...]) -> Dict[str, Any]:
    """Cold-cache fallback: argmin of the roofline estimates (no
    measurement, deterministic — ties broken by the config's repr)."""
    cands = kernel_candidates(kernel, shape)
    return min(cands, key=lambda c: (estimate_cost_us(kernel, shape, c),
                                     sorted(c.items()).__repr__()))


def seed_order(kernel: str, shape: Tuple[int, ...],
               cands: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Sweep order: cheapest estimate first, so a truncated (smoke) sweep
    still measures the configs the roofline model believes in."""
    return sorted(cands, key=lambda c: estimate_cost_us(kernel, shape, c))
