"""Compiled rule index: ``List[Rule]`` lowered to dense, kernel-shaped arrays.

The mined rule list is a Python object that dies with the process; serving
needs the opposite — a deterministic, device-friendly layout the batched
rule-match kernel can consume directly:

  ante    uint8[Rp, Ip]   antecedent bitmaps, same item-minor / 128-lane
                          word layout as the mining transaction bitmaps
  sizes   f32[Rp]         |antecedent| per row (-1 on padded rows: an
                          all-zero row would subset-match every basket)
  cons    int32[Rp]       consequent item id per row (Ip on padded rows —
                          a dummy max-segment the ops wrapper slices away)
  conf / lift / support   f32[Rp] parallel scoring arrays (0 on padding)

One *row* is one (rule, consequent-item) pair: a rule whose consequent has
several items contributes one row per item, each carrying the rule's
statistics, and duplicate (antecedent, item) pairs keep the best row.  The
row order is a total order (confidence desc, support desc, lift desc,
antecedent, consequent — the ``generate_rules`` key) so the same rule set
always compiles to the same arrays — byte-identical across processes and
to the reference package's index, which the result cache relies on.

Rows are padded ("bucketed") to a multiple of ``r_bucket`` (kernel lanes)
and items to 128 lanes, so every index built from the same corpus shape
gives the kernels the same launch shape.

Persistence (``save``/``load``) goes through the checkpoint store, one
step per index version, in the reference package's format.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core.rules import Rule

_ARRAY_FIELDS = ("ante", "sizes", "conf", "lift", "support", "cons")


@dataclass(frozen=True)
class RuleIndex:
    """Immutable compiled form of a mined rule set (see module docstring)."""

    ante: np.ndarray        # uint8 [Rp, Ip]
    sizes: np.ndarray       # float32 [Rp], -1 on padding
    conf: np.ndarray        # float32 [Rp]
    lift: np.ndarray        # float32 [Rp]
    support: np.ndarray     # float32 [Rp]
    cons: np.ndarray        # int32 [Rp], Ip on padding
    n_rows: int             # true (rule, consequent-item) rows
    n_rules: int            # source rules before expansion
    n_items: int            # true item-universe size before lane padding
    version: int = 0        # monotonically bumped by refresh()

    # ------------------------------------------------------------------
    @property
    def n_rows_padded(self) -> int:
        return int(self.ante.shape[0])

    @property
    def n_items_padded(self) -> int:
        return int(self.ante.shape[1])

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in _ARRAY_FIELDS)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, rules: Sequence[Rule], n_items: int, *,
              r_bucket: int = 128, version: int = 0) -> "RuleIndex":
        """Deterministic lowering (stable total order; see module docstring)."""
        if n_items <= 0:
            raise ValueError(f"n_items must be positive, got {n_items}")
        if r_bucket <= 0 or r_bucket % 128:
            raise ValueError(
                "r_bucket must be a positive multiple of 128 (kernel lanes)")
        rows: List[Tuple[Tuple[int, ...], int, float, float, float]] = []
        for rule in rules:
            bad = [i for i in rule.antecedent + rule.consequent
                   if not 0 <= i < n_items]
            if bad:
                raise ValueError(f"rule {rule} references item ids {bad} "
                                 f"outside [0, {n_items})")
            for item in rule.consequent:
                rows.append((rule.antecedent, item, rule.confidence,
                             rule.lift, rule.support))
        # same total order as generate_rules, extended to expanded rows
        rows.sort(key=lambda t: (-t[2], -t[4], -t[3], t[0], t[1]))
        seen = set()
        dedup = []
        for row in rows:
            key = (row[0], row[1])
            if key not in seen:          # first occurrence is the best row
                seen.add(key)
                dedup.append(row)

        n_rows = len(dedup)
        Rp = max(r_bucket, n_rows + (-n_rows) % r_bucket)
        Ip = n_items + (-n_items) % 128
        ante = np.zeros((Rp, Ip), dtype=np.uint8)
        sizes = np.full(Rp, -1.0, dtype=np.float32)
        conf = np.zeros(Rp, dtype=np.float32)
        lift = np.zeros(Rp, dtype=np.float32)
        support = np.zeros(Rp, dtype=np.float32)
        cons = np.full(Rp, Ip, dtype=np.int32)
        for r, (a, item, c, lf, sp) in enumerate(dedup):
            ante[r, list(a)] = 1
            sizes[r] = len(a)
            conf[r] = c
            lift[r] = lf
            support[r] = sp
            cons[r] = item
        return cls(ante=ante, sizes=sizes, conf=conf, lift=lift,
                   support=support, cons=cons, n_rows=n_rows,
                   n_rules=len(rules), n_items=n_items, version=version)

    # ------------------------------------------------------------------
    # persistence through the checkpoint store (atomic, manifest-driven)
    # ------------------------------------------------------------------
    def save(self, index_dir: str) -> str:
        """Write this index as checkpoint step ``version`` under index_dir."""
        tree = {f: getattr(self, f) for f in _ARRAY_FIELDS}
        extra = {"kind": "rule_index", "n_rows": self.n_rows,
                 "n_rules": self.n_rules, "n_items": self.n_items,
                 "version": self.version}
        return ckpt_store.save(index_dir, self.version, tree, extra=extra)

    @classmethod
    def load(cls, index_dir: str,
             version: Optional[int] = None) -> "RuleIndex":
        if version is None:
            version = ckpt_store.latest_step(index_dir)
            if version is None:
                raise FileNotFoundError(f"no rule index under {index_dir}")
        flat, extra = ckpt_store.load_arrays(index_dir, version)
        if extra.get("kind") != "rule_index":
            raise ValueError(f"step {version} under {index_dir} is not a "
                             "rule index checkpoint")
        return cls(**{f: flat[f] for f in _ARRAY_FIELDS},
                   n_rows=extra["n_rows"], n_rules=extra["n_rules"],
                   n_items=extra["n_items"], version=extra["version"])

    # ------------------------------------------------------------------
    def same_arrays(self, other: "RuleIndex") -> bool:
        """Byte-identical array payloads (determinism / round-trip checks)."""
        return all(np.array_equal(getattr(self, f), getattr(other, f))
                   for f in _ARRAY_FIELDS)
