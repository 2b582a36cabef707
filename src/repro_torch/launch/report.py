"""Markdown tables of the dry run's records (``results/dryrun_torch/*.json``,
written by :mod:`repro_torch.launch.dryrun`): the dry run on each
production mesh, the skipped cells, and the roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.report [--profile tuned] \\
      > tables.md

The FLOPs, bytes and collective bytes are counts of a fake step's
dispatched ops, and the roofline seconds those counts over one H100's
data-sheet rates (:mod:`repro_torch.launch.roofline`): analytic figures
for an H100 mesh, not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

HBM_PER_CHIP_GB = 80.0          # NVIDIA H100 80GB HBM3


def load(out_dir="results/dryrun_torch") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _seconds(s) -> str:
    return "-" if s is None else f"{s:.0f}"


def dryrun_table(recs, profile="tuned", mesh=None) -> str:
    lines = ["| arch | shape | mesh | compile s | params (B) | active (B) | "
             "mem/dev GB | fits 80GB | flops/dev | HBM bytes/dev | "
             "coll bytes/dev | top collective |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if not r.get("ok") or r.get("profile") != profile:
            continue
        if mesh and r.get("mesh_mode") != mesh:
            continue
        peak = r["memory"]["peak_estimate_bytes"] / 1e9
        by_op = r["collectives"]["bytes_by_op"]
        top = max(by_op, key=by_op.get) if by_op else "-"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh_mode']} "
            f"| {_seconds(r['compile_s'])} | {r['params_total']/1e9:.2f} "
            f"| {r['params_active']/1e9:.2f} | {peak:.1f} "
            f"| {'✅' if peak <= HBM_PER_CHIP_GB else '❌'} "
            f"| {r['cost']['flops']:.2e} | {r['cost']['bytes_accessed']:.2e} "
            f"| {r['collectives']['total_bytes']:.2e} | {top} |")
    return "\n".join(lines)


def roofline_table(recs, profile="tuned", mesh="pod") -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL_FLOPS/counted | roofline frac | "
             "one-line bottleneck note |",
             "|---|---|---|---|---|---|---|---|---|"]
    notes = {
        "collective": "TP/EP wire volume; fewer/cheaper collectives move it",
        "memory": "HBM traffic; fusion/chunking/recompute-avoidance move it",
        "compute": "tensor-core bound; only better kernels/precision move "
                   "it",
    }
    for r in recs:
        if not r.get("ok") or r.get("profile") != profile:
            continue
        if r.get("mesh_mode") != mesh:
            continue
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3f} "
            f"| {rl['memory_s']:.3f} | {rl['collective_s']:.3f} "
            f"| **{rl['dominant']}** | {rl['useful_ratio']:.2f} "
            f"| {rl['roofline_fraction']:.4f} | {notes[rl['dominant']]} |")
    return "\n".join(lines)


def skipped_table(recs) -> str:
    lines = ["| arch | shape | mesh | reason |", "|---|---|---|---|"]
    seen = set()
    for r in recs:
        if not r.get("skipped"):
            continue
        key = (r["arch"], r["shape"])
        if key in seen:
            continue
        seen.add(key)
        lines.append(f"| {r['arch']} | {r['shape']} | both "
                     f"| {r['reason'][:60]}... |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="tuned")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    args = ap.parse_args()
    recs = load(args.out_dir)
    print("### Dry run (one node group, 16×16)\n")
    print(dryrun_table(recs, args.profile, mesh="pod"))
    print("\n### Dry run (two groups, 2×16×16)\n")
    print(dryrun_table(recs, args.profile, mesh="multipod"))
    print("\n### Skipped cells\n")
    print(skipped_table(recs))
    print("\n### Roofline (16×16)\n")
    print(roofline_table(recs, args.profile, mesh="pod"))


if __name__ == "__main__":
    main()
