"""Where the wkv6 backward kernel's time goes: time it with one part taken
out at a time.

Builds ``src/repro_torch/csrc/wkv6_bwd.cu`` as shipped and, from its text,
copies that each leave one part of the work out: the walk's two xor
butterflies (the shuffles, selects and adds of the row and column sums),
its per-step shared loads of v and dy (each step reads the chunk's first
row instead), the recompute of the chunk's states, the step sums (dy . v
and sum r u k) and the per-chunk outputs.  Such a copy computes wrong
gradients: only its time means anything.  Each is timed in turns with
CUDA events at rwkv6-7b's training shape [4, 2048, 64, 64] and at 132 CTAs
(one (b, h) a cluster, one CTA an SM), in one order and then the reverse.
Needs an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/wkv6_bwd_ablations.py [--out FILE]

Prints the card's name and power limit, then one line a copy: its
registers (ptxas) and its times.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import loader

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "wkv6_bwd_ablations"
SHAPES = [(4, 2048, 64, 64), (1, 2048, 66, 64)]


def _designs():
    spec = importlib.util.spec_from_file_location(
        "wkv6_bwd_designs", ROOT / "tools" / "wkv6_bwd_designs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drop(text: str, old: str, new: str = "") -> str:
    if text.count(old) != 1:
        raise ValueError(f"the source no longer has {old!r} once")
    return text.replace(old, new)


def copies(src: str) -> dict:
    """{name: source}: the shipped text, then one copy a part left out."""
    walk_v = "        load_cols<C>(sv + j * N, lo, hi, vc);\n"
    walk_dy = "        load_cols<C>(sdy + j * N, lo, hi, yc);\n"
    out = {"shipped": src}
    out["no butterflies in the walk"] = _drop(
        _drop(src, "      xor_reduce<8, 1, kRL>(x, lane);\n"),
        "      xor_reduce<2 * C, kRL, 32, kSwap>(pvp, lane);\n")
    out["no loads of v and dy a step"] = _drop(
        _drop(src, walk_v + walk_dy,
              "        load_cols<C>(sv, lo, hi, vc);\n"
              "        load_cols<C>(sdy, lo, hi, yc);\n"),
        "        load_cols<C>(sv + j * N, lo, hi, vc);\n#pragma unroll\n"
        "        for (int e = 0; e < C; ++e) s[e] = ww",
        "        load_cols<C>(sv, lo, hi, vc);\n#pragma unroll\n"
        "        for (int e = 0; e < C; ++e) s[e] = ww")
    out["no recompute"] = _drop(src, "      if (j + 1 < kCk) {\n",
                                "      if (j + 1 < kCk && T < 0) {\n")
    out["no step sums"] = _drop(src, "      step_sums(c - 1);\n")
    if src.count("      if (j < steps) {") != 2:
        raise ValueError("the source's outputs changed")
    out["no outputs"] = src.replace("      if (j < steps) {",
                                    "      if (j < steps && T < 0) {")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    designs = _designs()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    named = {}
    for i, (name, text) in enumerate(
            copies((loader.CSRC / "wkv6_bwd.cu").read_text()).items()):
        path = OUT_DIR / f"copy{i}.cu"
        path.write_text(text)
        named[name] = (path, {})
    t0 = time.perf_counter()
    built = designs.build(named)
    print(f"built {len(built)} copies in {time.perf_counter() - t0:.1f} s")
    runs = {name: designs.launcher(lib)[0] for name, (lib, _) in
            built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    designs.REPS = 10
    times = {name: {} for name in runs}
    for shape in SHAPES:
        x = designs.inputs(gen, *shape)
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                times[name].setdefault(str(list(shape)), []).append(
                    designs.device_ms(lambda: runs[name](*x)))
        del x
        torch.cuda.empty_cache()
    rows = []
    for name in runs:
        rows.append(dict(copy=name, ptxas=built[name][1], ms=times[name]))
        print(f"{name}: {built[name][1]}; " + "; ".join(
            f"{shape} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
            for shape, ts in times[name].items()))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, copies=rows),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
