"""Time other designs of the wkv6 kernel against the one the port ships.

Builds ``src/repro_torch/csrc/wkv6.cu`` as shipped (8 x 4 register tiles,
16 steps a stage, 3 stages) and with other ring and tile settings (its
``WKV6_STEPS``, ``WKV6_STAGES``, ``WKV6_QUADS`` and ``WKV6_COLS``), the
design tried first (``tools/wkv6_four_threads_a_column.cu``) and any other
source with the same C entry point named on the command line, one
``nvcc`` each, all started together.  Each design is held against the
plain version (``wkv6_ref``) at rwkv6-7b's prefill shape [4, 2048, 64,
64] and at smaller and ragged shapes of every head size, with
chip_smoke's tolerance (5e-4), then all are timed in turns with CUDA
events at the prefill shape, in one order and then the reverse.  Needs
an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/wkv6_designs.py [--out FILE] [NAME=PATH ...]

Prints the card's name and power limit, then one line a design: its
registers at n = 64, its worst error and its two times.  ``--out`` also
writes them as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = loader.CSRC / "wkv6.cu"
OUT_DIR = ROOT / "build" / "wkv6_designs"
PREFILL = (4, 2048, 64, 64)             # rwkv6-7b's [B, T, H, n]
CHECKS = [PREFILL, (3, 77, 5, 64), (1, 1, 2, 64), (2, 40, 4, 16),
          (1, 96, 1, 32), (2, 64, 3, 8)]
TOLERANCE = 5e-4
REPS = 20
HBM_BW = 3.35e12                        # bytes/s, H100 SXM

# name -> (source, -D settings); the shipped kernel first
DESIGNS = {
    "shipped (8x4 tile, 16 steps, 3 stages)": (SHIPPED, {}),
    "16 steps, 2 stages": (SHIPPED, {"WKV6_STAGES": 2}),
    "16 steps, 4 stages": (SHIPPED, {"WKV6_STAGES": 4}),
    "8 steps, 3 stages": (SHIPPED, {"WKV6_STEPS": 8}),
    "32 steps, 3 stages": (SHIPPED, {"WKV6_STEPS": 32}),
    "4x4 tile": (SHIPPED, {"WKV6_QUADS": 1}),
    "4x8 tile": (SHIPPED, {"WKV6_QUADS": 1, "WKV6_COLS": 8}),
    "8x8 tile": (SHIPPED, {"WKV6_COLS": 8}),
    "16x4 tile": (SHIPPED, {"WKV6_QUADS": 4}),
    "four threads a column": (ROOT / "tools"
                              / "wkv6_four_threads_a_column.cu", {}),
}


def build(designs):
    """One nvcc a design, all at once: {name: (library, registers at n =
    64)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, defs)) in enumerate(designs.items()):
        lib = OUT_DIR / f"libwkv6_design{i}.so"
        cmd = [loader._nvcc(), *loader.NVCC_FLAGS,
               *(f"-D{k}={v}" for k, v in defs.items()), "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # ptxas prints each entry function, then its registers
        regs, entry = None, ""
        for line in log.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and "ILi64E" in entry:
                regs = int(m.group(1))
        built[name] = (lib, regs)
    return built


def launcher(lib: Path):
    dll = ctypes.CDLL(str(lib))
    fn = dll.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(r, k, v, w, u, s0):
        B, T, H, n = r.shape
        y = torch.empty_like(r)
        s_final = torch.empty_like(s0)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                 s_final.data_ptr(), B, T, H, n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name}: CUDA error {err}")
        return y, s_final
    return run


def inputs(gen, B, T, H, n):
    """r, k, v, w in (0, 1), u and a non-zero s0, drawn as chip_smoke's
    phase 9 draws them."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    return (*(randn(B, T, H, n, scale=0.5) for _ in range(3)),
            torch.exp(-torch.exp(randn(B, T, H, n, scale=0.5) - 1.0)),
            randn(H, n, scale=0.5), randn(B, H, n, n, scale=0.1))


def device_ms(fn) -> float:
    """Mean device time of ``fn`` over REPS launches queued behind a spin
    of the card, so that they run back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="write the results as JSON")
    ap.add_argument("extra", nargs="*", metavar="NAME=PATH",
                    help="another source with wkv6.cu's C entry point")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    designs = dict(DESIGNS)
    for spec in args.extra:
        name, _, path = spec.partition("=")
        designs[name] = (Path(path).resolve(), {})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    built = build(designs)
    print(f"built {len(built)} designs in {time.perf_counter() - t0:.1f} s")
    runs = {name: launcher(lib) for name, (lib, _) in built.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    errors = dict.fromkeys(runs, 0.0)
    for shape in CHECKS:
        x = inputs(gen, *shape)
        want = wkv6_ref(*x)
        for name, run in runs.items():
            got = run(*x)
            torch.cuda.synchronize()
            e = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
            if not (e <= TOLERANCE and all(bool(torch.isfinite(g).all())
                                           for g in got)):
                raise AssertionError(f"{name} at {list(shape)}: max abs "
                                     f"err {e:.3g} > {TOLERANCE}")
            errors[name] = max(errors[name], e)

    x = inputs(gen, *PREFILL)
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(device_ms(lambda: runs[name](*x)))
    B, T, H, n = PREFILL
    bound = 4 * (5 * B * T * H * n + 2 * B * H * n * n + H * n) / HBM_BW
    print(f"wkv6 {list(PREFILL)} float32, byte bound {bound * 1e3:.4f} ms; "
          f"{REPS} launches a time, designs timed in turns, then in "
          "reverse")
    rows = []
    for name in runs:
        regs = built[name][1]
        rows.append(dict(design=name, registers=regs,
                         max_abs_err=errors[name], ms=times[name]))
        print(f"{name}: {regs} registers, max abs err "
              f"{errors[name]:.3g}, "
              + " / ".join(f"{t:.4f}" for t in times[name]) + " ms")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, shape=PREFILL,
                                            bound_ms=bound * 1e3,
                                            designs=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
