"""Time other designs of the wkv6 backward kernel against the one the port
ships.

Builds ``src/repro_torch/csrc/wkv6_bwd.cu`` as shipped (dS's rows over a
cluster) and with other cluster sizes and launch bounds (its
``WKV6_BWD_CLUSTER`` and ``WKV6_BWD_MIN_WARPS``), the design it replaced
(one block a (b, h), ``tools/wkv6_bwd_one_block_a_head.cu``) and any other
source with the same C entry point named on the command line, one
``nvcc`` each, all started together.  Each design is held against the
plain backward (``wkv6_bwd_ref``) at rwkv6-7b's training shape [4, 2048,
64, 64] and at smaller and ragged shapes of every head size, by
chip_smoke's gate (each block of 64 steps within 1e-5·||plain|| +
1e-7·√n, ``bwd_block_errs``), with two calls bit-identical; then all are
timed in turns with CUDA events at the training shape, in one order and
then the reverse.  Needs an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/wkv6_bwd_designs.py [--out F] [NAME=PATH ...]

Prints the card's name and power limit, then one line a design: its
registers and spills at n = 64 (ptxas), its occupancy where the source
has ``wkv6_bwd_occupancy``, its worst gate and its two times.  ``--out``
also writes them as JSON.
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
from repro_torch.kernels.rwkv6_wkv import kernel as wkv
from repro_torch.kernels.rwkv6_wkv.ref import bwd_block_errs, wkv6_bwd_ref

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = loader.CSRC / "wkv6_bwd.cu"
OUT_DIR = ROOT / "build" / "wkv6_bwd_designs"
TRAIN = (4, 2048, 64, 64)               # rwkv6-7b's [B, T, H, n]
CHECKS = [TRAIN, (2, 1, 64, 64), (1, 9, 1, 64), (2, 1000, 4, 64),
          (2, 77, 5, 8), (2, 130, 4, 16), (1, 96, 3, 32), (1, 33, 2, 32)]
GATE = (1e-5, 1e-7)                     # rtol, atol (chip_smoke's float32)
REPS = 20
FP32_FLOPS = 67e12                      # float32 outside the tensor cores

# name -> (source, -D settings); the shipped kernel first
DESIGNS = {
    "shipped (a cluster of 2, launch bounds for 16 warps an SM)": (SHIPPED,
                                                                   {}),
    "a cluster of 4, 16 warps": (SHIPPED, {"WKV6_BWD_CLUSTER": 4}),
    "a cluster of 2, 8 warps": (SHIPPED, {"WKV6_BWD_MIN_WARPS": 8}),
    "one block a head": (ROOT / "tools" / "wkv6_bwd_one_block_a_head.cu",
                         {}),
}


def build(designs):
    """One nvcc a design, all at once: {name: (library, ptxas line of the
    walk back at n = 64)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, defs)) in enumerate(designs.items()):
        lib = OUT_DIR / f"libwkv6_bwd_design{i}.so"
        cmd = [loader._nvcc(), *loader.NVCC_FLAGS, f"-I{loader.CSRC}",
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
        # ptxas prints each entry function, then its spills and registers
        info, entry = [], ""
        for line in log.splitlines():
            m = re.search(r"(?:entry )?function '(\S+)'", line)
            if m:
                entry = m.group(1)
            if "wkv6_bwd_kernel" in entry and "ILi64E" in entry and (
                    "spill" in line or "Used" in line):
                info.append(line.split("ptxas info    :")[-1].strip())
        built[name] = (lib, "; ".join(info))
    return built


def launcher(lib: Path):
    dll = ctypes.CDLL(str(lib))
    fn = dll.wkv6_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = getattr(dll, "wkv6_bwd_occupancy", None)
    if occ is not None:
        occ.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int

    def run(r, k, v, w, u, s0, dy, dS_T, ck):
        B, T, H, n = r.shape
        dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
        du = torch.empty_like(u)
        ds0 = torch.empty_like(s0)
        du_part = torch.empty((B, H, n), device=r.device)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 dy.data_ptr(), u.data_ptr(), ck.data_ptr(),
                 dS_T.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dw.data_ptr(), ds0.data_ptr(),
                 du.data_ptr(), du_part.data_ptr(), B, T, H, n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib.name}: CUDA error {err}")
        return dr, dk, dv, dw, du, ds0

    def occupancy():
        if occ is None:
            return None
        out = (ctypes.c_int * len(wkv.OCCUPANCY_KEYS))()
        if occ(64, out):
            raise RuntimeError(f"{lib.name}: occupancy query failed")
        return dict(zip(wkv.OCCUPANCY_KEYS, out))
    return run, occupancy


def inputs(gen, B, T, H, n):
    """r, k, v, w, u, a non-zero s0, dy and dS_T drawn as chip_smoke's
    phase 16j draws them, and the shipped forward kernel's checkpoints."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    r, k, v = (randn(B, T, H, n, scale=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, T, H, n, scale=0.5) - 1.0))
    u, s0 = randn(H, n, scale=0.5), randn(B, H, n, n, scale=0.1)
    dy, dS_T = randn(B, T, H, n), randn(B, H, n, n)
    _, _, ck = wkv.wkv6_fwd(r, k, v, w, u, s0, checkpoints=True)
    return r, k, v, w, u, s0, dy, dS_T, ck


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
                    help="another source with wkv6_bwd.cu's C entry point")
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
    runs, occupancy = {}, {}
    for name, (lib, _) in built.items():
        runs[name], occ = launcher(lib)
        occupancy[name] = occ()

    gen = torch.Generator(device="cuda").manual_seed(0)
    gates = dict.fromkeys(runs, 0.0)
    for shape in CHECKS:
        x = inputs(gen, *shape)
        want = wkv6_bwd_ref(*x[:8])
        for name, run in runs.items():
            got, again = run(*x), run(*x)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{name} at {list(shape)}: two calls "
                                     "differ")
            g = max(bwd_block_errs(got, want, *GATE))
            if not g <= 1:
                raise AssertionError(f"{name} at {list(shape)}: at {g:.3g} "
                                     "of the block limit")
            gates[name] = max(gates[name], g)
        del x, want
        torch.cuda.empty_cache()

    x = inputs(gen, *TRAIN)
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(device_ms(lambda: runs[name](*x)))
    B, T, H, n = TRAIN
    bound = (14 * n * n + 16 * n) * B * T * H / FP32_FLOPS * 1e3
    print(f"wkv6_bwd {list(TRAIN)} float32, bound {bound:.4f} ms "
          f"(operations); {REPS} calls a time, designs timed in turns, then "
          "in reverse")
    rows = []
    for name in runs:
        rows.append(dict(design=name, ptxas=built[name][1],
                         occupancy=occupancy[name], max_gate=gates[name],
                         ms=times[name]))
        print(f"{name}: {built[name][1]}; occupancy {occupancy[name]}; "
              f"worst gate {gates[name]:.3g}; "
              + " / ".join(f"{t:.4f}" for t in times[name]) + " ms")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, shape=TRAIN,
                                            bound_ms=bound, designs=rows),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
