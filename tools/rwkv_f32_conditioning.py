"""How far float32 rounding inside the WKV moves a float32 rwkv6-7b train
step's gradients, by depth.

Draws rwkv6-7b at full width in float32 (seeded random weights) at each
depth named on the command line and takes one ``_loss_and_grads`` at [1 x
512] tokens three ways: with the wkv6 kernels, with the plain WKV
(``wkv6_plain``) under autograd, and with the plain WKV in float64 under
autograd (its output cast back to float32; everything else as before).
Prints the losses and, for each pair, the leaves that differ most, as a
share of each leaf's max |gradient|.  The plain float32 WKV against the
float64 one shows how ill-conditioned the step is; the kernel against the
float64 one shows where the kernel sits within that.  Needs an NVIDIA
card:

    PYTHONPATH=src python tools/rwkv_f32_conditioning.py [--layers 1 2 8]
"""
from __future__ import annotations

import argparse
import subprocess
import time
from unittest import mock

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels.rwkv6_wkv import kernel as wkv
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import rwkv6
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

BATCH = (1, 512)


def plain32(r, k, v, w, u, s0):
    return wkv.wkv6_plain(r, k, v, w, u, s0)


def plain64(r, k, v, w, u, s0):
    y, s_final, _ = wkv.wkv6_checkpoints_plain(
        *(x.double() for x in (r, k, v, w, u, s0)))
    return y.float(), s_final.float()


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    B, S = BATCH
    for L in args.layers:
        cfg = get_config("rwkv6-7b").replace(
            n_layers=L, param_dtype="float32", activ_dtype="float32")
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0))
        batch = train_mod.make_batch_for(cfg, pipe, 0, B, S, dev)
        t0 = time.perf_counter()
        runs = {"kernel": steps._loss_and_grads(cfg, params, batch)}
        for name, fn in (("plain32", plain32), ("plain64", plain64)):
            with mock.patch.object(rwkv6, "wkv6", fn):
                runs[name] = steps._loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
        print(f"{L} layers [{B} x {S}] ({time.perf_counter() - t0:.1f} s): "
              "losses " + ", ".join(f"{k} {float(v[0]):.7f}"
                                    for k, v in runs.items()))
        paths = ["/".join(p) for p, _ in store._paths(runs["kernel"][1])]
        leaves = {k: adamw.tree_leaves(v[1]) for k, v in runs.items()}
        for a, b in (("kernel", "plain32"), ("plain32", "plain64"),
                     ("kernel", "plain64")):
            rels = sorted(zip((rel(x, y) for x, y in zip(leaves[a],
                                                         leaves[b])), paths),
                          reverse=True)[:3]
            print(f"  {a} against {b}: " + ", ".join(
                f"{n} {r:.3g}" for r, n in rels))
        del runs, leaves, params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
