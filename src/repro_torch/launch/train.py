"""End-to-end trainer, the reference's ``launch/train.py``: checkpoint and
restart, the heterogeneity-aware data plan, straggler handling.

Runs real steps on one device: the card by default (every GQA layer's
attention through the flash forward and backward kernels), or the CPU
with ``--device cpu`` (plain tensor code throughout).  The MB-scheduler
features run for real: each step the data plan assigns microbatch counts
per rank in proportion to measured throughput; injected faults trigger
re-planning.  Checkpoints are the reference's format and keys, so a run
restores the other package's checkpoint.  There is no gradient
compression path: the reference's trainer has none either (its docstring
promises one, but nothing in it reaches ``optim/compression.py``); the
compression and the collectives are ``optim/compression.py`` and
``distributed/collectives.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --restore [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.data.sharding import plan_batches
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.fault import FaultPlan, RestartPolicy
from repro_torch.launch import steps as S
from repro_torch.launch.serve import _sync
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, init_opt_state


def make_batch_for(cfg: ModelConfig, pipeline: TokenPipeline, step: int,
                   batch: int, seq: int,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's batch for ``step`` on ``device``: tokens [B, seq]
    (int32), with seeded patch embeddings (bf16) for vision, or seeded
    frame embeddings (bf16) and the tokens repeated over the codebooks as
    labels for audio."""
    b = pipeline.batch(step, batch)
    toks = b["tokens"][:, :seq]
    out = {"tokens": torch.from_numpy(np.ascontiguousarray(toks))}
    if cfg.frontend == "audio":
        labels = np.stack([toks] * cfg.n_codebooks, axis=-1)
        rng = np.random.default_rng(step)
        frames = rng.standard_normal((batch, seq, cfg.d_model))
        out = {"frames": torch.from_numpy(frames).to(torch.bfloat16),
               "labels": torch.from_numpy(
                   (labels % cfg.vocab_size).astype(np.int32))}
    elif cfg.frontend == "vision":
        rng = np.random.default_rng(step)
        embeds = rng.standard_normal((batch, cfg.n_vision_tokens,
                                      cfg.d_model))
        out["vision_embeds"] = torch.from_numpy(embeds).to(torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}


def train(arch: str, steps: int = 50, smoke: bool = True,
          batch: int = 8, seq: int = 128, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, restore: bool = False,
          fault_plan: Optional[FaultPlan] = None,
          profile: Optional[HeterogeneityProfile] = None,
          grad_accum: int = 1, lr: float = 1e-3,
          log_every: int = 10, seed: int = 0, device="cuda",
          params: Optional[dict] = None) -> Dict[str, list]:
    """Train ``arch`` for ``steps`` steps; returns the history (``loss``,
    ``step_time`` in seconds, taken after a synchronise, ``replans``).

    ``params=None`` draws the port's own weights from ``seed`` on
    ``device``; the tests pass weights carried from the reference.
    ``device="cuda"`` raises where no card is present.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train(device={str(device)!r}) but no CUDA "
                           "device is available; pass device='cpu' to "
                           "train on the CPU")
    cfg = get_config(arch, smoke=smoke)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    if params is None:
        params = T.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed), device)
    opt_state = init_opt_state(params)
    start_step = 0

    if ckpt_dir and restore and store.latest_step(ckpt_dir) is not None:
        (params, opt_state), extra = store.restore(
            ckpt_dir, (params, opt_state), device=device)
        start_step = int(extra.get("step", 0))
        print(f"[train] restored step {start_step} from {ckpt_dir}")

    pipeline = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))
    step_fn = S.make_train_step(cfg, opt_cfg, grad_accum)
    policy = RestartPolicy(checkpoint_every=ckpt_every)

    # MB-scheduler data plan over (possibly heterogeneous) ranks
    profile = profile or HeterogeneityProfile.homogeneous(1)
    plan = plan_batches(profile, batch, max(batch // max(profile.n, 1), 1))

    history = {"loss": [], "step_time": [], "replans": 0}
    _sync(device)
    t_last = time.time()
    for step in range(start_step, steps):
        if fault_plan:
            for ev in fault_plan.at(step):
                if ev.kind == "device_loss":
                    newp = policy.on_device_loss(profile, ev.device)
                    if newp is not None:
                        profile = newp
                        plan = plan_batches(profile, batch, plan.microbatch)
                        history["replans"] += 1
                        print(f"[fault] step {step}: lost device {ev.device}; "
                              f"elastic shrink to {profile.n} ranks")
                elif ev.kind == "straggler":
                    profile.observe(ev.device, 1.0, ev.severity)
                    plan = plan_batches(profile, batch, plan.microbatch)
                    history["replans"] += 1
                    print(f"[fault] step {step}: straggler {ev.device} "
                          f"(x{ev.severity}); re-planned shares "
                          f"{plan.counts.tolist()}")

        data = make_batch_for(cfg, pipeline, step, batch, seq, device)
        params, opt_state, metrics = step_fn(params, opt_state, data)
        _sync(device)
        loss = float(metrics["loss"])
        dt = time.time() - t_last
        t_last = time.time()
        history["loss"].append(loss)
        history["step_time"].append(dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms, lr {float(metrics['lr']):.2e}, "
                  f"gnorm {float(metrics['grad_norm']):.2f})")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            store.save(ckpt_dir, step + 1, (params, opt_state),
                       extra={"step": step + 1, "arch": arch})
    if ckpt_dir:
        store.save(ckpt_dir, steps, (params, opt_state),
                   extra={"step": steps, "arch": arch})
    return history


def main() -> Dict[str, list]:
    """The command line; returns :func:`train`'s history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--inject-straggler", type=int, default=-1,
                    help="step at which to inject a 4x straggler")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    fp = None
    if args.inject_straggler >= 0:
        from repro_torch.distributed.fault import FaultEvent
        fp = FaultPlan([FaultEvent(step=args.inject_straggler,
                                   kind="straggler", device=0, severity=4.0)])
    return train(args.arch, steps=args.steps, smoke=args.smoke,
                 batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, restore=args.restore,
                 grad_accum=args.grad_accum, lr=args.lr, fault_plan=fp,
                 device=args.device)


if __name__ == "__main__":
    main()
