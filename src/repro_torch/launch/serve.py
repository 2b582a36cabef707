"""Batched decode server loop: prefill → greedy/temperature decode with a
static-slot batch, as the reference's ``launch/serve.py``.

The prompt is prefilled token by token through ``decode_step`` (plain
attention over the KV cache, or one plain step of the recurrent state,
uniform across cache kinds), so this loop launches none of the LM
kernels; the fused full-sequence prefill is
``launch.steps.make_prefill_step``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --smoke --batch 4 --prompt-len 32 --new-tokens 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def prefill_into_cache(params, cfg: ModelConfig, tokens: torch.Tensor,
                       max_seq: int):
    """Build the KV cache by running decode_step over the prompt, one
    token at a time.  Returns (last logits [B, V], cache)."""
    B, S = tokens.shape
    cache = T.init_cache(cfg, B, max_seq, tokens.device)
    logits = None
    for t in range(S):
        logits, cache = T.decode_step(params, cfg, cache, tokens[:, t:t + 1],
                                      t)
    return logits, cache


@torch.no_grad()
def decode(params, cfg: ModelConfig, cache, last_logits: torch.Tensor,
           start_pos: int, n_new: int, temperature: float = 0.0,
           seed: int = 0):
    """Greedy (``temperature == 0``) or sampled decoding of ``n_new``
    tokens.  Returns (tokens [B, n_new] int32 numpy, cache).  Samples are
    drawn from a ``torch.Generator`` seeded with ``seed``: the same
    distribution as the reference's, not the same draws."""
    gen = torch.Generator(device=last_logits.device).manual_seed(seed)
    out = []
    logits = last_logits
    for i in range(n_new):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        out.append(tok.to(torch.int32))
        logits, cache = T.decode_step(params, cfg, cache, tok[:, None],
                                      start_pos + i)
    return torch.stack(out, dim=1).cpu().numpy(), cache


def serve_demo(arch: str, batch: int = 4, prompt_len: int = 32,
               new_tokens: int = 32, smoke: bool = True,
               temperature: float = 0.0, seed: int = 0,
               device="cuda", params: Optional[dict] = None) -> Dict:
    """Prefill ``batch`` random prompts and decode ``new_tokens`` each.

    ``params=None`` draws the port's own weights from ``seed`` on
    ``device``; the tests pass weights carried from the reference.
    ``device="cuda"`` raises where no card is present.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"serve_demo(device={str(device)!r}) but no CUDA "
                           "device is available; pass device='cpu' to "
                           "serve on the CPU")
    cfg = get_config(arch, smoke=smoke)
    if params is None:
        params = T.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)
    max_seq = prompt_len + new_tokens

    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(params, cfg, prompts, max_seq)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks, cache = decode(params, cfg, cache, logits, prompt_len, new_tokens,
                         temperature=temperature, seed=seed)
    t_decode = time.perf_counter() - t0
    tps = batch * new_tokens / max(t_decode, 1e-9)
    print(f"[serve] {arch}: prefill {prompt_len} tok x{batch} in "
          f"{t_prefill:.2f}s; decoded {new_tokens} x{batch} in "
          f"{t_decode:.2f}s ({tps:.1f} tok/s) on {device}")
    return {"tokens": toks, "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": tps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve_demo(args.arch, batch=args.batch, prompt_len=args.prompt_len,
               new_tokens=args.new_tokens, temperature=args.temperature,
               smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
