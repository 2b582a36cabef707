"""RWKV-6 "Finch" — attention-free time-mix with data-dependent decay.

Time-mix (per head, head_dim n): S_t = diag(w_t)·S_{t-1} + k_tᵀ·v_t,
y_t = r_t·(S_{t-1} + diag(u)·k_tᵀ·v_t), with per-token decay
w_t = exp(-exp(ŵ_t)) produced by a LoRA on the shifted input (the paper's
data-dependent decay).  Decode carries (S, last-x) state.

A full sequence (S > 1) runs the recurrence through
:func:`repro_torch.kernels.rwkv6_wkv.ops.wkv6`: the hand-written kernel
on the card, its plain sequential version on the CPU.  Under training the
same entry is differentiable: its gradient is the wkv6 backward kernel on
the card and its plain version on the CPU (the reference differentiates
its ``lax.scan``).  One token (decode) steps the state with
:func:`_wkv_scan` in plain tensor code on either device, as the
reference's ``scan`` form does.

The reference's two ``time_mix_impl`` forms, ``scan`` and ``chunked``,
compute one function, so here both take that path.  The reference's
``_wkv_chunked`` is not ported: it clamps its exponents at ±40, which
departs from the sequential recurrence under strong decay (the
reference's own ``tests/test_recurrence_props.py`` holds it to the
sequential form and fails), and the kernel needs no chunks on the card.

Every dtype cast is the reference's, op for op: the mixes and
projections run in the activation dtype, the decay and the WKV state in
float32, and the per-head group norm in float32 before the cast back.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.meshes import map_shards, pad_front, split_last
from repro_torch.kernels.rwkv6_wkv.ops import wkv6
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
from repro_torch.models.layers import Params, dense_init

LORA_DIM = 96
MIX_LORA = 32
TIME_MIX_IMPLS = ("scan", "chunked")


def rwkv_time_init(generator: torch.Generator, cfg,
                   dtype: torch.dtype) -> Params:
    """The reference's tree: ``mu_base``, ``w_base``, ``u`` and
    ``ln_scale`` in float32, the LoRAs and projections in ``dtype``."""
    d, H = cfg.d_model, cfg.n_heads
    dev, f32 = generator.device, torch.float32

    def draw(*shape):
        return torch.randn(shape, generator=generator, dtype=f32, device=dev)

    return {
        "mu_base": torch.rand((5, d), generator=generator, dtype=f32,
                              device=dev),
        "mix_w1": dense_init(generator, d, 5 * MIX_LORA, dtype),
        "mix_w2": (draw(5, MIX_LORA, d) * 0.01).to(dtype),
        "w_base": torch.full((d,), -6.0, dtype=f32, device=dev),
        "w_lora1": dense_init(generator, d, LORA_DIM, dtype),
        "w_lora2": (draw(LORA_DIM, d) * 0.01).to(dtype),
        "u": draw(H, cfg.head_dim) * 0.5,
        "wr": dense_init(generator, d, d, dtype),
        "wk": dense_init(generator, d, d, dtype),
        "wv": dense_init(generator, d, d, dtype),
        "wg": dense_init(generator, d, d, dtype),
        "wo": dense_init(generator, d, d, dtype),
        "ln_scale": torch.ones((d,), dtype=f32, device=dev),
    }


def rwkv_channel_init(generator: torch.Generator, cfg,
                      dtype: torch.dtype) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dev, f32 = generator.device, torch.float32
    return {
        "mu_k": torch.full((d,), 0.5, dtype=f32, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=f32, device=dev),
        "wk": dense_init(generator, d, ff, dtype),
        "wv": dense_init(generator, ff, d, dtype),
        "wr": dense_init(generator, d, d, dtype),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor]) -> torch.Tensor:
    """x: [B,S,d] -> previous-token tensor (zeros/carry at t=0)."""
    prev = pad_front(x, 1)[:, :-1]
    if last is not None:
        prev[:, 0] = last
    return prev


# the reference's name for its sequential scan, which the kernel's plain
# version already is; decode steps the state with it on either device
_wkv_scan = wkv6_ref


def _ddlerp(p: Params, x: torch.Tensor, prev: torch.Tensor):
    """Data-dependent token-shift interpolation -> per-stream mixed inputs
    (the w, k, v, r, g streams)."""
    xx = prev - x
    base = x + xx * p["mu_base"][0][None, None].to(x.dtype)   # shared pre-mix
    lora = torch.tanh(base @ p["mix_w1"])                   # [B,S,5*MIX]
    lora = split_last(lora, 5)                              # [B,S,5,MIX]
    delta = torch.einsum("bsfm,fmd->bsfd", lora, p["mix_w2"]).to(x.dtype)
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (
        p["mu_base"].to(x.dtype)[None, None] + delta)
    return [mixed[:, :, i] for i in range(5)]


def time_mix_inputs(p: Params, cfg, x: torch.Tensor,
                    state: Optional[Dict] = None):
    """Token shift, ``_ddlerp``, the decay LoRA and the r/k/v/g
    projections: (r, k, v, w [B,S,H,n], g [B,S,d], s0 [B,H,n,n])."""
    B, S, d = x.shape
    H, n = cfg.n_heads, cfg.head_dim
    prev = _token_shift(x, state["tm_x"] if state is not None else None)
    xw, xk, xv, xr, xg = _ddlerp(p, x, prev)
    w_hat = p["w_base"] + (torch.tanh(xw @ p["w_lora1"]) @ p["w_lora2"]
                           ).to(torch.float32)
    w = torch.exp(-torch.exp(w_hat))                       # [B,S,d] in (0,1)
    r = (xr @ p["wr"]).reshape(B, S, H, n)
    k = (xk @ p["wk"]).reshape(B, S, H, n)
    v = (xv @ p["wv"]).reshape(B, S, H, n)
    g = F.silu(xg @ p["wg"])
    s0 = (state["wkv"] if state is not None
          else torch.zeros((B, H, n, n), dtype=torch.float32,
                           device=x.device))
    return r, k, v, w.reshape(B, S, H, n), g, s0


def time_mix_output(p: Params, y: torch.Tensor, g: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """The per-head group norm (float32, population variance, eps 1e-5),
    the gate and the output projection.  y: [B,S,H,n] float32."""
    B, S, d = x.shape
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = (y.reshape(B, S, d) * p["ln_scale"]).to(x.dtype) * g
    return y @ p["wo"]


def rwkv_time_forward(p: Params, cfg, x: torch.Tensor,
                      state: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Full sequence (prefill), or one token against ``state`` (decode).
    Every ``time_mix_impl`` computes the sequential recurrence (see the
    module's docstring).  Returns (out, {"tm_x", "wkv"})."""
    if cfg.time_mix_impl not in TIME_MIX_IMPLS:
        raise ValueError(f"unknown time_mix_impl {cfg.time_mix_impl!r} "
                         f"(known: {TIME_MIX_IMPLS})")
    r, k, v, w, g, s0 = time_mix_inputs(p, cfg, x, state)
    # each (batch, head) pair's recurrence is its own: on a mesh it runs
    # on each rank's shards of the two
    seq = {"b": 0, "h": 2}
    y, s_last = map_shards(wkv6 if x.shape[1] > 1 else _wkv_scan,
                           (r, k, v, w, p["u"], s0),
                           (seq, seq, seq, seq, {"h": 0}, {"b": 0, "h": 1}),
                           (seq, {"b": 0, "h": 1}))
    out = time_mix_output(p, y, g, x)
    return out, {"tm_x": x[:, -1], "wkv": s_last}


def rwkv_channel_forward(p: Params, cfg, x: torch.Tensor,
                         state: Optional[Dict] = None
                         ) -> Tuple[torch.Tensor, Dict]:
    prev = _token_shift(x, state["cm_x"] if state is not None else None)
    xx = prev - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, {"cm_x": x[:, -1]}


def rwkv_init_state(cfg, batch: int, dtype: torch.dtype,
                    device="cpu") -> Dict:
    H, n = cfg.n_heads, cfg.head_dim
    return {
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),
        "wkv": torch.zeros((batch, H, n, n), dtype=torch.float32,
                           device=device),
    }
