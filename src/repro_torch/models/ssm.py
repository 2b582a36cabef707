"""Mamba-style selective SSM branch (Hymba's parallel-head partner).

Selective scan: h_t = exp(Δ_t·A)⊙h_{t-1} + Δ_t·B_t·x_t ;
y_t = C_t·h_t + D·x_t.

A full sequence is decomposed as ``tests/test_kernels.py`` holds the
reference's kernel to its model: ``a = exp(dt·A)`` and ``b = dt·B·u`` are
formed in float32 ([B, S, di, N] each), and the recurrence runs through
:func:`repro_torch.kernels.selective_scan.ops.selective_scan` — the
hand-written kernel on the card, its plain sequential version on the CPU.
A full sequence trains through it: while autograd records, the forward
kernel also stores its chunk checkpoints and the backward kernel gives
the scan's gradient (the plain backward on the CPU).
The reference's three ``ssm_impl`` forms (``scan``, ``associative``,
``chunked``) compute one function, so here all three take that path.  One
token (decode) steps the state directly, in plain tensor code on either
device, as the reference's ``scan`` form does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.meshes import map_shards, pad_front
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.layers import Params, dense_init

SSM_IMPLS = ("scan", "associative", "chunked")


def ssm_init(generator: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    """The reference's tree: ``A_log``, ``D`` and ``dt_bias`` in float32,
    the projections and the conv kernel in ``dtype``."""
    sc = cfg.ssm
    d = cfg.d_model
    di = sc.expand * d
    dt_rank = max(16, d // 16)
    dev, f32 = generator.device, torch.float32
    conv_w = torch.randn((sc.d_conv, di), generator=generator, dtype=f32,
                         device=dev) * 0.2
    return {
        "in_proj": dense_init(generator, d, 2 * di, dtype),
        "conv_w": conv_w.to(dtype),
        "x_proj": dense_init(generator, di, dt_rank + 2 * sc.d_state, dtype),
        "dt_proj": dense_init(generator, dt_rank, di, dtype),
        "dt_bias": torch.zeros((di,), dtype=f32, device=dev),
        "A_log": torch.log(torch.arange(1, sc.d_state + 1, dtype=f32,
                                        device=dev)).repeat(di, 1),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": dense_init(generator, di, d, dtype),
    }


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: [B,S,di]; w: [K,di]."""
    K, S = w.shape[0], x.shape[1]
    pad = pad_front(x, K - 1)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return out


def _selective_scan(u, dt, A, B, C, D, h0=None, impl: str = "scan"):
    """u, dt: [B,S,di]; A: [di,N]; B, C: [B,S,N].  Returns y [B,S,di]
    (float32) and h_last [B,di,N].  Every ``impl`` computes this one
    function (see the module's docstring)."""
    if impl not in SSM_IMPLS:
        raise ValueError(f"unknown ssm_impl {impl!r} (known: {SSM_IMPLS})")
    f32 = torch.float32
    Bsz, S, di = u.shape
    if h0 is None:
        h0 = torch.zeros((Bsz, di, A.shape[1]), dtype=f32, device=u.device)
    # [B,S,di,N] float32, each formed in place in one allocation
    a = (dt[..., None] * A[None, None]).exp_()
    b = (dt[..., None] * B[:, :, None, :]).mul_(u[..., None])
    if S == 1:
        # one step of the recurrence (decode)
        h = a[:, 0] * h0.to(f32) + b[:, 0]
        y = torch.einsum("bdn,bn->bd", h, C[:, 0].to(f32))[:, None]
    else:
        # each (batch, channel) pair's recurrence is its own: on a mesh it
        # runs on each rank's shards of the two
        y, h = map_shards(selective_scan, (a, b, C, h0),
                          ({"b": 0, "d": 2}, {"b": 0, "d": 2}, {"b": 0},
                           {"b": 0, "d": 1}),
                          ({"b": 0, "d": 2}, {"b": 0, "d": 1}))
    return y + D[None, None] * u.to(f32), h


def ssm_forward(p: Params, cfg, x: torch.Tensor,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Full sequence (prefill), or one token against ``state`` (decode).
    Returns (y, final_state)."""
    sc = cfg.ssm
    S = x.shape[1]
    dt_rank = p["dt_proj"].shape[0]
    u, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    conv_in = u
    if state is not None:
        conv_in = torch.cat([state["conv"], u], dim=1)
        u_c = _conv1d_causal(conv_in, p["conv_w"])[:, -S:]
    else:
        u_c = _conv1d_causal(u, p["conv_w"])
    u_c = F.silu(u_c)
    dt_in, Bc, Cc = torch.split(u_c @ p["x_proj"],
                                [dt_rank, sc.d_state, sc.d_state], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"]).to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h0 = state["h"] if state is not None else None
    impl = cfg.ssm_impl if S > 1 else "scan"
    y, h_last = _selective_scan(u_c, dt, A, Bc, Cc, p["D"], h0, impl=impl)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    new_state = {"h": h_last, "conv": conv_in[:, -(sc.d_conv - 1):, :]}
    return y @ p["out_proj"], new_state


def ssm_init_state(cfg, batch: int, dtype: torch.dtype,
                   device="cpu") -> Dict:
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, sc.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, sc.d_conv - 1, di), dtype=dtype,
                            device=device),
    }
