"""The port's flash-attention gradient, held against autograd and the
reference.

The reference trains by differentiating its plain attention; the port's
card path differentiates through ``FlashAttention`` (the forward kernel
with its ``lse``, then the backward kernel).  On the CPU both kernels run
their plain versions.  These tests hold the plain backward (dQ, dK, dV
written out as tensor ops from P recomputed from ``lse``, no autograd) to
autograd of the plain forward and to ``jax.grad`` of the reference's
``flash_attention_ref``, on the same numpy-seeded inputs and output
gradient, over GQA groupings, windows 0 and > 0, and head sizes 16-256.

Tolerances: each gradient's max |difference| within 2e-5 of its max
|value| in float32 (float32 sums in another order); in bfloat16, where the
plain backward keeps float32 products and autograd rounds each
intermediate to bfloat16, 3e-2 of it.  ``lse`` is held to a float64
logsumexp within 1e-5.  The backward kernel itself is compared with the
plain version on the card by ``tests/test_torch_train_card.py`` and
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jnp_flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, S, H, KV, hd, window): every head size the kernels take, GQA groups
# of 1, 2, 4 and 5, full causal and windowed, ragged S
SHAPES = [
    (2, 40, 4, 1, 16, 0),
    (1, 77, 4, 2, 32, 9),
    (2, 64, 4, 4, 64, 0),
    (1, 50, 8, 2, 128, 16),
    (1, 33, 4, 1, 256, 0),
    (1, 48, 4, 1, 256, 12),
    (1, 40, 25, 5, 64, 8),
]


def _inputs(B, S, H, KV, hd, dtype, seed):
    """q, k, v and the output gradient, as numpy float32 and as tensors of
    ``dtype`` rounded from them."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                            (B, S, H, hd))]
    return arrays, [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]


def _autograd(q, k, v, dout, window):
    """(out, dq, dk, dv) by autograd of the plain forward."""
    held = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention_ref(*held, window=window)
    return (out.detach(),) + torch.autograd.grad(out, held, dout)


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window", SHAPES)
def test_plain_backward_matches_autograd(B, S, H, KV, hd, window, dtype):
    _, (q, k, v, dout) = _inputs(B, S, H, KV, hd, dtype, S + hd)
    out, *want = _autograd(q, k, v, dout, window)
    lse = flash_attention_lse_ref(q, k, window=window)
    got = flash_attention_bwd_ref(q, k, v, out, lse, dout, window=window)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        _close(g, w, dtype, f"d{name}")


@pytest.mark.parametrize("B,S,H,KV,hd,window", SHAPES)
def test_plain_backward_matches_jax_grad_of_the_reference(B, S, H, KV, hd,
                                                          window):
    arrays, (q, k, v, dout) = _inputs(B, S, H, KV, hd, "float32", 7 * S)
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda a, b, c: jnp_flash_attention_ref(
        a, b, c, window=window), jq, jk, jv)
    want = vjp(jg)
    out = flash_attention_ref(q, k, v, window=window)
    lse = flash_attention_lse_ref(q, k, window=window)
    got = flash_attention_bwd_ref(q, k, v, out, lse, dout, window=window)
    for name, g, w in zip("qkv", got, want):
        _close(g, np.asarray(w), "float32", f"d{name}")


@pytest.mark.parametrize("B,S,H,KV,hd,window", SHAPES[:4])
def test_lse_is_the_masked_logsumexp(B, S, H, KV, hd, window):
    arrays, (q, k, _, _) = _inputs(B, S, H, KV, hd, "float32", 3)
    qd, kd = (a.astype(np.float64) for a in arrays[:2])
    kd = np.repeat(kd, H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(hd)
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    live = (j <= i) & ((j > i - window) if window > 0 else True)
    s = np.where(live, s, -np.inf)
    top = s.max(-1, keepdims=True)
    want = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    got = flash_attention_lse_ref(q, k, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, S)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window", SHAPES[::2])
def test_function_gradients_are_the_plain_backward(B, S, H, KV, hd, window,
                                                   dtype):
    """On the CPU ``ops.flash_attention`` records ``FlashAttention``, whose
    forward is the plain forward with its lse and whose backward is the
    plain backward: exactly those values, and no kernel launch."""
    _, (q, k, v, dout) = _inputs(B, S, H, KV, hd, dtype, 11)
    held = [x.clone().requires_grad_(True) for x in (q, k, v)]
    launches = (kernel.flash_attention_fwd.launches,
                kernel.flash_attention_bwd.launches)
    out = ops.flash_attention(*held, window=window)
    assert out.grad_fn is not None and "FlashAttention" in str(out.grad_fn)
    grads = torch.autograd.grad(out, held, dout)
    assert (kernel.flash_attention_fwd.launches,
            kernel.flash_attention_bwd.launches) == launches
    assert torch.equal(out.detach(), flash_attention_ref(q, k, v,
                                                         window=window))
    lse = flash_attention_lse_ref(q, k, window=window)
    want = flash_attention_bwd_ref(q, k, v, out.detach(), lse, dout,
                                   window=window)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_no_grad_call_records_nothing():
    """Serving (no grad, or inputs that need none) takes the plain forward
    call, which writes no lse and records no graph."""
    _, (q, k, v, _) = _inputs(1, 16, 2, 1, 16, "float32", 0)
    assert ops.flash_attention(q, k, v).grad_fn is None
    held = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.flash_attention(held, k, v).grad_fn is None


def test_wrappers_return_lse_and_check_the_backward_inputs():
    _, (q, k, v, dout) = _inputs(1, 24, 4, 2, 32, "float32", 5)
    out, lse = kernel.flash_attention_fwd(q, k, v, window=4, return_lse=True)
    assert torch.equal(out, flash_attention_ref(q, k, v, window=4))
    assert torch.equal(lse, flash_attention_lse_ref(q, k, window=4))
    dq, dk, dv = kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                            window=4)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    with pytest.raises(ValueError, match="lse"):
        kernel.flash_attention_bwd(q, k, v, out, lse[:, :2], dout)
    with pytest.raises(ValueError, match="lse"):
        kernel.flash_attention_bwd(q, k, v, out, lse.double(), dout)
    with pytest.raises(ValueError, match="dout"):
        kernel.flash_attention_bwd(q, k, v, out, lse, dout[:, :5])
    with pytest.raises(ValueError, match="out"):
        kernel.flash_attention_bwd(q, k, v, out.to(torch.bfloat16), lse,
                                   dout)
    with pytest.raises(ValueError, match="no flash_attention_bwd kernel"):
        m = [x.to("meta") for x in (q, k, v, out, lse, dout)]
        kernel.flash_attention_bwd(*m)


@pytest.mark.parametrize("dtype", kernel.DTYPES, ids=str)
@pytest.mark.parametrize("hd", kernel.HEAD_DIMS)
def test_backward_route_by_type_and_head_size(dtype, hd):
    """bf16 at hd 64-256 takes the TMA/wgmma kernels, bf16 at hd 16 and 32
    the mma.sync ones, float32 the CUDA-core ones."""
    want = ("f32" if dtype == torch.float32
            else "hopper" if hd in (64, 128, 256) else "mma")
    assert kernel.bwd_route(dtype, hd) == want
    assert want in kernel.ROUTES


def test_cpu_backward_calls_count_no_launch_on_any_route():
    _, (q, k, v, dout) = _inputs(1, 16, 4, 1, 64, "bfloat16", 5)
    out, lse = kernel.flash_attention_fwd(q, k, v, return_lse=True)
    launches = kernel.flash_attention_bwd.launches
    before = dict(kernel.flash_attention_bwd.launches_by_route)
    kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    assert kernel.flash_attention_bwd.launches == launches
    assert kernel.flash_attention_bwd.launches_by_route == before
    assert sorted(before) == sorted(kernel.ROUTES)
    kernel.zero_launches()
    assert kernel.flash_attention_bwd.launches_by_route == dict.fromkeys(
        kernel.ROUTES, 0)


def test_gqa_gradient_sums_over_the_group():
    """A kv head shared by 4 query heads gets the sum of the 4 gradients
    it would get if each query head had its own copy of it."""
    _, (q, k, v, dout) = _inputs(1, 20, 4, 1, 16, "float32", 9)
    out = flash_attention_ref(q, k, v, window=0)
    lse = flash_attention_lse_ref(q, k, window=0)
    _, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, dout)
    k4, v4 = k.repeat(1, 1, 4, 1), v.repeat(1, 1, 4, 1)
    lse4 = flash_attention_lse_ref(q, k4, window=0)
    _, dk4, dv4 = flash_attention_bwd_ref(q, k4, v4, out, lse4, dout)
    torch.testing.assert_close(dk[:, :, 0], dk4.sum(2), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(dv[:, :, 0], dv4.sum(2), rtol=1e-5,
                               atol=1e-6)


# the gate phase 16a and the card tests hold the backward kernel to,
# checked here on the plain backward: at window 1, where dQ and dK are
# exactly 0 (P = 1, dS = dP - D = 0) and float32 leaves only the rounding
# of that cancellation, which ``bwd_cancel_bound`` bounds row by row; a
# skipped 64-row tile of dV must fail the block gate
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 200, 4, 1, 256),
                                         (1, 200, 4, 2, 128),
                                         (1, 200, 4, 4, 64)])
def test_window_one_gate_on_the_plain_backward(B, S, H, KV, hd):
    from repro_torch.kernels.flash_attention.ref import (bwd_block_err,
                                                         bwd_cancel_bound)
    _, (q, k, v, g) = _inputs(B, S, H, KV, hd, "float32", S + hd)
    out = flash_attention_ref(q, k, v, window=1)
    lse = flash_attention_lse_ref(q, k, window=1)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, g, window=1)
    dq_rows, dk_rows = bwd_cancel_bound(q, k, v, g)
    assert dq_rows.shape == (B, S, H) and dk_rows.shape == (B, S, KV)
    for got, rows in ((dq, dq_rows), (dk, dk_rows)):
        assert bwd_block_err(got, torch.zeros_like(got), 1e-5, 0.0,
                             row_bound=rows) <= 1
    # at window 1 dV is each query's dO summed over its key's group
    want = g.reshape(B, S, KV, H // KV, hd).sum(3)
    assert bwd_block_err(dv, want, 1e-5, 1e-7) <= 1
    skipped = dv.clone()
    skipped[:, 64:128] = 0
    assert bwd_block_err(skipped, want, 1e-5, 1e-7) > 1
