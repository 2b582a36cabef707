"""The port's losses against the reference's ``models/layers.py``.

``softmax_xent`` (dense logits, with and without a mask) and
``chunked_softmax_xent`` (the unembedding in vocab chunks, each chunk
recomputed in backward) on the same numpy-seeded inputs, forward and
gradient.  Tolerances: float32 losses within 1e-6 relative and gradients
within 1e-5 of their max |value| (float32 sums in another order).  bf16
logits are upcast by both packages before any arithmetic, so the dense
bf16 cases hold the same tolerances; the chunked loss forms its bf16
logits by a bf16 product in each package, which the two frameworks round
differently, so its bf16 cases hold 5e-3 relative on the loss and 2e-2
of the max |gradient| (a few bf16 steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a, dtype):
    """``a`` as a jnp array of ``dtype`` and a tensor with the same bits."""
    j = jnp.asarray(a, JNP[dtype])
    return j, params_from_numpy(np.asarray(j))


LOSS_RTOL = {"float32": 1e-6, "bfloat16": 5e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close_grad(got, want, tol=GRAD_TOL["float32"]):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(dtype, masked):
    rng = np.random.default_rng(0)
    jl, tl = _pair(3 * rng.standard_normal((3, 7, 50)), dtype)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    want, gwant = jax.value_and_grad(
        lambda x: ref_layers.softmax_xent(x, jnp.asarray(labels), jm))(jl)
    held = tl.clone().requires_grad_(True)
    got = layers.softmax_xent(held, torch.from_numpy(labels), tm)
    (g,) = torch.autograd.grad(got, [held])
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert g.dtype == tl.dtype
    _close_grad(g, gwant)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,masked", [(16, False), (64, False),
                                          (32, True)])
def test_chunked_softmax_xent_matches_reference(dtype, chunk, masked):
    rng = np.random.default_rng(chunk)
    T_, d, V = 21, 12, 128
    jx, tx = _pair(rng.standard_normal((T_, d)), dtype)
    jw, tw = _pair(rng.standard_normal((V, d)), dtype)
    labels = rng.integers(0, V, (T_,)).astype(np.int32)
    mask = (rng.random(T_) < 0.5).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    want, (gx_w, gw_w) = jax.value_and_grad(
        lambda x, w: ref_layers.chunked_softmax_xent(
            x, w, jnp.asarray(labels), chunk, jm), argnums=(0, 1))(jx, jw)
    hx, hw = (t.clone().requires_grad_(True) for t in (tx, tw))
    got = layers.chunked_softmax_xent(hx, hw, torch.from_numpy(labels),
                                      chunk, tm)
    gx, gw = torch.autograd.grad(got, [hx, hw])
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL[dtype])
    _close_grad(gx, gx_w, GRAD_TOL[dtype])
    _close_grad(gw, gw_w, GRAD_TOL[dtype])


def test_chunked_equals_dense_loss():
    """The chunked loss is the dense loss over ``x @ embed.T``."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 96, (9,)))
    dense = layers.softmax_xent(x @ w.T, labels)
    for chunk in (8, 32, 96):
        torch.testing.assert_close(
            layers.chunked_softmax_xent(x, w, labels, chunk), dense,
            rtol=1e-6, atol=0)


def test_chunked_loss_keeps_no_chunk_of_logits_for_backward():
    """Every chunk runs under a checkpoint: the saved tensors of the graph
    hold no [T, chunk] logits tile, only the inputs and [T] carries."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(7, 4, generator=gen, requires_grad=True)
    w = torch.randn(64, 4, generator=gen, requires_grad=True)
    labels = torch.randint(0, 64, (7,), generator=gen)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = layers.chunked_softmax_xent(x, w, labels, 16)
    loss.backward()
    assert (7, 16) not in shapes and (7, 64) not in shapes, shapes
    with pytest.raises(ValueError, match="multiple"):
        layers.chunked_softmax_xent(x, w, labels, 24)
