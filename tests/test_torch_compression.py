"""The port's gradient compression against the reference's
``optim/compression.py``, in process on the CPU.

The reference's five cases (``tests/test_compression.py``) run on the
port's functions, then the two packages are held equal value for value on
inputs drawn with numpy from a seed: ``topk_sparsify`` (float32 and bf16,
with ties at the threshold), ``ef_compress``'s outputs and carry over a
tree of dicts and a list for three chained steps, and ``quantize_int8``
(values half way between two levels included, which both round to even).
Every comparison is exact: both packages do the same float32 operations
in the same order.  ``psum_int8`` needs a mesh; it is held across ranks in
``tests/test_torch_parallel.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as ref  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import (compression_ratio,  # noqa: E402
                                           dequantize_int8, ef_compress,
                                           init_error_state, quantize_int8,
                                           topk_sparsify)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.01, 3.0, -0.2])
    out = topk_sparsify(g, 0.4).numpy()
    assert out[1] == -5.0 and out[3] == 3.0
    assert out[0] == 0 and out[2] == 0 and out[4] == 0


def test_error_feedback_preserves_mass():
    """compressed + error == original (nothing lost, only delayed)."""
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.standard_normal(100).astype(np.float32))}
    e = init_error_state(g)
    comp, e2 = ef_compress(g, e, k_frac=0.1)
    np.testing.assert_allclose((comp["a"] + e2["a"]).numpy(), g["a"].numpy(),
                               atol=1e-6)


def test_ef_sgd_converges_on_quadratic():
    """min ||x - t||²; EF-compressed SGD still converges (the stable lr
    shrinks by the compression factor)."""
    t = torch.from_numpy(
        np.random.default_rng(1).standard_normal(50).astype(np.float32))
    x = torch.zeros(50)
    err = {"x": torch.zeros(50)}
    lr = 0.04
    for _ in range(800):
        g = {"x": 2 * (x - t)}
        comp, err = ef_compress(g, err, k_frac=0.1)
        x = x - lr * comp["x"]
    assert float(torch.linalg.norm(x - t)) < 5e-2


def test_int8_quant_roundtrip_error_bounded():
    rng = np.random.default_rng(2)
    g = torch.from_numpy((rng.standard_normal(1000) * 3).astype(np.float32))
    q, s = quantize_int8(g)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    max_err = float((dequantize_int8(q, s) - g).abs().max())
    assert max_err <= float(s) * 0.5 + 1e-6


def test_compression_ratio_math():
    assert compression_ratio(0.01) == pytest.approx(0.02)
    assert compression_ratio(0.01) == ref.compression_ratio(0.01)
    assert compression_ratio(0.25, bits=16) == ref.compression_ratio(0.25, 16)


# ---------------------------------------------------------------------------
# the two packages on the same inputs
# ---------------------------------------------------------------------------

def _ties(rng, n):
    """Values drawn from a few levels, so that many tie at the top-k
    threshold."""
    return rng.choice(np.array([-3, -2, -1, 0, 1, 2, 3], np.float32), n)


TOPK_CASES = ["normal", "ties", "bf16", "bf16_ties"]


@pytest.mark.parametrize("k_frac", [0.001, 0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_sparsify_equals_reference(case, k_frac):
    rng = np.random.default_rng(TOPK_CASES.index(case))
    a = (_ties(rng, 3 * 5 * 67) if "ties" in case
         else rng.standard_normal(3 * 5 * 67).astype(np.float32))
    a = a.reshape(3, 5, 67)
    bf16 = case.startswith("bf16")
    x = torch.from_numpy(a)
    xr = jnp.asarray(a)
    if bf16:
        x, xr = x.to(torch.bfloat16), xr.astype(jnp.bfloat16)
    got = topk_sparsify(x, k_frac)
    want = ref.topk_sparsify(xr, k_frac)
    assert got.dtype == x.dtype and str(want.dtype) == str(x.dtype)[6:]
    np.testing.assert_array_equal(_np(got), _np(want))
    kept = int((got != 0).sum())
    assert kept >= max(1, int(a.size * k_frac)) - int((a == 0).sum())


def _grad_tree(rng):
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": a(50, 8), "final_ln": {"scale": a(8)},
            "layers": {"attn": {"wq": a(2, 8, 12)}},
            "dense_layers": [{"ffn": {"w_up": a(8, 10)}}]}


def _to_torch(tree, bf16=("embed",)):
    return {k: adamw.tree_map(lambda x: torch.from_numpy(x).to(
        torch.bfloat16 if k in bf16 else torch.float32), v)
        for k, v in tree.items()}


def _to_jax(tree, bf16=("embed",)):
    return {k: jax.tree.map(lambda x: jnp.asarray(
        x, jnp.bfloat16 if k in bf16 else jnp.float32), v)
        for k, v in tree.items()}


@pytest.mark.parametrize("k_frac", [0.01, 0.1])
def test_ef_compress_equals_reference(k_frac):
    """Three chained steps: each step's compressed gradients and carry
    equal the reference's, leaf for leaf, bit for bit (bf16 leaves too)."""
    rng = np.random.default_rng(3)
    params = _grad_tree(rng)
    e = init_error_state(_to_torch(params))
    e_ref = ref.init_error_state(_to_jax(params))
    for leaf in adamw.tree_leaves(e):
        assert leaf.dtype == torch.float32 and not leaf.any()
    for step in range(3):
        g = _grad_tree(rng)
        comp, e = ef_compress(_to_torch(g), e, k_frac)
        comp_ref, e_ref = ref.ef_compress(_to_jax(g), e_ref, k_frac)
        got = adamw.tree_leaves(comp) + adamw.tree_leaves(e)
        want = (jax.tree_util.tree_leaves(comp_ref)
                + jax.tree_util.tree_leaves(e_ref))
        assert len(got) == len(want) == 8
        for x, y in zip(got, want):
            assert str(x.dtype)[6:] == str(y.dtype), step
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=str(step))
        assert isinstance(comp["dense_layers"], list)


@pytest.mark.parametrize("case", ["normal", "scaled", "halves", "bf16",
                                  "zeros"])
def test_quantize_int8_equals_reference(case):
    rng = np.random.default_rng(4)
    if case == "halves":
        # max |g| = 127 makes the scale 1.0 in float32, so every x.5
        # is a tie that rounds to even
        a = np.concatenate([[127.0, -126.5], np.arange(-20, 20) + 0.5,
                            rng.integers(-127, 128, 50)]).astype(np.float32)
    elif case == "zeros":
        a = np.zeros(17, np.float32)
    else:
        a = rng.standard_normal(1000).astype(np.float32) * (
            1e3 if case == "scaled" else 1.0)
    x, xr = torch.from_numpy(a), jnp.asarray(a)
    if case == "bf16":
        x, xr = x.to(torch.bfloat16), xr.astype(jnp.bfloat16)
    q, s = quantize_int8(x)
    q_ref, s_ref = ref.quantize_int8(xr)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert float(s) == float(s_ref)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref.dequantize_int8(q_ref,
                                                                 s_ref)))
    if case == "halves":
        assert q[2:42].tolist() == np.round(a[2:42]).astype(int).tolist()
