"""The port's flash attention, held against the reference.

On the CPU the wrapper runs its plain PyTorch version.  These tests hold it
to the reference's Pallas kernel in interpret mode and to the reference's
jnp oracle ``flash_attention_ref``, on the same numpy-seeded inputs, at
the tolerances of ``tests/test_kernels.py`` (2e-5 in float32, 2e-2 in
bfloat16).  The CUDA kernel itself is compared with the same plain version
on the card by ``chip_smoke.py`` and by
``tests/test_torch_flash_attention_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jnp_flash_attention)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jnp_flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (B, S, H, KV, hd, window, dtype): the five of tests/test_kernels.py, then
# gemma3-1b's head shape (hd 256, one kv head) and hymba-1.5b's (25 query
# heads over 5 kv heads) with a window, in both dtypes
SHAPES = [
    (1, 128, 4, 2, 64, 0, "float32"),
    (2, 256, 4, 1, 32, 0, "float32"),
    (1, 128, 2, 2, 64, 48, "float32"),
    (1, 256, 8, 8, 128, 0, "bfloat16"),
    (2, 64, 4, 4, 64, 16, "bfloat16"),
    (1, 128, 4, 1, 256, 48, "float32"),
    (1, 128, 4, 1, 256, 48, "bfloat16"),
    (1, 128, 25, 5, 64, 48, "float32"),
    (1, 128, 25, 5, 64, 48, "bfloat16"),
]


def _inputs(B, S, H, KV, hd, dtype, seed):
    """q, k, v as jnp arrays of ``dtype`` and as torch tensors with the
    same bits."""
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                          JNP[dtype])
              for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    return arrays, [params_from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,hd,win,dtype", SHAPES)
def test_plain_version_matches_reference(B, S, H, KV, hd, win, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, KV, hd, dtype, S + H)
    launches = kernel.flash_attention_fwd.launches
    got = ops.flash_attention(q, k, v, window=win)
    assert kernel.flash_attention_fwd.launches == launches
    assert got.dtype == q.dtype and got.shape == q.shape
    got = got.float().numpy()
    _close(got, jnp_flash_attention_ref(jq, jk, jv, window=win), dtype)
    _close(got, jnp_flash_attention(jq, jk, jv, window=win, bq=64, bk=64),
           dtype)
    want = flash_attention_ref(q, k, v, window=win).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S,win", [(1, 0), (77, 0), (77, 16), (100, 1)])
def test_ragged_lengths_match_reference(S, win):
    """Lengths that no tile divides (the kernel masks its last tile); the
    reference's Pallas kernel takes only whole tiles, so the oracle is the
    reference."""
    (jq, jk, jv), (q, k, v) = _inputs(2, S, 4, 2, 16, "float32", S)
    got = ops.flash_attention(q, k, v, window=win).numpy()
    _close(got, jnp_flash_attention_ref(jq, jk, jv, window=win), "float32")


def test_window_one_attends_to_the_diagonal_only():
    _, (q, k, v) = _inputs(1, 33, 2, 1, 16, "float32", 3)
    got = ops.flash_attention(q, k, v, window=1)
    np.testing.assert_allclose(got.numpy(),
                               v.repeat_interleave(2, dim=2).numpy(),
                               atol=1e-6)


def _bad_inputs():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    return [
        ("float16", (q.half(), kv.half(), kv.half()), TypeError),
        ("int32", (q.int(), kv.int(), kv.int()), TypeError),
        ("mixed dtypes", (q, kv.bfloat16(), kv), TypeError),
        ("3-D q", (q[0], kv, kv), ValueError),
        ("k, v differ", (q, kv, kv[:, :4]), ValueError),
        ("length differs", (q[:, :4], kv, kv), ValueError),
        ("heads do not group", (torch.zeros((1, 8, 3, 16)), kv, kv),
         ValueError),
        ("head size 48", (torch.zeros((1, 8, 4, 48)),
                          torch.zeros((1, 8, 2, 48)),
                          torch.zeros((1, 8, 2, 48))), ValueError),
        ("meta device", (q.to("meta"), kv.to("meta"), kv.to("meta")),
         ValueError),
    ]


@pytest.mark.parametrize("case", _bad_inputs(), ids=lambda c: c[0])
def test_wrapper_refuses_bad_inputs(case):
    _, args, err = case
    launches = kernel.flash_attention_fwd.launches
    with pytest.raises(err):
        kernel.flash_attention_fwd(*args, window=0)
    assert kernel.flash_attention_fwd.launches == launches


def test_wrapper_takes_python_int_windows_only():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError):
        kernel.flash_attention_fwd(q, q, q, window=torch.tensor(4))
    # ops accepts any integer, as the reference's does
    assert ops.flash_attention(q, q, q, window=np.int64(4)).shape == q.shape


# the two model head layouts (gemma3-1b: 4 query heads over 1 kv head of
# 256; hymba-1.5b: 25 over 5 of 64) at lengths that end inside or just past
# a 128-row query tile, with windows from one key to the whole length
MODEL_LAYOUTS = [(4, 1, 256), (25, 5, 64)]
MODEL_CASES = sorted({(H, KV, hd, S, win)
                      for H, KV, hd in MODEL_LAYOUTS
                      for S in (1, 77, 129, 200)
                      for win in (0, 1, 16, S - 1)})


@pytest.mark.parametrize("H,KV,hd,S,win", MODEL_CASES)
def test_plain_version_matches_reference_at_model_layouts(H, KV, hd, S, win):
    """bfloat16, the models' type, at tests/test_kernels.py's 2e-2."""
    (jq, jk, jv), (q, k, v) = _inputs(1, S, H, KV, hd, "bfloat16", S + win)
    got = ops.flash_attention(q, k, v, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got.float().numpy(),
           jnp_flash_attention_ref(jq, jk, jv, window=win), "bfloat16")


@pytest.mark.parametrize("dtype", kernel.DTYPES, ids=str)
@pytest.mark.parametrize("hd", kernel.HEAD_DIMS)
def test_route_by_type_and_head_size(dtype, hd):
    """bf16 at hd 64-256 takes the TMA/wgmma kernel, bf16 at hd 16 and 32
    the mma.sync one, float32 the CUDA-core one."""
    want = ("f32" if dtype == torch.float32
            else "hopper" if hd in (64, 128, 256) else "mma")
    assert kernel.route(dtype, hd) == want
    assert want in kernel.ROUTES


def test_cpu_calls_count_no_launch_on_any_route():
    _, (q, k, v) = _inputs(1, 16, 4, 1, 64, "bfloat16", 5)
    before = dict(kernel.flash_attention_fwd.launches_by_route)
    kernel.flash_attention_fwd(q, k, v, window=0)
    assert kernel.flash_attention_fwd.launches_by_route == before
    assert sorted(before) == sorted(kernel.ROUTES)

