"""The port's AdamW, schedule and clipping against the reference's
``optim/adamw.py``, given equal gradients.

Trees mix float32 and bf16 leaves and a list (a MoE config's
``dense_layers``); gradients are drawn with numpy from a seed and handed
to both packages.  Tolerances: the schedule (or 1e-6 of the peak rate,
where the cosine's 1 + cos cancels), norms, moments and float32
parameters within 1e-6 relative (float32 arithmetic in another library);
bf16 parameters within one bf16 step of the reference's (2**-7 relative):
both compute the update in float32 and round once, and a 1e-7 difference
can cross a rounding boundary.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

RTOL = 1e-6
BF16_STEP = 2.0 ** -7


def _as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tree(rng, scale=1.0):
    """A small parameter-shaped tree of numpy float32 arrays."""
    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"embed": a(11, 4), "final_ln": {"scale": a(4)},
            "layers": {"attn": {"wq": a(2, 4, 6)}, "ln1": {"scale": a(2, 4)}},
            "dense_layers": [{"ffn": {"w_up": a(4, 5)}}]}


def _cast(tree, bf16_keys=("embed", "layers")):
    """The tree as jnp arrays, the leaves under ``bf16_keys`` in bf16."""
    return {k: jax.tree.map(
                lambda x: jnp.asarray(x, jnp.bfloat16 if k in bf16_keys
                                      else jnp.float32), v)
            for k, v in tree.items()}


def _leaves_close(got, want, what):
    for g, w in zip(adamw.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape), what
        assert str(g.dtype).split(".")[-1] == str(w.dtype), what
        tol = BF16_STEP if g.dtype == torch.bfloat16 else RTOL
        np.testing.assert_allclose(_as_np(g), _as_np(w), rtol=tol,
                                   atol=tol * float(np.abs(_as_np(w)).max()),
                                   err_msg=what)


@pytest.mark.parametrize("cfg", [
    dict(), dict(warmup_steps=0, total_steps=7), dict(warmup_steps=3,
                                                      total_steps=3),
    dict(lr=3e-3, warmup_steps=5, total_steps=50, min_lr_frac=0.0)])
def test_schedule_matches_reference(cfg):
    ref_cfg, cfg_ = ref_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in (0, 1, 2, 3, 4, 5, 7, 49, 50, 99, 100, 101, 5000, 10_000,
                 20_000):
        want = ref_adamw.schedule(ref_cfg, jnp.int32(step))
        got = adamw.schedule(cfg_, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        # near the cosine's end 1 + cos(pi t) cancels: hold it to 1e-6 of
        # the peak rate there
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=RTOL * ref_cfg.lr)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_global_norm_and_clip_match_reference(scale):
    g = _tree(np.random.default_rng(1), scale)
    want_n = ref_adamw.global_norm(_cast(g))
    got_n = adamw.global_norm(params_from_numpy(jax.tree.map(
        np.asarray, _cast(g))))
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=RTOL)
    ref32 = jax.tree.map(jnp.asarray, g)
    want, wn = ref_adamw.clip_by_global_norm(ref32, 1.0)
    got, gn = adamw.clip_by_global_norm(params_from_numpy(g), 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=RTOL)
    _leaves_close(got, want, "clipped")


def test_init_opt_state_is_the_references():
    p = _cast(_tree(np.random.default_rng(2)))
    want = ref_adamw.init_opt_state(p)
    got = adamw.init_opt_state(params_from_numpy(jax.tree.map(np.asarray,
                                                              p)))
    assert isinstance(got, adamw.OptState) and got._fields == want._fields
    _leaves_close(got.mu, want.mu, "mu")
    _leaves_close(got.nu, want.nu, "nu")
    assert got.step.dtype == torch.int32 and got.step.dim() == 0
    assert int(got.step) == 0


@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_three_updates_match_reference(clip_norm):
    """Three AdamW steps from the same parameters with the same gradients
    (in the parameters' types): parameters, moments, step and metrics."""
    rng = np.random.default_rng(4)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip_norm)
    ref_cfg, cfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    ref_p = _cast(_tree(rng))
    p = params_from_numpy(jax.tree.map(np.asarray, ref_p))
    ref_s, s = ref_adamw.init_opt_state(ref_p), adamw.init_opt_state(p)
    for i in range(3):
        ref_g = _cast(_tree(rng, scale=3.0 if i == 1 else 0.3))
        g = params_from_numpy(jax.tree.map(np.asarray, ref_g))
        ref_p, ref_s, ref_m = ref_adamw.adamw_update(ref_cfg, ref_p, ref_g,
                                                     ref_s)
        mu_before = adamw.tree_leaves(s.mu)
        p, s, m = adamw.adamw_update(cfg, p, g, s)
        # the moments are updated in place
        assert all(a is b for a, b in zip(adamw.tree_leaves(s.mu),
                                          mu_before))
        _leaves_close(p, ref_p, f"params after step {i + 1}")
        _leaves_close(s.mu, ref_s.mu, f"mu after step {i + 1}")
        _leaves_close(s.nu, ref_s.nu, f"nu after step {i + 1}")
        assert s.step.dtype == torch.int32 and int(s.step) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=RTOL)


def test_tree_helpers_follow_jax_order():
    tree = {"b": [np.zeros(1), np.ones(2)], "a": {"z": np.full(3, 2.0),
                                                  "y": np.full(4, 3.0)}}
    got = adamw.tree_leaves(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert [g.shape for g in got] == [w.shape for w in want]
    doubled = adamw.tree_map(lambda x, y: x + y, tree, tree)
    assert isinstance(doubled["b"], list)
    np.testing.assert_array_equal(doubled["a"]["y"], np.full(4, 6.0))
