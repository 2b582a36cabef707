"""Checks the port's LM test files share: one architecture's smoke config,
drawn by the reference (``init_params(cfg, PRNGKey(0))``) and carried into
the port leaf for leaf (``params_from_numpy``), fed the same numpy-seeded
inputs in both packages.

Tolerances: modules at ``atol`` 1e-5 in float32, logits at 1e-4 in float32
and 3e-2 in bf16 (a few bf16 steps at |logit| <= 1: the two frameworks
round to bf16 at different points), as in ``tests/test_torch_lm.py``;
greedy tokens must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ATOL = 1e-5
LOGITS_ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = tuple(LOGITS_ATOL)


@dataclasses.dataclass
class Carried:
    ref_cfg: object
    cfg: object
    ref_params: dict
    params: dict


def _as_ref(value):
    """A port sub-config (``MoEConfig``, ``MLAConfig``, ...) as the
    reference's class of that name; any other value as it is."""
    if dataclasses.is_dataclass(value):
        return getattr(ref_base, type(value).__name__)(
            **dataclasses.asdict(value))
    return value


def configs(arch, dtype="float32", **change):
    """(reference config, port config): the smoke config in ``dtype``
    with ``change`` (values of the port's config classes) applied to
    both."""
    kw = dict(param_dtype=dtype, activ_dtype=dtype, **change)
    return (ref_get_config(arch, smoke=True).replace(
                **{k: _as_ref(v) for k, v in kw.items()}),
            get_config(arch, smoke=True).replace(**kw))


def carry(arch, dtype="float32", **change) -> Carried:
    ref_cfg, cfg = configs(arch, dtype, **change)
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    return Carried(ref_cfg, cfg, ref_params,
                   params_from_numpy(jax.tree.map(np.asarray, ref_params)))


def as_np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def tree_spec(tree):
    """{path: (shape, dtype name)} of a tree of dicts and lists of jnp
    arrays or tensors."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {f"{k}/{p}" if p else str(k): s for k, v in items
                for p, s in tree_spec(v).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def batches(cfg, B, S, seed=0):
    """(reference batch, port batch) for ``make_prefill_step``: tokens, with
    patch embeddings for vision, or frame embeddings for audio."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        arrays["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        arrays = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def prompts(cfg, B, S, seed=1):
    """Prompt tokens [B, S], or [B, S, K] over the audio codebooks (one id
    repeated, as serve_demo repeats them)."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "audio":
        toks = np.repeat(toks[:, :, None], cfg.n_codebooks, axis=2)
    return toks


def ref_prefill_into_cache(c: Carried, toks, max_seq):
    """The reference's cache build: its ``prefill_into_cache``, or for
    audio the loop of its ``serve_demo`` (its ``prefill_into_cache``
    takes [B, S] tokens only)."""
    if c.ref_cfg.frontend != "audio":
        return ref_serve.prefill_into_cache(c.ref_params, c.ref_cfg,
                                            jnp.asarray(toks), max_seq)
    cache = ref_T.init_cache(c.ref_cfg, toks.shape[0], max_seq)
    step = jax.jit(lambda cc, tok, pos: ref_T.decode_step(
        c.ref_params, c.ref_cfg, cc, tok, pos))
    for t in range(toks.shape[1]):
        logits, cache = step(cache, jnp.asarray(toks[:, t][:, None]), t)
    return logits, cache


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def check_params_tree(arch, **change):
    """The port's own draw has the reference's tree and count."""
    ref_cfg, cfg = configs(arch, "bfloat16", **change)
    want = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tree_spec(got) == tree_spec(want)
    assert T.param_count(got) == ref_T.param_count(want)
    assert cfg.param_count() == ref_cfg.param_count()


def check_cache_tree(arch, dtype, **change):
    ref_cfg, cfg = configs(arch, dtype, **change)
    want = ref_T.init_cache(ref_cfg, 3, 24)
    got = T.init_cache(cfg, 3, 24)
    assert tree_spec(got) == tree_spec(want)
    assert not any(v.any() for v in got.values())


def check_prefill(c: Carried, dtype, B=2, S=24):
    """make_prefill_step's last-position logits."""
    ref_batch, batch = batches(c.cfg, B, S)
    want = ref_steps.make_prefill_step(c.ref_cfg)(c.ref_params, ref_batch)
    got = steps.make_prefill_step(c.cfg)(c.params, batch)
    assert tuple(got.shape) == want.shape
    assert got.dtype == T.dtype_of(dtype)
    np.testing.assert_allclose(as_np(got), as_np(want),
                               atol=LOGITS_ATOL[dtype])


def check_decode_step(c: Carried, pos=3):
    """decode_step's logits and cache at ``pos`` of a cache filled at the
    earlier positions."""
    toks = prompts(c.cfg, 2, pos + 1, seed=2)
    ref_logits, ref_cache = ref_prefill_into_cache(c, toks, pos + 4)
    logits, cache = serve.prefill_into_cache(
        c.params, c.cfg, torch.from_numpy(toks.astype(np.int64)), pos + 4)
    assert tuple(logits.shape) == ref_logits.shape
    np.testing.assert_allclose(as_np(logits), as_np(ref_logits),
                               atol=LOGITS_ATOL["float32"])
    assert sorted(cache) == sorted(ref_cache)
    for key in cache:
        np.testing.assert_allclose(as_np(cache[key]), as_np(ref_cache[key]),
                                   atol=LOGITS_ATOL["float32"])


def check_greedy_tokens(c: Carried, S=10, n_new=6):
    """prefill_into_cache + greedy decode give the reference's tokens."""
    toks = prompts(c.cfg, 2, S)
    ref_logits, ref_cache = ref_prefill_into_cache(c, toks, S + n_new)
    want, _ = ref_serve.decode(c.ref_params, c.ref_cfg, ref_cache,
                               ref_logits, S, n_new)
    logits, cache = serve.prefill_into_cache(
        c.params, c.cfg, torch.from_numpy(toks.astype(np.int64)), S + n_new)
    got, _ = serve.decode(c.params, c.cfg, cache, logits, S, n_new)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def check_serve_demo(arch, params16):
    """serve_demo in the smoke config's own dtype, bfloat16, on the
    reference's weights for seed 0 in both packages, twice."""
    want = ref_serve.serve_demo(arch, batch=2, prompt_len=8, new_tokens=6)
    runs = [serve.serve_demo(arch, batch=2, prompt_len=8, new_tokens=6,
                             device="cpu", params=params16)
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["tokens"],
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(runs[1]["tokens"], runs[0]["tokens"])


def check_full_config(arch):
    """The full config's fields and counts, without building it."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert (cfg.param_count(active_only=True)
            == ref_cfg.param_count(active_only=True))
    for batch, seq in ((1, 2048), (4, 32_768)):
        assert cfg.kv_cache_bytes(batch, seq) == \
            ref_cfg.kv_cache_bytes(batch, seq)
    assert cfg.shapes() == ref_cfg.shapes()


def check_branch(arch, **change):
    """A model branch switched on in another architecture's smoke config
    (a frontend, MoE or MLA) matches the reference: parameter tree,
    float32 prefill logits and greedy tokens."""
    check_params_tree(arch, **change)
    c = carry(arch, "float32", **change)
    check_prefill(c, "float32")
    check_greedy_tokens(c, S=6, n_new=4)
