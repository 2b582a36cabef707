"""The port's checkpoint store, held against the reference's.

Mirrors ``tests/test_checkpoint.py`` (bar the elastic re-shard plan, which
needs a jax mesh) and the store's crash-window regressions in
``tests/test_son.py``, and adds what the port owes the reference: its own
msgpack codec gives ``msgpack.packb``'s bytes at every format boundary, the
same tree saved raw by both stores gives byte-identical files, and a step
written by either store restores through the other (both codecs, bfloat16
leaves included).
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as ref_store  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def small_state():
    """A smoke model's parameters (bfloat16 and float32 leaves) and an
    optimizer-like state: nested dicts, a list and an int32 scalar."""
    cfg = get_config("gemma3-1b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    opt = {"step": torch.tensor(3, dtype=torch.int32),
           "moments": [torch.full_like(params["final_ln"]["scale"], 0.5),
                       torch.zeros(2, 3, dtype=torch.float32)]}
    return params, opt


def _leaves(tree):
    return [leaf for _, leaf in store._paths(tree)]


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert isinstance(y, torch.Tensor)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_bit_exact(tmp_path):
    state = small_state()
    store.save(str(tmp_path), 3, state, extra={"step": 3})
    restored, extra = store.restore(str(tmp_path), state)
    assert extra["step"] == 3
    assert isinstance(restored, tuple) and isinstance(restored[1]["moments"],
                                                      list)
    _assert_same_tree(state, restored)


def test_latest_pointer_tracks_newest(tmp_path):
    state = small_state()
    store.save(str(tmp_path), 1, state)
    store.save(str(tmp_path), 5, state)
    assert store.latest_step(str(tmp_path)) == 5
    store.restore(str(tmp_path), state)   # no error


def test_restore_specific_step(tmp_path):
    params, _ = small_state()
    bumped = {k: v for k, v in params.items()}
    bumped["embed"] = params["embed"] + 1
    store.save(str(tmp_path), 1, params)
    store.save(str(tmp_path), 2, bumped)
    r1, _ = store.restore(str(tmp_path), params, step=1)
    assert torch.equal(r1["embed"], params["embed"])
    r2, _ = store.restore(str(tmp_path), params)
    assert torch.equal(r2["embed"], bumped["embed"])


def test_zstd_codec_roundtrip(tmp_path):
    pytest.importorskip("zstandard")
    state = small_state()
    store.save(str(tmp_path), 1, state, codec="zstd")
    assert os.path.exists(os.path.join(str(tmp_path), "step_000000001",
                                       "arrays.msgpack.zst"))
    restored, _ = store.restore(str(tmp_path), state)
    _assert_same_tree(state, restored)


def test_raw_codec_roundtrip(tmp_path):
    """The fallback codec must work regardless of zstandard availability."""
    state = small_state()
    store.save(str(tmp_path), 2, state, codec="raw")
    assert os.path.exists(os.path.join(str(tmp_path), "step_000000002",
                                       "arrays.msgpack"))
    restored, _ = store.restore(str(tmp_path), state)
    _assert_same_tree(state, restored)


def test_shape_mismatch_raises(tmp_path):
    params, _ = small_state()
    store.save(str(tmp_path), 1, params)
    wrong = dict(params, embed=torch.zeros(params["embed"].shape[0] + 1,
                                           params["embed"].shape[1]))
    with pytest.raises(AssertionError):
        store.restore(str(tmp_path), wrong)


def test_zstd_checkpoint_without_the_package_raises(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    store.save(str(tmp_path), 1, _tree(1), codec="zstd")
    monkeypatch.setattr(store, "HAVE_ZSTD", False)
    with pytest.raises(ImportError, match="'zstandard' package is not "
                                          "installed"):
        store.restore(str(tmp_path), _tree())
    with pytest.raises(ImportError, match="requires the 'zstandard'"):
        store.save(str(tmp_path), 2, _tree(2), codec="zstd")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="unknown codec"):
        store.save(str(tmp_path), 3, _tree(3), codec="lz4")


# ---------------------------------------------------------------------------
# crash-window regressions (the SON resume path depends on them)
# ---------------------------------------------------------------------------

def _tree(v=0):
    return {"a": np.arange(6, dtype=np.int64) + v,
            "b": np.full((2, 3), float(v), np.float32)}


class Boom(RuntimeError):
    pass


def test_save_crash_between_renames_keeps_previous_checkpoint(
        tmp_path, monkeypatch):
    """A crash after the old step is renamed aside but before the new dir
    lands must leave the previous checkpoint restorable."""
    d = str(tmp_path)
    store.save(d, 1, _tree(1), extra={"v": 1}, codec="raw")
    real_rename = os.rename

    def crashing(src, dst):
        if src.endswith(".tmp"):        # the commit rename of the new dir
            raise Boom()
        return real_rename(src, dst)

    monkeypatch.setattr(store.os, "rename", crashing)
    with pytest.raises(Boom):
        store.save(d, 1, _tree(2), extra={"v": 2}, codec="raw")
    monkeypatch.undo()

    assert store.latest_step(d) == 1
    restored, extra = store.restore(d, _tree())
    assert extra["v"] == 1
    np.testing.assert_array_equal(restored["a"].numpy(), _tree(1)["a"])
    # the next save heals the crashed layout and commits normally
    store.save(d, 1, _tree(3), extra={"v": 3}, codec="raw")
    _, extra = store.restore(d, _tree())
    assert extra["v"] == 3
    assert not any(n.endswith((".tmp", ".old")) for n in os.listdir(d))


def test_stale_tmp_dir_wiped_not_reused(tmp_path):
    """A leftover .tmp from a crashed save must not leak its files into the
    next checkpoint (e.g. a stale zstd payload next to a new raw one)."""
    d = str(tmp_path)
    tmp = os.path.join(d, "step_000000001.tmp")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "arrays.msgpack.zst"), "wb") as f:
        f.write(b"junk from a crashed zstd attempt")
    step_dir = store.save(d, 1, _tree(1), codec="raw")
    assert sorted(os.listdir(step_dir)) == ["arrays.msgpack", "manifest.json"]
    store.restore(d, _tree())


def test_keep_last_retention_prunes_oldest(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        store.save(d, s, _tree(s), codec="raw", keep_last=2)
    assert store.steps_present(d) == [4, 5]
    assert store.latest_step(d) == 5
    store.restore(d, _tree(), step=4)


def test_restore_missing_step_names_requested_and_present(tmp_path):
    d = str(tmp_path)
    store.save(d, 2, _tree(2), codec="raw")
    with pytest.raises(FileNotFoundError) as ei:
        store.restore(d, _tree(), step=7)
    assert "7" in str(ei.value) and "2" in str(ei.value)
    with pytest.raises(FileNotFoundError) as ei:
        store.restore(str(tmp_path / "empty"), _tree())
    assert "none" in str(ei.value)


def test_latest_step_ignores_dangling_pointer(tmp_path):
    """latest_step must not report a step whose directory was deleted —
    fall back to the newest checkpoint actually on disk."""
    d = str(tmp_path)
    store.save(d, 1, _tree(1), extra={"v": 1}, codec="raw")
    store.save(d, 3, _tree(3), codec="raw")
    shutil.rmtree(os.path.join(d, "step_000000003"))
    assert store.latest_step(d) == 1
    _, extra = store.restore(d, _tree())
    assert extra["v"] == 1


def test_crashed_save_is_recovered_from_old_on_read(tmp_path):
    """A save that died after renaming the old step aside leaves it only
    under ``.old``: both stores find it, and reading renames it back."""
    d = str(tmp_path)
    store.save(d, 4, _tree(4), extra={"v": 4}, codec="raw")
    os.rename(os.path.join(d, "step_000000004"),
              os.path.join(d, "step_000000004.old"))
    assert store.steps_present(d) == ref_store.steps_present(d) == [4]
    flat, extra = store.load_arrays(d)
    assert extra["v"] == 4
    np.testing.assert_array_equal(flat["a"], _tree(4)["a"])
    assert sorted(os.listdir(d)) == ["LATEST", "step_000000004"]


# ---------------------------------------------------------------------------
# the msgpack codec against msgpack itself
# ---------------------------------------------------------------------------

# (what varies, size): each straddles a format boundary — fixmap/map16/
# map32 entries, fixstr/str8/str16/str32 keys, bin8/bin16/bin32 values
MSGPACK_CASES = ([("entries", n) for n in (0, 1, 15, 16, 65_535, 65_536)]
                 + [("key", n) for n in (0, 31, 32, 255, 256, 65_535,
                                         65_536)]
                 + [("value", n) for n in (0, 255, 256, 65_535, 65_536)])


def _payload(what, n):
    if what == "entries":
        return {f"k{i:06d}": bytes([i % 256]) for i in range(n)}
    if what == "key":
        return {"a" * n: b"\x01\x02", "b": b""}
    return {"v": bytes(range(256)) * (n // 256) + bytes(n % 256)}


@pytest.mark.parametrize("what,n", MSGPACK_CASES,
                         ids=[f"{w}{n}" for w, n in MSGPACK_CASES])
def test_msgpack_codec_equals_msgpack(what, n):
    msgpack = pytest.importorskip("msgpack")
    payload = _payload(what, n)
    blob = store.msgpack_pack(payload)
    assert blob == msgpack.packb(payload)
    assert msgpack.unpackb(blob) == payload
    assert store.msgpack_unpack(blob) == payload
    assert store.msgpack_unpack(msgpack.packb(payload)) == payload


@pytest.mark.parametrize("case", ["int_value", "str_value", "nested_map",
                                  "array", "nil", "int_key", "trailing",
                                  "truncated_value", "truncated_header"])
def test_msgpack_decoder_refuses_other_types(case):
    msgpack = pytest.importorskip("msgpack")
    blob = {
        "int_value": lambda: msgpack.packb({"a": 1}),
        "str_value": lambda: msgpack.packb({"a": "text"}),
        "nested_map": lambda: msgpack.packb({"a": {"b": b"c"}}),
        "array": lambda: msgpack.packb([b"a"]),
        "nil": lambda: msgpack.packb(None),
        "int_key": lambda: msgpack.packb({1: b"a"}),
        "trailing": lambda: msgpack.packb({"a": b"b"}) + b"\x00",
        "truncated_value": lambda: msgpack.packb({"a": b"bcd"})[:-1],
        "truncated_header": lambda: msgpack.packb({"a": b"b" * 300})[:5],
    }[case]()
    with pytest.raises(ValueError, match="msgpack"):
        store.msgpack_unpack(blob)


# ---------------------------------------------------------------------------
# the two stores against each other
# ---------------------------------------------------------------------------

def _mixed_tree(as_torch):
    """Every dtype the planes write, nested dicts, a list, a tuple, a
    Python scalar and a None leaf (dropped by both flattenings)."""
    g = np.random.default_rng(0)
    leaves = {
        "u8": (g.random((5, 7)) < 0.5).astype(np.uint8),
        "i32": g.integers(-9, 9, (4,), dtype=np.int32),
        "i64": g.integers(0, 2**40, (3, 2), dtype=np.int64),
        "f32": g.random((2, 2, 2)).astype(np.float32),
        "empty": np.zeros((0, 3), np.int32),
    }
    conv = (lambda a: torch.from_numpy(a.copy())) if as_torch else (
        lambda a: a)
    return {"zeta": conv(leaves["u8"]),
            "alpha": {"b": conv(leaves["i32"]), "a": [conv(leaves["i64"]),
                                                      None]},
            "mid": (conv(leaves["f32"]), conv(leaves["empty"])),
            "scalar": 7}


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_raw_checkpoints_are_byte_identical(tmp_path, leaves):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_store.save(ref_dir, 11, _mixed_tree(False), extra={"k": [1, "x"]},
                   codec="raw")
    store.save(port_dir, 11, _mixed_tree(leaves == "torch"),
               extra={"k": [1, "x"]}, codec="raw")
    for name in ("manifest.json", "arrays.msgpack"):
        with open(os.path.join(ref_dir, "step_000000011", name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, "step_000000011", name), "rb") as f:
            assert f.read() == want, name
    for name in ("LATEST",):
        with open(os.path.join(ref_dir, name)) as f, \
                open(os.path.join(port_dir, name)) as g:
            assert f.read() == g.read()
    with open(os.path.join(port_dir, "step_000000011", "manifest.json")) as f:
        keys = list(json.load(f)["arrays"])
    assert keys == ["alpha/a/0", "alpha/b", "mid/0", "mid/1", "scalar",
                    "zeta"]


@pytest.mark.parametrize("codec", ["raw", "zstd"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_either_store_restores_the_others_step(tmp_path, writer, codec):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    d = str(tmp_path)
    g = np.random.default_rng(1)
    w = g.standard_normal((6, 4)).astype(np.float32)
    ids = g.integers(0, 100, (9,), dtype=np.int32)
    bf16_bits = torch.from_numpy(w).to(torch.bfloat16)
    if writer == "reference":
        ref_store.save(d, 5, {"w": jnp.asarray(w, jnp.bfloat16),
                              "x": [w, ids]}, extra={"by": writer},
                       codec=codec)
    else:
        store.save(d, 5, {"w": bf16_bits, "x": [w, ids]},
                   extra={"by": writer}, codec=codec)
    like = {"w": np.zeros((6, 4)), "x": [w, ids]}

    port, extra = store.restore(d, {"w": bf16_bits, "x": [w, ids]})
    assert extra == {"by": writer}
    assert port["w"].dtype == torch.bfloat16
    assert torch.equal(port["w"], bf16_bits)
    assert torch.equal(port["x"][0], torch.from_numpy(w))
    assert torch.equal(port["x"][1], torch.from_numpy(ids))

    ref, extra = ref_store.restore(d, like)
    assert extra == {"by": writer}
    assert ref["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(ref["w"], np.float32),
        bf16_bits.to(torch.float32).numpy())
    np.testing.assert_array_equal(np.asarray(ref["x"][0]), w)
    np.testing.assert_array_equal(np.asarray(ref["x"][1]), ids)

    flat, _ = store.load_arrays(d)
    ref_flat, _ = ref_store.load_arrays(d)
    assert sorted(flat) == sorted(ref_flat) == ["w", "x/0", "x/1"]
    np.testing.assert_array_equal(
        flat["w"], bf16_bits.view(torch.int16).numpy().view(np.uint16))
    for key in ("x/0", "x/1"):
        np.testing.assert_array_equal(flat[key], ref_flat[key])
    assert store.latest_step(d) == ref_store.latest_step(d) == 5


def test_model_state_written_by_the_port_restores_in_the_reference(tmp_path):
    params, opt = small_state()
    store.save(str(tmp_path), 1, (params, opt), codec="raw")
    like = ({k: v for k, v in _numpy_like(params).items()},
            _numpy_like(opt))
    restored, _ = ref_store.restore(str(tmp_path), like)
    port_leaves = _leaves((params, opt))
    ref_leaves = [leaf for _, leaf in store._paths(restored)]
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_array_equal(
            p.to(torch.float32).numpy(), np.asarray(r, np.float32))
        assert str(np.asarray(r).dtype) == str(p.dtype).split(".")[-1]


def _numpy_like(tree):
    if isinstance(tree, dict):
        return {k: _numpy_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_like(v) for v in tree)
    return np.zeros(tuple(tree.shape))


def _train_state():
    """A smoke model's parameters with the trainer's ``OptState`` (a
    ``NamedTuple`` of float32 moments and an int32 step), and the same
    state in the reference's types (moment values set apart)."""
    from repro.optim.adamw import OptState as RefOptState
    from repro_torch.optim.adamw import OptState, init_opt_state, tree_map
    import jax
    params, _ = small_state()
    state = init_opt_state(params)
    state = OptState(tree_map(lambda m: m + 0.25, state.mu),
                     tree_map(lambda n: n + 0.5, state.nu),
                     torch.tensor(9, dtype=torch.int32))

    def to_jnp(t):
        a = t.to(torch.float32).numpy()
        return jnp.asarray(a, jnp.bfloat16 if t.dtype == torch.bfloat16
                           else a.dtype)
    ref_params = jax.tree.map(to_jnp, params, is_leaf=torch.is_tensor)
    ref_state = RefOptState(
        *(jax.tree.map(to_jnp, t, is_leaf=torch.is_tensor)
          for t in (state.mu, state.nu)), jnp.int32(9))
    return (params, state), (ref_params, ref_state)


def test_train_state_roundtrips_under_the_references_keys(tmp_path):
    """A (params, OptState) tree round-trips bit for bit, comes back as an
    ``OptState``, and its keys are the reference's ``_flatten`` keys
    (``1/.mu/...``, ``1/.nu/...``, ``1/.step``)."""
    (params, state), (ref_params, ref_state) = _train_state()
    store.save(str(tmp_path), 3, (params, state), codec="raw")
    (p2, s2), _ = store.restore(str(tmp_path), (params, state))
    assert type(s2) is type(state) and s2._fields == ("mu", "nu", "step")
    for a, b in zip(_leaves((params, state)), _leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert s2.step.dtype == torch.int32 and int(s2.step) == 9
    keys = set(store._flatten((params, state)))
    want, _ = ref_store._flatten((ref_params, ref_state))
    assert keys == set(want)
    assert {"1/.step", "1/.mu/embed", "1/.nu/final_ln/scale"} <= keys
    # plain tuples and lists keep their index keys
    assert set(store._flatten((1, [2, (3,)]))) == {"0", "1/0", "1/1/0"}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_crosses_between_the_packages(tmp_path, writer):
    (params, state), (ref_params, ref_state) = _train_state()
    d = str(tmp_path)
    if writer == "reference":
        ref_store.save(d, 4, (ref_params, ref_state), extra={"step": 4})
    else:
        store.save(d, 4, (params, state), extra={"step": 4})
    (p2, s2), extra = store.restore(d, (params, state))
    assert extra == {"step": 4} and isinstance(s2, type(state))
    for a, b in zip(_leaves((params, state)), _leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    (rp, rs), extra = ref_store.restore(d, (ref_params, ref_state))
    assert type(rs).__name__ == "OptState" and int(rs.step) == 9
    for a, b in zip(_leaves((params, state)), _leaves((rp, rs))):
        np.testing.assert_array_equal(a.to(torch.float32).numpy(),
                                      np.asarray(b, np.float32))
