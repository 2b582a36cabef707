"""The port's support-count kernels, held bit-exact against the reference.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those versions, and the padding/variant dispatch around them, to the
reference's jnp oracle and to its int8 Pallas kernel in interpret mode.
The CUDA kernels themselves are compared with the same plain versions on
the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.support_count import fused as ref_fused  # noqa: E402
from repro.kernels.support_count import ops as ref_ops  # noqa: E402
from repro.kernels.support_count.ref import (  # noqa: E402
    support_count_ref as jnp_support_count_ref)
from repro_torch.core.itemsets import support_counts_ref  # noqa: E402
from repro_torch.kernels import loader  # noqa: E402
from repro_torch.kernels.support_count import fused, kernel, ops  # noqa: E402
from repro_torch.kernels.support_count.ref import (  # noqa: E402
    support_count_ref)


def _case(n_tx, n_cands, n_items, seed):
    """Random 0/1 transactions plus candidates that are subsets of some
    transactions (so counts are non-trivial), made with numpy."""
    rng = np.random.default_rng(seed)
    T = (rng.random((n_tx, n_items)) < 0.4).astype(np.uint8)
    C = np.zeros((n_cands, n_items), np.uint8)
    for m in range(n_cands):
        row = T[rng.integers(n_tx)] if n_tx else np.ones(n_items, np.uint8)
        items = np.flatnonzero(row)
        if len(items):
            k = rng.integers(1, min(4, len(items)) + 1)
            C[m, rng.choice(items, size=k, replace=False)] = 1
        else:
            C[m, rng.integers(n_items)] = 1
    return T, C


def _oracle(T, C):
    return np.asarray(jnp_support_count_ref(jnp.asarray(T), jnp.asarray(C)))


# (n_tx, n_candidates, n_items): N not a multiple of 8, M = 0, item counts
# not a multiple of 32, one word, and aligned shapes
SHAPES = [(13, 7, 40), (64, 0, 96), (37, 130, 32), (8, 5, 20), (256, 128, 128),
          (100, 33, 200)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", [None, "mxu"], ids=["packed", "mxu"])
def test_ops_support_count_matches_reference(shape, variant):
    T, C = _case(*shape, seed=sum(shape))
    tuning = None if variant is None else {"variant": variant}
    got = ops.support_count(torch.from_numpy(T), torch.from_numpy(C),
                            tuning=tuning)
    assert got.dtype == torch.int32 and got.shape == (shape[1],)
    want = _oracle(T, C)
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's int8 Pallas kernel (support_count_pallas), interpreted
    pallas = np.asarray(ref_ops.support_count(
        jnp.asarray(T), jnp.asarray(C), interpret=True,
        tuning={"variant": "mxu"}))
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_oracle_unpadded(shape):
    """The plain versions at raw shapes (no ops padding): the packed one on
    as few as one word, both with zero-size and padded candidate rows."""
    n_tx, n_cands, n_items = shape
    T, C = _case(*shape, seed=7 * sum(shape))
    want = _oracle(T, C)
    Tt, Ct = torch.from_numpy(T), torch.from_numpy(C)
    sizes = Ct.sum(dim=1, dtype=torch.int32)
    got_int8 = kernel.support_count_int8_plain(
        Tt.to(torch.int8), Ct.to(torch.int8), sizes)
    np.testing.assert_array_equal(got_int8.numpy(), want)
    pad = (-n_items) % 32
    Tw = fused.pack_words(torch.nn.functional.pad(Tt, (0, pad)))
    Cw = fused.pack_words(torch.nn.functional.pad(Ct, (0, pad)))
    got_packed = fused.support_count_packed_plain(Tw, Cw, sizes)
    np.testing.assert_array_equal(got_packed.numpy(), want)
    np.testing.assert_array_equal(support_count_ref(Tt, Ct).numpy(), want)
    np.testing.assert_array_equal(support_counts_ref(Tt, Ct).numpy(), want)


def test_single_word_and_zero_candidates():
    T, C = _case(19, 9, 32, seed=3)
    C[4] = 0                       # |c| = 0 matches every transaction
    Tw, Cw = fused.pack_words(torch.from_numpy(T)), fused.pack_words(
        torch.from_numpy(C))
    assert Tw.shape == (19, 1)
    sizes = torch.from_numpy(C).sum(dim=1, dtype=torch.int32)
    got = fused.support_count_packed_plain(Tw, Cw, sizes)
    np.testing.assert_array_equal(got.numpy(), _oracle(T, C))
    assert int(got[4]) == 19


def test_plain_packed_chunks_over_candidates(monkeypatch):
    """The plain packed version walks M in slices; a slice boundary inside
    M must not change a count."""
    T, C = _case(50, 77, 64, seed=11)
    monkeypatch.setattr(fused, "_PLAIN_CHUNK_BYTES", 50 * 2 * 8 * 10)
    Tt, Ct = torch.from_numpy(T), torch.from_numpy(C)
    got = fused.support_count_packed_plain(
        fused.pack_words(Tt), fused.pack_words(Ct),
        Ct.sum(dim=1, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), _oracle(T, C))


def test_pack_words_matches_reference_bits():
    rng = np.random.default_rng(0)
    x = (rng.random((9, 128)) < 0.5).astype(np.uint8)
    x[0] = 1                       # every bit set: the sign bit too
    want = np.asarray(ref_fused.pack_words(jnp.asarray(x))).view(np.int32)
    got = fused.pack_words(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(1)
    v = np.concatenate([[0, 1, 2**31, 2**32 - 1],
                        rng.integers(0, 2**32, size=500)]).astype(np.int64)
    want = np.array([bin(int(x)).count("1") for x in v])
    np.testing.assert_array_equal(
        fused.popcount32(torch.from_numpy(v)).numpy(), want)


def test_cpu_wrappers_run_plain_versions_without_counting_launches():
    T, C = _case(40, 20, 64, seed=5)
    Tt, Ct = torch.from_numpy(T), torch.from_numpy(C)
    sizes = Ct.sum(dim=1, dtype=torch.int32)
    before = (fused.support_count_packed.launches,
              kernel.support_count_int8.launches)
    a = fused.support_count_packed(fused.pack_words(Tt),
                                   fused.pack_words(Ct), sizes)
    b = kernel.support_count_int8(Tt.to(torch.int8), Ct.to(torch.int8),
                                  sizes)
    np.testing.assert_array_equal(a.numpy(), _oracle(T, C))
    np.testing.assert_array_equal(b.numpy(), _oracle(T, C))
    assert (fused.support_count_packed.launches,
            kernel.support_count_int8.launches) == before


def test_wrappers_reject_bad_inputs():
    w = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        fused.support_count_packed(w.to(torch.int64), w,
                                   torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        fused.support_count_packed(w, w, torch.zeros(3, dtype=torch.int32))
    b = torch.zeros((4, 64), dtype=torch.int8)
    with pytest.raises(TypeError):
        kernel.support_count_int8(b, b, torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        kernel.support_count_int8(b, b[:, :32], torch.zeros(4,
                                                            dtype=torch.int32))
    # a device that is neither the CPU nor a card has no kernel and no
    # plain fallback
    with pytest.raises(ValueError):
        kernel.support_count_int8(b.to("meta"), b.to("meta"),
                                  torch.zeros(4, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError):
        ops.support_count(b, b, tuning={"variant": "bogus"})
    with pytest.raises(ValueError):
        ops.support_count(b, b, tuning={"bn": 256})


def test_loader_names_libraries_by_source_and_needs_nvcc(monkeypatch,
                                                          tmp_path):
    p = loader.library_path("support_count_packed")
    assert p.parent == loader.BUILD_DIR
    assert p.parent.parts[-2:] == ("build", "repro_torch")
    assert p != loader.library_path("support_count_int8")
    for name in ("support_count_packed", "support_count_int8"):
        assert (loader.CSRC / f"{name}.cu").is_file()
    monkeypatch.setattr(loader.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        loader._nvcc()
