"""The port's tid-slab intersection (the Eclat kernel), held bit-exact
against the reference.

On the CPU the wrapper runs its plain PyTorch version; these tests hold it,
and the padding around it in ``ops.intersect_count``, to the reference's
jnp oracle ``intersect_count_ref`` and to a numpy unpackbits oracle (the
one ``tests/test_kernel_fuzz.py`` holds the Pallas kernel to).  The CUDA
kernel itself is compared with the same plain version on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.support_count.ref import (  # noqa: E402
    intersect_count_ref as jnp_intersect_count_ref)
from repro_torch.kernels import loader  # noqa: E402
from repro_torch.kernels.support_count import intersect, ops  # noqa: E402
from repro_torch.kernels.support_count.ref import (  # noqa: E402
    intersect_count_ref)
from repro_torch.runtime import donated_and  # noqa: E402


def np_intersect_count(A, B):
    """popcount(A & B) per row via unpackbits on the raw little-endian
    bytes (the numpy oracle of tests/test_kernel_fuzz.py)."""
    bits = np.unpackbits((np.asarray(A) & np.asarray(B)).view(np.uint8),
                         axis=1, bitorder="little")
    return bits.sum(axis=1).astype(np.int32)


def _slabs(m, w, seed):
    """Two [m, w] uint32 slabs of random words (about half with bit 31
    set), row 0 all ones where there is a row, plus their int32 views."""
    rng = np.random.default_rng(seed)
    A, B = rng.integers(0, 2**32, size=(2, m, w), dtype=np.uint32)
    if m:
        A[0] = B[0] = 0xFFFFFFFF
    return A, B, torch.from_numpy(A.view(np.int32)), \
        torch.from_numpy(B.view(np.int32))


# (M, W): ragged rows and words, one word, an empty level, aligned shapes
SHAPES = [(1, 1), (5, 4), (0, 4), (0, 1), (128, 128), (129, 130), (200, 3),
          (7, 257)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_intersect_count_matches_reference(shape):
    A, B, At, Bt = _slabs(*shape, seed=sum(shape))
    want = np_intersect_count(A, B)
    jnp_ref = np.asarray(jnp_intersect_count_ref(jnp.asarray(A),
                                                 jnp.asarray(B)))
    np.testing.assert_array_equal(jnp_ref, want)
    for got in (ops.intersect_count(At, Bt), intersect_count_ref(At, Bt),
                intersect.intersect_count_plain(At, Bt)):
        assert got.dtype == torch.int32 and got.shape == (shape[0],)
        np.testing.assert_array_equal(got.numpy(), want)
    if shape[0]:
        assert int(ops.intersect_count(At, Bt)[0]) == 32 * shape[1]


def test_sign_bit_words_count_all_32_bits():
    """A word with bit 31 set is a negative int32; its count must still
    cover exactly its 32 bits."""
    words = np.array([[0x80000000, 0xFFFFFFFF, 0x80000001, 0x7FFFFFFF]],
                     dtype=np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    assert intersect_count_ref(t, t).tolist() == [1 + 32 + 2 + 31]
    assert ops.intersect_count(t, t).tolist() == [66]


def test_unequal_shapes_raise():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.intersect_count(a, a[:3])
    with pytest.raises(ValueError):
        ops.intersect_count(a, a[:, :4])


def test_cpu_wrapper_runs_plain_version_without_counting_a_launch():
    A, B, At, Bt = _slabs(130, 8, seed=3)
    before = intersect.intersect_count_words.launches
    got = intersect.intersect_count_words(At, Bt)
    np.testing.assert_array_equal(got.numpy(), np_intersect_count(A, B))
    ops.intersect_count(At, Bt)
    assert intersect.intersect_count_words.launches == before


def test_wrapper_rejects_bad_inputs():
    w = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        intersect.intersect_count_words(w.to(torch.int64), w.to(torch.int64))
    with pytest.raises(TypeError):
        intersect.intersect_count_words(w, w.to(torch.uint8))
    with pytest.raises(ValueError):
        intersect.intersect_count_words(w, w[:, :4])
    with pytest.raises(ValueError):
        intersect.intersect_count_words(w[0], w[0])
    # a device that is neither the CPU nor a card has no kernel and no
    # plain fallback; slabs on two devices are refused
    with pytest.raises(ValueError):
        intersect.intersect_count_words(w.to("meta"), w.to("meta"))
    with pytest.raises(ValueError):
        intersect.intersect_count_words(w, w.to("meta"))


def test_donated_and_writes_into_its_first_operand():
    A, B, At, Bt = _slabs(6, 4, seed=9)
    want = A & B                   # At shares A's memory: take it first
    out = donated_and(At, Bt)
    assert out.data_ptr() == At.data_ptr()
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)


def test_loader_builds_the_intersect_source():
    assert (loader.CSRC / "intersect_count.cu").is_file()
    p = loader.library_path("intersect_count")
    assert p.parent == loader.BUILD_DIR
    assert p != loader.library_path("support_count_packed")


# (M, W) -> the threads that own a row and the launch: 512 at the dense
# tile, the whole k = 2 slab and the retail tile; a warp for rows of at
# most 128 quads (ragged M and W included), 512 past them
INTERSECT_GEOMETRIES = {
    (128, 3200): (512, "128 CTAs of 512 threads, 2 loads"),
    (2176, 3200): (512, "2176 CTAs of 512 threads, 2 loads"),
    (640, 2816): (512, "640 CTAs of 512 threads, 2 loads"),
    (1, 4): (32, "1 CTAs of 256 threads, 1 loads"),
    (129, 4): (32, "17 CTAs of 256 threads, 1 loads"),
    (1, 516): (512, "1 CTAs of 512 threads, 1 loads"),
    (129, 516): (512, "129 CTAs of 512 threads, 1 loads"),
    (129, 512): (32, "17 CTAs of 256 threads, 4 loads"),
    (128, 128): (32, "16 CTAs of 256 threads, 1 loads"),
}


@pytest.mark.parametrize("shape", list(INTERSECT_GEOMETRIES), ids=str)
def test_intersect_launch_geometry(shape):
    threads, launch = INTERSECT_GEOMETRIES[shape]
    geom = intersect.geometry(shape[1])
    assert geom.row_threads == threads
    assert launch in geom.describe(*shape)


def test_intersect_geometry_fits():
    """Every row length gets a width the kernel is built for: a warp up to
    WARP_ROW_QUADS quads a row, 512 threads past it."""
    for W in (4, 8, 128, 508, 512, 516, 2816, 3200, 100_000):
        t = intersect.geometry(W).row_threads
        assert t in intersect.ROW_THREADS
        assert (t == 32) == (W // 4 <= intersect.WARP_ROW_QUADS)
