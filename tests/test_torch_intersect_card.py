"""The port's intersect kernel (the Eclat plane's) on the card, against its
plain version.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference, so they run on a
machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_intersect_card.py

Intersection counts are integers, so the kernel must equal
``intersect_count_plain`` exactly.  Inputs are random words drawn with
numpy from a seed (about half with bit 31 set), with the first half of
row 0 all ones.  Each call must add exactly one launch.  The launch
geometry is the wrapper's own choice, so the shapes are picked to reach
every kind of geometry it can take (a CPU test checks that they do).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.support_count import intersect  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _slabs(M, W, seed, device):
    rng = np.random.default_rng(seed)
    A, B = rng.integers(0, 2**32, size=(2, M, W), dtype=np.uint32)
    A[0, : W // 2] = 0xFFFFFFFF
    return [torch.from_numpy(x.view(np.int32)).to(device) for x in (A, B)]


def _held(A, B):
    launches = intersect.intersect_count_words.launches
    got = intersect.intersect_count_words(A, B)
    want = intersect.intersect_count_plain(A, B)
    torch.cuda.synchronize()
    assert intersect.intersect_count_words.launches == launches + 1
    assert torch.equal(got, want)
    return want


# (M, W): the dense Eclat tile, the whole k = 2 slab and a retail tile;
# chip_smoke's ragged shapes (one row, 129 rows, one quad a row, 516
# words); rows longer than a stage's chunk
CARD_SHAPES = [(128, 3200), (2176, 3200), (640, 2816), (1, 4), (129, 4),
               (1, 3200), (129, 2816), (3, 516), (5, 20_000), (200, 9000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_intersect_count_equals_plain_version_on_the_card(card, shape):
    _held(*_slabs(*shape, sum(shape), card))


# every row_threads that intersect.geometry can pick
REACHABLE = list(intersect.ROW_THREADS)


def _shape_for(row_threads):
    """An (M, W) for which intersect.geometry picks ``row_threads``, ragged
    in M: rows of 128 quads (the longest a warp takes) and of 800."""
    return {32: (129, 512), 512: (131, 3200)}[row_threads]


@pytest.mark.parametrize("row_threads", REACHABLE)
def test_every_reachable_intersect_geometry_has_a_shape(row_threads):
    assert intersect.geometry(_shape_for(row_threads)[1]).row_threads == \
        row_threads


@pytest.mark.cuda
@pytest.mark.parametrize("row_threads", REACHABLE)
def test_intersect_count_equals_plain_version_at_every_geometry(card,
                                                                row_threads):
    M, W = _shape_for(row_threads)
    assert intersect.geometry(W).row_threads == row_threads
    _held(*_slabs(M, W, 7, card))
