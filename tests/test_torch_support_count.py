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


# (N, M, I) -> the int8 kernel's launch on 132 SMs, as (warpgroups, N,
# stages), and its CTA count: the dense mine's k = 2 round takes 128 x 256
# tiles with as many slabs in flight as its ring holds; its later rounds
# (M 256, 128) take narrower candidate tiles, so that 98 CTAs hold every
# slab in flight; a round of 512 keeps 256-wide tiles; a short corpus
# takes 64-wide tiles and a ring of every slab; a tall tile count, or
# wide tiles over a wave, takes two warpgroups
SC_GEOMETRIES = {
    (3128, 2176, 1024): ((2, 256, 4), 225),
    (3128, 256, 1024): ((1, 128, 8), 98),
    (3128, 128, 1024): ((1, 64, 8), 98),
    (3128, 512, 1024): ((1, 256, 5), 98),
    (77, 200, 128): ((1, 64, 1), 8),
    (1000, 257, 1024): ((1, 64, 8), 80),
    (300, 37, 960): ((1, 64, 8), 5),
    (300, 37, 384): ((1, 64, 3), 5),
    (100_000, 128, 1024): ((2, 128, 7), 782),
    (512, 128, 1024): ((1, 64, 8), 16),
    (100_000, 2176, 1024): ((2, 256, 4), 7038),
    (8485, 256, 1024): ((2, 256, 4), 67),
    (3128, 2176, 4096): ((2, 256, 4), 225),
    (65, 1, 64): ((1, 64, 1), 2),
    (1, 3, 64): ((1, 64, 1), 1),
}


@pytest.mark.parametrize("shape", list(SC_GEOMETRIES), ids=str)
def test_int8_support_count_launch_geometry(shape):
    want, ctas = SC_GEOMETRIES[shape]
    geom = kernel.geometry(*shape)
    assert tuple(geom) == want
    assert f"= {ctas} CTAs" in geom.describe(*shape)


@pytest.mark.parametrize("sms", [8, 114, 132])
def test_int8_support_count_geometry_fits(sms):
    """Over ragged shapes every pick fits the kernel: a tile width the
    kernel is built for, no wider than M needs and narrower only where
    the wider tiles would fill less than half a wave, two warpgroups
    only where 64-row tiles overfill a wave, and a ring of 1 to 8 stages
    (no more than a CTA's slabs, two where it reads several) that fits
    in shared memory."""
    for N in (1, 63, 64, 65, 3128, 8485, 100_000, 65535 * 128 + 1):
        for M in (1, 37, 64, 65, 128, 129, 256, 257, 2176):
            for I in (64, 128, 192, 960, 1024, 4096):
                g = kernel.geometry(N, M, I, sms)
                assert g.n in kernel.TILE_WIDTHS
                cover = next(w for w in kernel.TILE_WIDTHS
                             if w >= min(M, 256))
                rows64 = -(-N // 64)
                assert g.n <= cover
                if g.n < cover:          # halved from 2n: few tiles there
                    assert 2 * rows64 * -(-M // (2 * g.n)) <= sms
                if g.n > 64:             # halving stopped: enough tiles
                    assert 2 * rows64 * -(-M // g.n) > sms
                c_tiles = -(-M // g.n)
                assert g.warpgroups == (2 if -(-N // 64) * c_tiles > sms
                                        else 1)
                t_tiles = -(-N // (64 * g.warpgroups))
                slabs = -(-I // kernel.SLAB)
                per_cta = slabs * -(-t_tiles // min(t_tiles,
                                                    kernel.MAX_GRID_Y))
                assert 1 <= g.stages <= min(kernel.MAX_STAGES, per_cta)
                assert g.stages >= min(2, per_cta)
                assert g.smem_bytes() <= kernel.SMEM_LIMIT


def test_int8_support_count_max_stages_fill_shared_memory():
    for wg in (1, 2):
        for n in kernel.TILE_WIDTHS:
            s = kernel.max_stages(wg, n)
            assert kernel.Geometry(wg, n, s).smem_bytes() <= \
                kernel.SMEM_LIMIT
            assert s == kernel.MAX_STAGES or kernel.Geometry(
                wg, n, s + 1).smem_bytes() > kernel.SMEM_LIMIT


# (N, M, W) -> the packed kernel's launch on 132 SMs, as (tiles a CTA,
# stages), and its CTA count: tiles of 64 x 64 throughout; the dense
# mine's k = 2 round walks four transaction tiles a CTA (442 CTAs, under 4
# an SM) through a ring of two, its later rounds (M 256, 128) one; B11's
# tiles of 512 transactions over 4 words; a 100,000-row corpus walks 128
# tiles a CTA; rows of two slabs take a ring of two
PACKED_GEOMETRIES = {
    (3128, 2176, 32): ((4, 2), 442),
    (3128, 256, 32): ((1, 1), 196),
    (3128, 128, 32): ((1, 1), 98),
    (512, 128, 4): ((1, 1), 16),
    (512, 2176, 4): ((1, 1), 272),
    (512, 8, 4): ((1, 1), 8),
    (100_000, 2176, 32): ((128, 2), 442),
    (3128, 2176, 64): ((4, 2), 442),
    (300, 37, 64): ((1, 2), 5),
    (1, 3, 4): ((1, 1), 1),
}


@pytest.mark.parametrize("shape", list(PACKED_GEOMETRIES), ids=str)
def test_packed_support_count_launch_geometry(shape):
    want, ctas = PACKED_GEOMETRIES[shape]
    N, M, W = shape
    geom = fused.geometry(N, M, W)
    assert (geom.tiles, geom.stages(N, W)) == want
    assert f"= {ctas} CTAs" in geom.describe(N, M, W)


@pytest.mark.parametrize("sms", [8, 114, 132])
def test_packed_support_count_geometry_fits(sms):
    """Over ragged shapes every pick fits the kernel: a CTA walks the
    fewest tiles (a power of two) that keep its CTAs at CTAS_PER_SM an SM
    or under, or every tile, and under 4,096 tiles (its hit counters'
    limit); a ring of two stages where it reads more than one slab, else
    one."""
    for N in (1, 63, 64, 65, 512, 3128, 8485, 100_000, 65535 * 128 + 1):
        for M in (1, 37, 64, 65, 128, 129, 256, 257, 2176):
            for W in (4, 8, 32, 64, 128):
                g = fused.geometry(N, M, W, sms)
                t_tiles, c_tiles = -(-N // 64), -(-M // 64)
                limit = fused.CTAS_PER_SM * sms
                assert g.tiles & (g.tiles - 1) == 0
                assert -(-t_tiles // g.tiles) * c_tiles <= limit or \
                    g.tiles >= min(t_tiles, fused.MAX_TILES)
                if g.tiles > 1:
                    assert -(-t_tiles // (g.tiles // 2)) * c_tiles > limit
                walked = -(-t_tiles // min(-(-t_tiles // g.tiles),
                                           kernel.MAX_GRID_Y))
                assert walked < 4096
                assert g.stages(N, W) == min(-(-W // 32) * walked, 2)
