"""The kernel loader's library names: each is a digest of a source and of
the ``csrc`` headers that source includes, so an edited header rebuilds
the libraries that include it and no other.  Pure Python: no compiler or
card is needed."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import loader  # noqa: E402

# each source and the headers it includes, directly or through another
INCLUDES = {
    "flash_attention": {"attention_sm90.cuh", "sm90.cuh"},
    "flash_attention_bwd": {"attention_sm90.cuh", "sm90.cuh"},
    "wkv6": {"sm90.cuh", "wkv6.cuh"},
    "wkv6_bwd": {"wkv6.cuh"},
    "support_count_int8": {"support_count_wgmma.cuh", "sm90.cuh"},
    "support_count_packed": {"support_count_wgmma.cuh", "sm90.cuh"},
    "rule_match_int8": {"rule_match_wgmma.cuh", "sm90.cuh"},
    "rule_match_packed": {"rule_match_wgmma.cuh", "sm90.cuh"},
    "intersect_count": set(),
    "selective_scan": {"selective_scan.cuh"},
    "selective_scan_bwd": {"selective_scan.cuh"},
}


@pytest.mark.parametrize("name", sorted(INCLUDES))
def test_sources_are_the_source_and_its_headers(name):
    found = loader.sources(name)
    assert found[0] == loader.CSRC / f"{name}.cu"
    assert {p.name for p in found[1:]} == INCLUDES[name]
    assert len(set(found)) == len(found)


def test_every_source_is_listed():
    assert {p.stem for p in loader.CSRC.glob("*.cu")} == set(INCLUDES)


@pytest.mark.parametrize("header", ["sm90.cuh", "rule_match_wgmma.cuh",
                                    "support_count_wgmma.cuh",
                                    "attention_sm90.cuh",
                                    "selective_scan.cuh", "wkv6.cuh"])
def test_a_header_edit_renames_only_its_includers(monkeypatch, tmp_path,
                                                  header):
    csrc = tmp_path / "csrc"
    shutil.copytree(loader.CSRC, csrc)
    monkeypatch.setattr(loader, "CSRC", csrc)
    before = {name: loader.library_path(name) for name in INCLUDES}
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    for name in INCLUDES:
        renamed = loader.library_path(name) != before[name]
        assert renamed == (header in INCLUDES[name]), name
