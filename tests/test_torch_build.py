"""The kernel build's library names (dfanerf_torch/ops/_build.py): a
library is named by a digest of its source, the csrc headers the source
includes and the flags, so an edited header can never load a stale library.
Nothing is compiled here."""

import shutil

import pytest

from dfanerf_torch.ops import _build


def test_sources_list_every_kernel():
    assert _build.SOURCES == ("render_rays", "pair_field", "far_eval", "sigma_head",
                              "render_head", "pair_hier")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()


@pytest.mark.parametrize("name", _build.SOURCES)
def test_digest_covers_the_included_header(tmp_path, name):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert [h.name for h in _build.local_includes(csrc / f"{name}.cu")] == ["field_mlp.cuh"]
    same = _build.library_path(name, csrc)
    assert same == _build.library_path(name)
    header = csrc / "field_mlp.cuh"
    header.write_text(header.read_text().replace("constexpr int M = 128;", "constexpr int M = 64;"))
    edited = _build.library_path(name, csrc)
    assert edited != same and edited.parent == same.parent
