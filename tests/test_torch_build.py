"""The kernel build's library names (dfanerf_torch/ops/_build.py): a
library is named by a digest of its source, the csrc headers the source
includes and the flags, so an edited header can never load a stale library;
and every binding's launch functions are those of its source. Nothing is
compiled here."""

import re
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


def _bindings():
    from dfanerf_torch.ops import far_eval, fused_render, pair_field, pair_hier, render_head
    from dfanerf_torch.ops import sigma_head

    return [fused_render.render_rays_kernel, pair_field.pair_field_kernel,
            pair_field.pair2_field_kernel, far_eval.far_head_kernel, far_eval.far_torso_kernel,
            far_eval.far_joint_kernel,
            sigma_head.sigma_head_kernel, render_head.render_head_kernel,
            pair_hier.pair_sigma_kernel, pair_hier.pair_field_perz_kernel]


@pytest.mark.parametrize("binding", _bindings(), ids=lambda b: next(iter(b._launchers)))
def test_launchers_match_their_sources(binding):
    """Each ctypes launcher is an extern "C" function of its library's
    source taking as many arguments as the binding passes (ctypes cannot
    check that), and the source defines the library's layout function."""
    assert binding.name in _build.SOURCES
    src = (_build.CSRC / f"{binding.name}.cu").read_text()
    assert f"int {binding.name}_layout(int* sizes)" in src
    for fn, argtypes in binding._launchers.items():
        decl = re.search(rf"\bint {fn}\(([^)]*)\)\s*{{", src)
        assert decl, f"{fn} is not defined in {binding.name}.cu"
        assert len(decl.group(1).split(",")) == len(argtypes), fn
