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
                              "render_head", "pair_hier", "pair_perz", "node_grid")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()


# The libraries of the wgmma core, over the shared layout header: every one.
WGMMA = ("render_rays", "pair_field", "render_head", "pair_perz", "sigma_head", "pair_hier",
         "far_eval", "node_grid")
HEADERS = {name: ["field_wgmma.cuh", "field_common.cuh"] for name in WGMMA}


@pytest.mark.parametrize("name,header", [(n, h) for n in _build.SOURCES for h in HEADERS[n]])
def test_digest_covers_the_included_header(tmp_path, name, header):
    """A library's digest follows every csrc header its source includes,
    directly or through another header."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert [h.name for h in _build.local_includes(csrc / f"{name}.cu")] == HEADERS[name]
    same = _build.library_path(name, csrc)
    assert same == _build.library_path(name)
    path = csrc / header
    text = path.read_text()
    assert "constexpr int M = 128;" in text or header != "field_common.cuh"
    path.write_text(text.replace("constexpr int M = 128;", "constexpr int M = 64;")
                    if header == "field_common.cuh" else text + "\n// edited\n")
    edited = _build.library_path(name, csrc)
    assert edited != same and edited.parent == same.parent


def test_wgmma_kernels_have_no_path_to_the_mma_sync_core():
    """Every source includes the wgmma core; the mma.sync core
    (field_mlp.cuh), whose last user was far_eval, is gone, and no source or
    header names it."""
    assert set(WGMMA) == set(_build.SOURCES)
    assert not (_build.CSRC / "field_mlp.cuh").exists()
    for name in _build.SOURCES:
        includes = [h.name for h in _build.local_includes(_build.CSRC / f"{name}.cu")]
        assert "field_wgmma.cuh" in includes and "field_mlp.cuh" not in includes
    for path in sorted(_build.CSRC.iterdir()):
        assert "field_mlp" not in path.read_text(), path.name


def test_flags_target_sm90a_without_fma_contraction():
    """wgmma needs the sm_90a target; the numerics contract needs
    --fmad=false (csrc/render_rays.cu note); -v reports ptxas lines."""
    flags = _build.NVCC_FLAGS
    assert flags[flags.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "--fmad=false" in flags and "--use_fast_math" not in flags
    assert flags[flags.index("-Xptxas") + 1] == "-v"


def _bindings():
    from dfanerf_torch.ops import far_eval, fused_render, occupancy, pair_field, pair_hier
    from dfanerf_torch.ops import render_head, sigma_head

    return [fused_render.render_rays_kernel, pair_field.pair_field_kernel,
            pair_field.pair2_field_kernel, far_eval.far_head_kernel, far_eval.far_torso_kernel,
            far_eval.far_joint_kernel,
            sigma_head.sigma_head_kernel, render_head.render_head_kernel,
            pair_hier.pair_sigma_kernel, pair_hier.pair_field_perz_kernel,
            occupancy.node_grid_kernel]


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


def test_launch_counts_from_two_threads(monkeypatch):
    """A serving thread and a refresh worker launching one kernel at once:
    the library is loaded once, every launch is counted once, and the
    worker's launches (inside worker_launches()) count in worker_launches,
    apart from the served frames' launches and variants.
    The launch itself is a stand-in: nothing is built or run."""
    import contextlib
    import sys
    import threading
    import time
    from types import SimpleNamespace

    import torch

    loads = []

    class Library:
        def demo_launch(self, *args):
            return 0

    def load(path, name, launchers):
        loads.append(name)
        time.sleep(0.05)  # both threads reach the first use together
        return Library(), (0,) * _build.LAYOUT_SIZES

    binding = _build.Binding("pair_field", {"demo_launch": ()})
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(binding, "_library", lambda: None)
    monkeypatch.setattr(_build.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build.torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    n, dev = 3000, torch.device("cpu")
    start = threading.Barrier(2)

    def serve():
        start.wait()
        for _ in range(n):
            binding.launch("demo_launch", dev, variant="sp8")

    def work():
        start.wait()
        with _build.worker_launches():
            for _ in range(n):
                binding.launch("demo_launch", dev, variant="sp8")
        binding.launch("demo_launch", dev)  # out of the block: a served launch

    threads = [threading.Thread(target=serve), threading.Thread(target=work)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert loads == ["pair_field"]
    assert binding.launches == n + 1 and binding.variant_launches == {"sp8": n}
    assert binding.worker_launches == n
