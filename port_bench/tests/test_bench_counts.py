"""The frozen FLOP and byte counts equal the program's at the published widths
(dfanerf_torch/ops/fused_render.py, ops/_build.py and chip_smoke.py's byte
models), so the yardstick starts where the program's own arithmetic is."""

import json

import pytest
import torch

import chip_smoke
from conftest import ROOT
from dfanerf_torch.models.decoder import Decoder, DecoderConfig
from dfanerf_torch.ops import fused_render
from dfanerf_torch.ops._build import weight_blobs
from dfanerf_torch.ops.pack import pack_field_weights
from port_bench import counts

MODEL = json.loads((ROOT / "port_bench" / "configs" / "dfa_head_torso.json").read_text())


@pytest.fixture(scope="module")
def packs():
    dec = MODEL["decoder"]
    decoder = Decoder(DecoderConfig(**dict(dec, skips=tuple(dec["skips"]))))
    z = torch.randn(256)
    return {b: pack_field_weights(decoder, torch.randn(96 if b == "head" else 42), z, z, b)
            for b in ("head", "torso")}


@pytest.mark.parametrize("branch", ["head", "torso"])
@pytest.mark.parametrize("sigma,color", [(True, True), (True, False), (False, True)])
def test_field_flops(branch, sigma, color):
    assert (counts.field_flops_per_sample(branch, sigma, color)
            == fused_render.field_flops_per_sample(branch, sigma, color))


@pytest.mark.parametrize("fields", ["both", "head", "torso"])
def test_render_flops(fields):
    assert counts.render_flops_per_sample(fields) == fused_render.render_flops_per_sample(fields)


@pytest.mark.parametrize("branch", ["head", "torso"])
def test_pair_bytes_and_blobs(packs, branch):
    w, b = weight_blobs(packs[branch], branch)
    assert counts.blob_sizes(branch) == (w.numel(), b.numel())
    for k_u, K, sp in ((1, 1, 8), (37, 200, 8), (841, 6728, 8), (512, 3000, 4)):
        assert counts.pair_bytes(k_u, K, sp, branch) == chip_smoke._pair_bytes(k_u, K, sp, (w, b))


@pytest.mark.parametrize("fields", ["both", "head", "torso"])
def test_render_rays_bytes(packs, fields):
    n = 3 * 256
    rays = [torch.randn(n, 3) for _ in range(4)]
    z = torch.linspace(0.3, 0.9, 64)
    ops = fused_render.prepare_render_operands(packs["head"], packs["torso"], *rays, z,
                                               torch.rand(n, 3), fields=fields)
    assert counts.render_rays_bytes(3, fields) == chip_smoke._render_rays_bytes(ops, fields)


def test_peaks():
    assert counts.PEAK_BF16_FLOPS == chip_smoke.PEAK_BF16_FLOPS
    assert counts.PEAK_HBM_BYTES == chip_smoke.PEAK_BYTES
    assert counts.roofline_pct(0, 0, 1.0) is None
    assert counts.roofline_pct(counts.PEAK_BF16_FLOPS, 0, 1.0) == pytest.approx(100.0)
