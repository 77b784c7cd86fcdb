"""The zoo's multi-branch and eye families in the port against the reference
on the CPU: the FAN stacked hourglass (1 and 2 modules, CoordConv), Mobile
HRNet, the general eye encoder-decoder (RGB with brow channels; grayscale
with the gaussian-modulation conv; the half variant with extra encoder and
decoder layers) and the coordinate-regression eye GhostNets (plain and
full).

Each seeded port net's state dict goes through the reference's
``*_from_torch`` and back through the port's ``*_state_dict_from_jax`` bit
for bit; the port's forward on those weights matches the reference's jitted
apply on the same numpy-seeded inputs at rtol 1e-4 / atol 1e-5 (float32),
the eye regressions (raw coordinates) at atol 1e-5 times their largest
magnitude. So are FAN's and Mobile HRNet's heatmaps: on seeded weights
their residual and SUM-fuse chains carry them to |x| of 15 (FAN, one
module), 45 (two) and 310 (Mobile HRNet), where the two float32
summation orders part by 1.6e-5, 1.8e-4 and 5.3e-4 (1e-6 to 2e-6 of the
scale; ROADMAP.md queue 3). Shapes and variants are the reference's parity matrix
(tests/test_zoo.py): FAN at 256x256 (the reference's CoordConv is sized for
it), Mobile HRNet at 64x64, the eye nets at 48x32."""

import functools

import numpy as np
import pytest
import torch

from dfanerf_torch.models.perception import zoo_extra as pz
from dfanerf_tpu.models.perception import zoo_extra as jz
from torch_zoo_parity import (  # noqa: F401  (one_thread is the module's fixture)
    Case, build, check_forward, check_round_trip, nchw, one_thread,
)

P = functools.partial
ENC, DEC = jz.eye_net_sets()
ENC_H, DEC_H = jz.eye_net_sets(2, True)


def _eye_case(shape, port, sigma=0.0, sets=(ENC, DEC)):
    return Case(P(pz.EyeNetGeneral, **port), P(jz.eye_net_general_from_torch,
                                               encoder_sets=sets[0], decoder_sets=sets[1]),
                pz.eye_net_general_state_dict_from_jax,
                P(jz.apply_eye_net_general, encoder_sets=sets[0], decoder_sets=sets[1],
                  num_joints=6, gaussian_sigma=sigma), shape)


CASES = {
    "fan1": Case(P(pz.FAN, 1), P(jz.fan_from_torch, num_modules=1), pz.fan_state_dict_from_jax,
                 P(jz.apply_fan, num_modules=1), (1, 256, 256, 3), ("",)),
    "fan2": Case(P(pz.FAN, 2), P(jz.fan_from_torch, num_modules=2), pz.fan_state_dict_from_jax,
                 P(jz.apply_fan, num_modules=2), (1, 256, 256, 3), ("",)),
    "mobile_hrnet": Case(pz.MobileHRNet, jz.mobile_hrnet_from_torch,
                         pz.mobile_hrnet_state_dict_from_jax, jz.apply_mobile_hrnet,
                         (1, 64, 64, 3), ("",)),
    "eye_rgb_brow": _eye_case((1, 32, 48, 3), dict(rgb=True, brow=True)),
    "eye_gray_dm2": _eye_case((1, 32, 48, 1), dict(gaussian_sigma=2.0), sigma=2.0),
    "eye_half_add": _eye_case((1, 32, 48, 3), dict(rgb=True, addition_encoder=2,
                                                   addition_decoder=True), sets=(ENC_H, DEC_H)),
    "eye_ghostnet": Case(pz.EyeGhostnetRegress, jz.eye_ghostnet_regress_from_torch,
                         pz.eye_ghostnet_regress_state_dict_from_jax,
                         jz.apply_eye_ghostnet_regress, (2, 32, 48, 1), ("",)),
    "eye_full_ghostnet": Case(
        P(pz.EyeGhostnetRegress, pz.EYE_FULL_GHOSTNET_SETS),
        P(jz.eye_ghostnet_regress_from_torch, sets=jz.EYE_FULL_GHOSTNET_SETS),
        pz.eye_ghostnet_regress_state_dict_from_jax,
        P(jz.apply_eye_ghostnet_regress, sets=jz.EYE_FULL_GHOSTNET_SETS), (2, 32, 48, 1), ("",)),
}


@pytest.fixture(scope="module")
def nets():
    return build(CASES, 80)


@pytest.mark.parametrize("name", list(CASES))
def test_state_dict_round_trip(nets, name):
    check_round_trip(CASES[name], nets[name])


@pytest.mark.parametrize("name", list(CASES))
def test_forward(nets, name):
    check_forward(CASES[name], nets[name])


@pytest.mark.parametrize("with_heatmap", [False, True])
def test_add_coords_matches_reference(with_heatmap):
    """FAN's coordinate channels: xx along H, yy along W, rr over its max;
    the boundary-masked pair from a heatmap's last channel."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 5, 4).astype(np.float32)
    hm = rng.uniform(-0.2, 0.3, (2, 7, 5, 3)).astype(np.float32) if with_heatmap else None
    want = np.asarray(jz._add_coords(x, hm, with_r=True, with_boundary=True))
    got = pz.add_coords(nchw(x), None if hm is None else nchw(hm), with_boundary=True)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_gaussian_kernel_matches_reference():
    want = np.asarray(jz.dm_kernel(6, 2.0)).transpose(3, 2, 0, 1)
    from dfanerf_torch.models.perception.ghostnet_face import gaussian_kernel

    np.testing.assert_allclose(gaussian_kernel(6, 2.0).numpy(), want, rtol=1e-6, atol=0)


def test_fan_boundaries(nets):
    """Each module's heatmaps (68 landmarks and the boundary channel) and
    its two boundary channels, in the reference and in the port."""
    outs, bnds = nets["fan2"]["ref"]
    assert [o.shape for o in outs] == [(1, 64, 64, 69)] * 2
    assert [b.shape for b in bnds] == [(1, 64, 64, 2)] * 2
    with torch.no_grad():
        got_outs, got_bnds = pz.FAN(2).eval()(torch.zeros(1, 3, 256, 256))
    assert [tuple(o.shape) for o in got_outs] == [(1, 69, 64, 64)] * 2
    assert [tuple(b.shape) for b in got_bnds] == [(1, 2, 64, 64)] * 2
