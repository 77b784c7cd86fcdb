"""The zoo's backbones in the port against the reference on the CPU:
MobileNetV2 with its heatmap head and its GhostBottleneck head, ShuffleNetV2,
U^2-Net (full, small, and an odd input size) and the face GhostNet (plain,
and with extra encoder and decoder layers).

Each seeded port net's state dict goes through the reference's
``*_from_torch`` and back through the port's ``*_state_dict_from_jax`` bit
for bit; the port's forward on those weights matches the reference's jitted
apply on the same numpy-seeded inputs at rtol 1e-4 / atol 1e-5 (float32).
The heatmap head has an init and no converter in the reference: its tree
comes from the reference's init. Shapes and variants are the reference's
parity matrix (tests/test_zoo.py), at 64x64 inputs (50x38 for the odd
case, whose ceil-mode pools make U^2-Net's upsamplings non-integer: 13 ->
25, 7 -> 13, 4 -> 7 rows)."""

import functools

import jax
import numpy as np
import pytest
import torch

from dfanerf_torch.models.perception import ghostnet_face as pgf
from dfanerf_torch.models.perception import mobilenet as pmb
from dfanerf_torch.models.perception import shufflenet as psh
from dfanerf_torch.models.perception import u2net as pu2
from dfanerf_torch.models.perception.common import resize_linear, seeded_init_
from dfanerf_tpu.models.perception import ghostnet_face as jgf
from dfanerf_tpu.models.perception import mobilenet as jmb
from dfanerf_tpu.models.perception import shufflenet as jsh
from dfanerf_tpu.models.perception import u2net as ju2
from torch_zoo_parity import (  # noqa: F401  (one_thread is the module's fixture)
    Case, build, check_forward, check_round_trip, nchw, one_thread,
)

GHOST_SPEC = pmb.DEFAULT_GHOSTHEAD_SPEC
P = functools.partial

CASES = {
    "mobilenet_v2": Case(pmb.MobileNetV2, jmb.mobilenet_v2_from_torch,
                         pmb.mobilenet_v2_state_dict_from_jax, jmb.apply_mobilenet_v2,
                         (2, 64, 64, 3)),
    "face_mobilenet_heatmap": Case(
        pmb.FaceMobilenetHeatmap, None, pmb.face_mobilenet_heatmap_state_dict_from_jax,
        jmb.apply_face_mobilenet_heatmap, (1, 64, 64, 3),
        init=jmb.init_face_mobilenet_heatmap),
    "face_mobilenet_ghosthead": Case(
        pmb.FaceMobilenetGhostHead, P(jmb.face_mobilenet_ghosthead_from_torch, spec=GHOST_SPEC),
        pmb.face_mobilenet_ghosthead_state_dict_from_jax,
        P(jmb.apply_face_mobilenet_ghosthead, spec=GHOST_SPEC), (1, 64, 64, 3)),
    "shufflenet_x1.0": Case(psh.ShuffleNetV2, jsh.shufflenet_v2_from_torch,
                            psh.shufflenet_v2_state_dict_from_jax, jsh.apply_shufflenet_v2,
                            (2, 64, 64, 3)),
    "shufflenet_x0.5": Case(P(psh.ShuffleNetV2, "x0.5"),
                            P(jsh.shufflenet_v2_from_torch, preset="x0.5"),
                            psh.shufflenet_v2_state_dict_from_jax,
                            P(jsh.apply_shufflenet_v2, preset="x0.5"), (2, 64, 64, 3)),
    "u2net": Case(P(pu2.U2Net, 5), P(ju2.u2net_from_torch, out_ch=5),
                  pu2.u2net_state_dict_from_jax, ju2.apply_u2net, (1, 64, 64, 3)),
    "u2net_small": Case(P(pu2.U2Net, 5, True), P(ju2.u2net_from_torch, out_ch=5, small=True),
                        pu2.u2net_state_dict_from_jax, P(ju2.apply_u2net, small=True),
                        (1, 64, 64, 3)),
    "u2net_small_odd": Case(P(pu2.U2Net, 2, True), P(ju2.u2net_from_torch, out_ch=2, small=True),
                            pu2.u2net_state_dict_from_jax, P(ju2.apply_u2net, small=True),
                            (1, 50, 38, 3)),
    "face_ghostnet": Case(pgf.FaceGhostNet, jgf.face_ghostnet_from_torch,
                          pgf.face_ghostnet_state_dict_from_jax, jgf.apply_face_ghostnet,
                          (1, 64, 64, 3)),
    "face_ghostnet_add": Case(
        P(pgf.FaceGhostNet, 68, 2, True),
        P(jgf.face_ghostnet_from_torch, addition_encoder=2, addition_decoder=True),
        pgf.face_ghostnet_state_dict_from_jax,
        P(jgf.apply_face_ghostnet, addition_encoder=2, addition_decoder=True), (1, 64, 64, 3)),
}


@pytest.fixture(scope="module")
def nets():
    return build(CASES, 40)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.to_jax is not None])
def test_state_dict_round_trip(nets, name):
    check_round_trip(CASES[name], nets[name])


@pytest.mark.parametrize("name", list(CASES))
def test_forward(nets, name):
    check_forward(CASES[name], nets[name])


@pytest.mark.parametrize("preset", list(psh.PRESETS))
def test_shufflenet_presets_round_trip(preset):
    """Every preset's module tree is the reference's: its state dict goes
    through the reference's converter and back bit for bit."""
    net = seeded_init_(psh.ShuffleNetV2(preset), 3)
    sd = net.state_dict()
    back = psh.shufflenet_v2_state_dict_from_jax(
        jax.tree.map(np.asarray, jsh.shufflenet_v2_from_torch(sd, preset)))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_channel_shuffle_matches_reference():
    x = np.random.RandomState(0).randn(2, 3, 5, 12).astype(np.float32)
    want = np.asarray(jsh.channel_shuffle(x, 2))
    got = psh.channel_shuffle(nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,out_hw", [((13, 4), (25, 7)), ((7, 5), (13, 10)), ((4, 3), (7, 5))])
def test_resize_linear_non_integer_ratio(hw, out_hw):
    """The upsampling U^2-Net makes at odd sizes: jax.image.resize 'linear'
    and the port's resize_linear at ratios like 13 -> 25."""
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *out_hw, 3), "linear"))
    got = resize_linear(nchw(x), out_hw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_u2net_odd_size_pools_round_up(nets):
    """ceil-mode pooling at 50x38: every output at the input's size."""
    s = nets["u2net_small_odd"]
    assert [tuple(o.shape) for o in s["ref"]] == [(1, 50, 38, 2)] * 6
