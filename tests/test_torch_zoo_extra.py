"""The zoo's ResNet and MobileNetV2 families in the port against the
reference on the CPU: PoseResNet 18 and 50, PoseFaceResNet 18, the
MobileNetV2-DReLU face net, CenterMobilenet, MobileHead, the denseReg
(dense and pooled), eyeBranch and mutiScale variants, PoseMobilenet,
FaceMobilenet-Deconv and FaceMobilenet-Old.

Each seeded port net's state dict goes through the reference's
``*_from_torch`` and back through the port's ``*_state_dict_from_jax`` bit
for bit; the port's forward on those weights matches the reference's jitted
apply on the same numpy-seeded inputs at rtol 1e-4 / atol 1e-5 (float32),
the raw regressions at atol 1e-5 times their largest magnitude. Shapes and
variants are the reference's parity matrix (tests/test_zoo.py): 64x64
inputs (CenterMobilenet 128x128, MobileHead a 96-channel 8x8 map)."""

import functools

import numpy as np
import pytest
import torch

from dfanerf_torch.models.perception import zoo_extra as pz
from dfanerf_tpu.models.perception import zoo_extra as jz
from torch_zoo_parity import (  # noqa: F401  (one_thread is the module's fixture)
    Case, build, check_forward, check_round_trip, one_thread,
)

P = functools.partial
REG = ("regress", "s4_regress", "")

CASES = {
    "pose_resnet18": Case(P(pz.PoseResNet, 18), P(jz.pose_resnet_from_torch, depth=18),
                          pz.pose_resnet_state_dict_from_jax, P(jz.apply_pose_resnet, depth=18),
                          (1, 64, 64, 3)),
    "pose_resnet50": Case(P(pz.PoseResNet, 50), P(jz.pose_resnet_from_torch, depth=50),
                          pz.pose_resnet_state_dict_from_jax, P(jz.apply_pose_resnet, depth=50),
                          (1, 64, 64, 3)),
    "pose_face_resnet18": Case(P(pz.PoseFaceResNet, 18),
                               P(jz.pose_face_resnet_from_torch, depth=18),
                               pz.pose_resnet_state_dict_from_jax,
                               P(jz.apply_pose_face_resnet, depth=18), (1, 64, 64, 3)),
    "face_mobilenet_drelu": Case(pz.FaceMobilenetDReLU, jz.face_mobilenet_drelu_from_torch,
                                 pz.face_mobilenet_drelu_state_dict_from_jax,
                                 jz.apply_face_mobilenet_drelu, (2, 64, 64, 3), REG),
    "center_mobilenet": Case(pz.CenterMobilenet, jz.center_mobilenet_from_torch,
                             pz.center_mobilenet_state_dict_from_jax, jz.apply_center_mobilenet,
                             (1, 128, 128, 3)),
    "mobile_head": Case(P(pz.MobileHead, 96, 68), jz.mobile_head_from_torch,
                        pz.mobile_head_state_dict_from_jax, jz.apply_mobile_head, (1, 8, 8, 96)),
    "densereg_dense": Case(P(pz.FaceMobilenetDenseReg, dense=True),
                           jz.face_mobilenet_densereg_from_torch,
                           pz.face_mobilenet_densereg_state_dict_from_jax,
                           P(jz.apply_face_mobilenet_densereg, dense=True), (2, 64, 64, 3), REG),
    "densereg_pooled": Case(P(pz.FaceMobilenetDenseReg, dense=False),
                            jz.face_mobilenet_densereg_from_torch,
                            pz.face_mobilenet_densereg_state_dict_from_jax,
                            P(jz.apply_face_mobilenet_densereg, dense=False), (2, 64, 64, 3),
                            REG),
    "eyeBranch": Case(P(pz.FaceMobilenetStaged, "eyeBranch"),
                      jz.face_mobilenet_staged_from_torch,
                      pz.face_mobilenet_staged_state_dict_from_jax,
                      jz.apply_face_mobilenet_eyebranch, (2, 64, 64, 3), REG),
    "mutiScale": Case(P(pz.FaceMobilenetStaged, "mutiScale"),
                      jz.face_mobilenet_staged_from_torch,
                      pz.face_mobilenet_staged_state_dict_from_jax,
                      jz.apply_face_mobilenet_mutiscale, (2, 64, 64, 3), REG),
    "pose_mobilenet": Case(pz.PoseMobilenet, jz.pose_mobilenet_from_torch,
                           pz.pose_mobilenet_state_dict_from_jax, jz.apply_pose_mobilenet,
                           (2, 64, 64, 3), REG),
    "face_mobilenet_deconv": Case(pz.FaceMobilenetDeconv, jz.face_mobilenet_deconv_from_torch,
                                  pz.face_mobilenet_deconv_state_dict_from_jax,
                                  jz.apply_face_mobilenet_deconv, (2, 64, 64, 3), REG),
    "face_mobilenet_old": Case(pz.FaceMobilenetOld, jz.face_mobilenet_old_from_torch,
                               pz.face_mobilenet_old_state_dict_from_jax,
                               jz.apply_face_mobilenet_old, (2, 64, 64, 3), REG),
}


@pytest.fixture(scope="module")
def nets():
    return build(CASES, 60)


@pytest.mark.parametrize("name", list(CASES))
def test_state_dict_round_trip(nets, name):
    check_round_trip(CASES[name], nets[name])


@pytest.mark.parametrize("name", list(CASES))
def test_forward(nets, name):
    check_forward(CASES[name], nets[name])


@torch.no_grad()
def test_drelu_matches_reference():
    """DReLU alone on a map whose pooled FC moves both pieces: the
    reshape to (b, 2, c, k), the frozen init_param_* and the max over k."""
    net = pz.DReLU(32)
    g = torch.Generator().manual_seed(1)
    for p in net.fc.parameters():
        p.copy_(torch.randn(p.shape, generator=g))
    x = np.random.RandomState(2).randn(3, 5, 6, 32).astype(np.float32)
    tree = jz.drelu_from_torch({f"d.{k}": v for k, v in net.state_dict().items()}, "d")
    want = np.asarray(jz.apply_drelu(tree, x))
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(want, np.maximum(x, 0))  # not a plain ReLU on these weights
