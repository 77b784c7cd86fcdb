"""The last odds and ends of the port against the reference on the CPU:
core/compositing.py apply_background_concat (the reference's
``--concate_bg``) for the head-only and the head+torso stacks, bit for bit,
and pipeline/steps.py compose_head_neck_image on a parsing map holding
every class, equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_torch.core.compositing import apply_background_concat
from dfanerf_torch.pipeline.steps import compose_head_neck_image
from dfanerf_tpu.core import compositing as jc
from dfanerf_tpu.pipeline import steps as js


@pytest.mark.parametrize("with_torso", [False, True])
def test_apply_background_concat_matches_reference(with_torso):
    rng = np.random.RandomState(11)
    R, S = 37, 16
    feat = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    sig_h = np.maximum(rng.randn(R, S), 0).astype(np.float32)
    sig_h[:5] = 0.0  # rays whose head density is zero everywhere
    bc = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    sig_t = np.maximum(rng.randn(R, S), 0).astype(np.float32) if with_torso else None
    want = jc.apply_background_concat(*(None if a is None else jnp.asarray(a)
                                        for a in (feat, sig_h, bc, sig_t)))
    got = apply_background_concat(*(None if a is None else torch.from_numpy(a)
                                    for a in (feat, sig_h, bc, sig_t)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(got[0][:, -1], torch.from_numpy(bc))  # the background at the last sample
    assert (got[1][:, -1] > 0).all()  # the head-only stack reaches it
    if with_torso:
        assert torch.equal(got[2], torch.from_numpy(sig_h))
        assert torch.allclose(got[3][:, -1], torch.full((R,), 1e-6))


def test_compose_head_neck_image_matches_reference():
    rng = np.random.RandomState(12)
    h, w = 24, 32
    classes = np.array([(255, 0, 0), (0, 255, 0), (255, 255, 255), (0, 0, 255), (10, 20, 30)],
                       np.uint8)
    parsing = classes[rng.randint(0, len(classes), (h, w))]
    ori = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    bc = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    got = compose_head_neck_image(ori, parsing, bc)
    want = js.compose_head_neck_image(ori, parsing, bc)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    keep = (parsing == classes[0]).all(-1) | (parsing == classes[1]).all(-1)
    np.testing.assert_array_equal(got[keep], ori[keep])
    np.testing.assert_array_equal(got[~keep], bc[~keep])
