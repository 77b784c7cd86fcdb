"""RAFT-basic and the ImportanceWeights head in the port against the
reference on the CPU, and the pieces RAFT-basic adds to RAFT-small.

RAFT-basic's seeded state dict goes through the reference's
``raft_basic_from_torch`` and back through the port's
``raft_basic_state_dict_from_jax`` bit for bit; its flow (in pixels, held at
atol 1e-5 times its largest magnitude, as tests/test_torch_perception.py
holds RAFT-small's) and its last FlowHead feature (rtol 1e-4 / atol 1e-5)
match the reference's jitted apply at 2 and 3 iterations on 64x64 images
(the pyramid's last level one pixel), and with the alternate correlation
at 2. ``upsample_flow_convex`` and ``lookup_corr_alternate`` are held alone:
the latter against the reference's and, in the port, against the pyramid's
``lookup_corr`` (float32 summation order apart: atol 1e-5 times the
correlation's scale). ImportanceWeights takes the reference's
``init_importance_weights`` tree (the reference has no converter)."""

import functools

import jax
import numpy as np
import pytest
import torch

from dfanerf_torch.models.perception import raft as prf
from dfanerf_tpu.models.perception import raft as jrf
from torch_zoo_parity import (  # noqa: F401  (one_thread is the module's fixture)
    Case, build, check_round_trip, nchw, one_thread,
)

P = functools.partial


def _images(name, shape):
    """Two 0..255 images, the second the first shifted by (1, 2) plus noise."""
    rng = np.random.RandomState(sum(map(ord, name)))
    base = rng.uniform(0, 255, shape[1:]).astype(np.float32)
    moved = np.roll(base, (1, 2), axis=(1, 2)) + rng.uniform(-5, 5, shape[1:]).astype(np.float32)
    return np.stack([base, moved])


def _raft_case(iters, alternate=False):
    return Case(prf.RAFTBasic, jrf.raft_basic_from_torch, prf.raft_basic_state_dict_from_jax,
                lambda p, x: jrf.apply_raft_basic(p, x[0], x[1], iters, alternate),
                (2, 1, 64, 64, 3))


CASES = {"raft_basic_2": _raft_case(2), "raft_basic_3": _raft_case(3),
         "raft_basic_2_alternate": _raft_case(2, True)}
ITERS = {"raft_basic_2": (2, False), "raft_basic_3": (3, False),
         "raft_basic_2_alternate": (2, True)}


@pytest.fixture(scope="module")
def nets():
    return build(CASES, 90, _images)


@pytest.mark.parametrize("name", ["raft_basic_2"])
def test_state_dict_round_trip(nets, name):
    check_round_trip(CASES[name], nets[name])


@pytest.mark.parametrize("name", list(CASES))
@torch.no_grad()
def test_raft_basic_forward(nets, name):
    s = nets[name]
    net = prf.RAFTBasic()
    net.load_state_dict(prf.raft_basic_state_dict_from_jax(s["tree"]))
    iters, alternate = ITERS[name]
    flow, feat = net.eval()(nchw(s["x"][0]), nchw(s["x"][1]), iters, alternate)
    assert tuple(flow.shape) == (1, 2, 64, 64) and tuple(feat.shape) == (1, 256, 8, 8)
    want_flow, want_feat = s["ref"]
    np.testing.assert_allclose(flow.permute(0, 2, 3, 1).numpy(), want_flow, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want_flow).max()))
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(), want_feat, rtol=1e-4, atol=1e-5)


def test_upsample_flow_convex_matches_reference():
    rng = np.random.RandomState(4)
    flow = rng.randn(2, 3, 5, 2).astype(np.float32) * 3
    mask = rng.randn(2, 3, 5, 576).astype(np.float32) * 2
    want = np.asarray(jrf.upsample_flow_convex(flow, mask))
    got = prf.upsample_flow_convex(nchw(flow), nchw(mask)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 24, 40, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def corr_inputs():
    rng = np.random.RandomState(5)
    f1 = rng.randn(2, 8, 12, 32).astype(np.float32)
    f2 = rng.randn(2, 8, 12, 32).astype(np.float32)
    coords = (np.asarray(jrf.coords_grid(2, 8, 12))
              + rng.uniform(-3, 3, (2, 8, 12, 2)).astype(np.float32))
    return f1, f2, coords


def test_lookup_corr_alternate_matches_reference(corr_inputs):
    f1, f2, coords = corr_inputs
    want = np.asarray(jax.jit(jrf.lookup_corr_alternate)(f1, f2, coords))
    got = prf.lookup_corr_alternate(nchw(f1), nchw(f2), nchw(coords)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 8, 12, 4 * 81)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_lookup_corr_alternate_equals_pyramid_lookup(corr_inputs):
    """The alternate correlation against build_corr_pyramid + lookup_corr
    in the port: the same values up to float32 summation order."""
    f1, f2, coords = (nchw(x) for x in corr_inputs)
    alt = prf.lookup_corr_alternate(f1, f2, coords)
    pyr = prf.lookup_corr(prf.build_corr_pyramid(f1, f2), coords, radius=prf.BASIC_RADIUS)
    scale = float(pyr.abs().max())
    np.testing.assert_allclose(alt.numpy(), pyr.numpy(), rtol=1e-4, atol=1e-5 * scale)


@torch.no_grad()
def test_importance_weights_from_reference_init():
    tree = jax.tree.map(np.asarray, jax.jit(jrf.init_importance_weights)(jax.random.PRNGKey(7)))
    rng = np.random.RandomState(6)
    images6 = rng.uniform(0, 1, (2, 16, 24, 6)).astype(np.float32)
    feature = rng.randn(2, 16, 24, 128).astype(np.float32)
    want = np.asarray(jax.jit(jrf.apply_importance_weights)(tree, images6, feature))
    net = prf.ImportanceWeights()
    net.load_state_dict(prf.importance_weights_state_dict_from_jax(tree))
    got = net.eval()(nchw(images6), nchw(feature)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 16, 24, 1) and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
