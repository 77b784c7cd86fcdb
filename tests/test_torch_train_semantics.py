"""The port's train step on its own (no reference compilation), on the
CPU: the semantics tests/test_train.py checks for the reference package.
A 24x24 synthetic scene with ground truth from the port's own
make_synthetic_dataset, the port's seeded init, a decoder of 4 blocks, 64
wide."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig, TrainConfig
from dfanerf_torch.data.synthetic import make_synthetic_dataset
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.train.state import OPT_GROUPS, init_train_state
from dfanerf_torch.train.step import (
    dataset_to_device, make_train_step, pixel_coords_from_scores, sample_pixel_coords,
)

DEC = DecoderConfig(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)


def _cfg(**train):
    return ExperimentConfig(decoder=DEC, render=RenderConfig(n_samples=16),
                            train=TrainConfig(n_rand=256, z_dim=32, **train),
                            signal=SignalConfig(nosmo_iters=2, noexp_iters=3))


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_dataset(n_frames=8, H=24, W=24, n_samples_gt=16, device="cpu")
    cfg = _cfg()
    state = init_train_state(cfg, seed=0, device="cpu")
    return cfg, ds, state, dataset_to_device(ds, "cpu")


def _params(state):
    return {k: v.detach().clone() for k, v in state["params"].state_dict().items()}


def _group_delta(before, after, group):
    return max(float((after[k] - v).abs().max()) for k, v in before.items()
               if k.startswith(group + "."))


def test_loss_decreases(setup):
    cfg, ds, state, data = setup
    step = make_train_step(cfg, ds, device="cpu")
    st = copy.deepcopy(state)
    g = torch.Generator().manual_seed(1)
    losses = [float(step(st, data, g)[1]["loss"]) for _ in range(100)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.6 * np.mean(losses[:10]), (losses[:10], losses[-10:])
    assert st["step"] == 100


def test_grad_clip(setup):
    """A clip that never fires is bit-equal to none; the metrics report the
    norm before clipping; a tiny clip shrinks the update."""
    _, ds, state, data = setup
    batch = make_train_step(_cfg(), ds, device="cpu").draw_batch(torch.Generator().manual_seed(7))
    before = _params(state)
    out = {}
    for clip in (0.0, 1e9, 1e-4):
        cfg = _cfg(grad_clip=clip)
        st, m = make_train_step(cfg, ds, device="cpu").step_on_batch(copy.deepcopy(state), data,
                                                                      batch)
        out[clip] = (_params(st), m)
    for k, v in out[0.0][0].items():
        assert torch.equal(v, out[1e9][0][k]), k
    assert float(out[1e-4][1]["grad_norm"]) == float(out[0.0][1]["grad_norm"]) > 1e-4

    def update(p):
        return sum(float((p[k] - v).square().sum()) for k, v in before.items()) ** 0.5

    assert update(out[1e-4][0]) < 0.5 * update(out[0.0][0])


def test_staged_gating(setup):
    """Before nosmo_iters / noexp_iters the attention and expression nets,
    their moments and their step counts stay put while the decoder and the
    audio net move; past the gates they move too."""
    cfg, ds, state, data = setup
    step = make_train_step(cfg, ds, device="cpu")
    st = copy.deepcopy(state)
    g = torch.Generator().manual_seed(2)
    before = _params(st)
    for _ in range(2):  # steps 0 and 1: only the 'always' groups
        st, _ = step(st, data, g)
    after = _params(st)
    for group in ("audattnet", "poseattnet", "expnet"):
        assert _group_delta(before, after, group) == 0.0, group
        assert st["opt"][group]["t"] == 0
        assert all(float(m.abs().max()) == 0.0 for m in st["opt"][group]["m"].values())
    for group in ("decoder", "audnet"):
        assert _group_delta(before, after, group) > 0.0 and st["opt"][group]["t"] == 2
    st, _ = step(st, data, g)  # step 2: smoothing on, expression still off
    late = _params(st)
    assert _group_delta(after, late, "audattnet") > 0.0 and st["opt"]["audattnet"]["t"] == 1
    assert _group_delta(after, late, "poseattnet") > 0.0
    assert _group_delta(after, late, "expnet") == 0.0 and st["opt"]["expnet"]["t"] == 0
    st, _ = step(st, data, g)  # step 3: every group
    assert _group_delta(late, _params(st), "expnet") > 0.0
    assert [st["opt"][n]["t"] for n, _, _ in OPT_GROUPS] == [4, 4, 1, 2, 2]


def test_z_latents_never_move(setup):
    cfg, ds, state, data = setup
    st = copy.deepcopy(state)
    make_train_step(cfg, ds, device="cpu")(st, data, torch.Generator().manual_seed(3))
    assert torch.equal(st["z_shape"], state["z_shape"])
    assert torch.equal(st["z_app"], state["z_app"])


def test_draws_are_seeded(setup):
    cfg, ds, _, _ = setup
    step = make_train_step(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, perturb=True)), ds, device="cpu")
    a, b = (step.draw_batch(torch.Generator().manual_seed(5)) for _ in range(2))
    assert a["img_i"] == b["img_i"] and a["img_i"] in ds.i_train
    assert torch.equal(a["coords"], b["coords"]) and torch.equal(a["z_vals"], b["z_vals"])
    z = a["z_vals"]
    assert z.shape == (256, 16) and bool((z[:, 1:] > z[:, :-1]).all())
    assert float(z.min()) >= ds.near and float(z.max()) <= ds.far


def test_uniform_sampler_without_replacement():
    coords = sample_pixel_coords(torch.Generator().manual_seed(0), 32, 32, 256, 0.0, None)
    flat = (coords[:, 0] * 32 + coords[:, 1]).numpy()
    assert coords.shape == (256, 2) and len(np.unique(flat)) == 256
    assert int(coords.min()) >= 0 and int(coords.max()) < 32


def test_rect_biased_sampler():
    """sample_rate of the pixels from inside the rect (rows 8..24, cols 8..24)
    or the lower half, the rest from outside, each part without repeats."""
    H = W = 64
    coords = sample_pixel_coords(torch.Generator().manual_seed(1), H, W, 512, 0.95,
                                 np.array([8, 8, 16, 16], np.int32)).numpy()
    ys, xs = coords[:, 0], coords[:, 1]
    inside = ((ys >= 8) & (ys <= 24) & (xs >= 8) & (xs <= 24)) | (ys >= H // 2)
    n_in = int(512 * 0.95)
    assert inside[:n_in].all() and not inside[n_in:].any()
    assert len(np.unique(ys * W + xs)) == 512
    # the transform picks the largest scores
    u = torch.rand(H * W, generator=torch.Generator().manual_seed(2))
    top = pixel_coords_from_scores(u, H, W, 10, 0.0, None)
    np.testing.assert_array_equal((top[:, 0] * W + top[:, 1]).numpy(),
                                  torch.argsort(u, descending=True)[:10].numpy())

