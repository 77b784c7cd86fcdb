"""The landmark tools in the port (pipeline/landmark_training.py,
landmark_eval.py, landmark_temporal.py, edge_map.py) on the CPU against
the reference package, on the same inputs: the reference's heatmaps are
[N, h, w, K], the port's [N, K, h, w], so arrays are transposed across.

Bars: targets, losses, NME, PCK and the temporal sequence within 1e-5;
the host numpy (NME dispatch, learning-rate schedule, benchmark report,
run log, edge maps) equal. Train steps are compared one at a time from the
reference's state (ROADMAP queue 3, "Adam's sign noise"): the heatmap step
on the eye net (converted weights), its loss and every trained tensor
within 1e-5 (measured: 3.7e-9 at most over its 87,764 entries); the
temporal step's loss and parameters within 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models.perception.ghostnet_eye import apply_eye_net, init_eye_net
from dfanerf_tpu.pipeline import landmark_eval as je
from dfanerf_tpu.pipeline import landmark_temporal as jt
from dfanerf_tpu.pipeline import landmark_training as jl
from dfanerf_torch.models.perception.ghostnet_eye import EyeNet, eye_net_state_dict_from_jax
from dfanerf_torch.pipeline import landmark_eval as te
from dfanerf_torch.pipeline import landmark_temporal as tt
from dfanerf_torch.pipeline import landmark_training as tl

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: small tensors, six suite workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, float(np.abs(ref).max())), rtol=0,
                               err_msg=what)


def test_targets_and_losses_match_reference():
    rng = np.random.RandomState(0)
    joints = rng.uniform(-3, 19, (3, 6, 2)).astype(np.float32)  # some outside the map
    t_t, w_t = tl.gaussian_targets(torch.from_numpy(joints), (16, 24), 1.5)
    t_j, w_j = jl.gaussian_targets(jnp.asarray(joints), (16, 24), 1.5)
    _close(t_t.numpy().transpose(0, 2, 3, 1), t_j, "targets")
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert 0 < float(w_t.mean()) < 1
    pred = rng.rand(3, 16, 24, 6).astype(np.float32)
    tgt = np.asarray(t_j)
    p_t, g_t, p_j, g_j = _nchw(pred), _nchw(tgt), jnp.asarray(pred), jnp.asarray(tgt)
    _close(float(tl.joints_mse_loss(p_t, g_t, w_t)), float(jl.joints_mse_loss(p_j, g_j, w_j)),
           "mse")
    _close(float(tl.wing_loss(p_t, g_t)), float(jl.wing_loss(p_j, g_j)), "wing")
    _close(float(tl.adaptive_wing_loss(p_t, g_t)), float(jl.adaptive_wing_loss(p_j, g_j)),
           "awing")


def test_host_tools_equal():
    rng = np.random.RandomState(1)
    for L in (19, 29, 68, 98, 10):
        p, g = rng.rand(4, L, 2) * 50, rng.rand(4, L, 2) * 50
        box = rng.rand(4) * 30 + 1
        np.testing.assert_array_equal(tl.compute_nme(p, g, box), jl.compute_nme(p, g, box))
        if L != 10:
            np.testing.assert_array_equal(te.compute_nme_benchmark(p, g, box),
                                          je.compute_nme_benchmark(p, g, box))
    for epoch in (0, 89, 90, 109, 110, 500):
        assert tl.multistep_lr(1e-3, epoch) == pytest.approx(float(jl.multistep_lr(1e-3, epoch)),
                                                             rel=1e-6)
    pred, gt = rng.rand(3, 6, 2) * 16, rng.rand(3, 6, 2) * 16
    gt[0, 2] = 0.5  # invalid
    for a, b in zip(te.pck_accuracy(pred, gt, (16, 16)), je.pck_accuracy(pred, gt, (16, 16))):
        np.testing.assert_array_equal(a, b)
    gt68 = rng.rand(10, 68, 2) * 100
    imgs = np.zeros((10, 8, 8, 3))
    imgs[:, 0, 0, 0] = np.arange(10)

    def predict(b):
        return gt68[b[:, 0, 0, 0].astype(int)] + 0.5

    got, ref = te.benchmark_report(predict, imgs, gt68, batch=4), je.benchmark_report(
        predict, imgs, gt68, batch=4)
    assert got.keys() == ref.keys()
    for k in got:
        if k == "nme":
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k] == ref[k], k


def test_run_log_and_edge_maps_equal(tmp_path):
    import cv2

    row = {"ID": "202610180000", "Backbone": "ghostnet", "Dataset": "300W", "Test Perf": 0.04}
    paths = [mod.append_run_log(str(tmp_path / name), row) for mod, name in ((te, "t"), (je, "j"))]
    assert open(paths[0]).read() == open(paths[1]).read()

    from dfanerf_tpu.pipeline import edge_map as jm
    from dfanerf_torch.pipeline import edge_map as tm

    rng = np.random.RandomState(2)
    parse = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    parse[3:6, 2:9] = (255, 0, 0)
    np.testing.assert_array_equal(tm.body_seg_map(parse, 16), jm.body_seg_map(parse, 16))
    src = {d: tmp_path / d for d in ("inp", "inp_val", "gt", "parse")}
    for d in src.values():
        d.mkdir()
    n, val_idx = 6, 4
    for i in range(n):
        img = np.full((16, 16, 3), i * 10, np.uint8)
        cv2.imwrite(str(src["inp"] / f"{i:06d}.jpg"), img)
        cv2.imwrite(str(src["gt"] / f"{i:06d}.jpg"), img)
        p = np.full((16, 16, 3), 255, np.uint8)
        p[i:i + 2, :] = (0, 0, 255)
        cv2.imwrite(str(src["parse"] / f"{i:06d}.png"), p)
    for c in range(n - val_idx):
        cv2.imwrite(str(src["inp_val"] / f"{c:06d}.jpg"), np.full((16, 16, 3), 200 + c, np.uint8))
    for skip in (True, False):
        outs = []
        for mod, name in ((tm, "t"), (jm, "j")):
            save = tmp_path / f"out_{name}_{skip}"
            n_written = mod.export_edge_maps(str(src["inp"]), str(src["gt"]), str(src["parse"]),
                                             str(save), input_val_img_path=str(src["inp_val"]),
                                             mode="train_val", val_idx=val_idx, input_size=16,
                                             skip_below_val_idx=skip)
            files = {os.path.relpath(os.path.join(r, f), save): open(os.path.join(r, f), "rb").read()
                     for r, _, fs in os.walk(save) for f in fs}
            outs.append((n_written, files))
        assert outs[0] == outs[1]
        assert outs[0][0] == (n - val_idx if skip else n)


def _toy(x):
    """The reference's stub: heatmap = mean of the image channels + 0.5 x the
    fed-back heatmap, channel-last [h, w, 3 + 1]."""
    return x[..., :3].mean(-1, keepdims=True) + 0.5 * x[..., 3:]


def test_temporal_sequence_and_validate_match_reference():
    rng = np.random.RandomState(3)
    frames = rng.rand(6, 5, 5, 3).astype(np.float32)
    vid = np.array([0, 0, 0, 1, 1, 2])
    ref = jt.run_temporal_sequence(_toy, jnp.asarray(frames), jnp.asarray(vid), 1)
    got = tt.run_temporal_sequence(lambda x: _toy(x.permute(1, 2, 0)).permute(2, 0, 1),
                                   _nchw(frames), vid, 1)
    _close(got.numpy().transpose(0, 2, 3, 1), ref, "sequence")
    gt = np.tile(np.linspace(10, 50, 68 * 2).reshape(1, 68, 2), (6, 1, 1))
    out_t = tt.temporal_validate(lambda x: _toy(x.permute(1, 2, 0)).permute(2, 0, 1),
                                 _nchw(frames), vid, gt, 1, decode_fn=lambda hm: gt[0] + float(hm.mean()))
    out_j = jt.temporal_validate(_toy, jnp.asarray(frames), jnp.asarray(vid), gt, 1,
                                 decode_fn=lambda hm: gt[0] + float(hm.mean()))
    _close(out_t["nme"], out_j["nme"], "nme")
    assert out_t["failure_rate"] == out_j["failure_rate"]


@pytest.mark.parametrize("teacher_forcing", [True, False], ids=["teacher", "own"])
def test_temporal_train_step_matches_reference(teacher_forcing):
    rng = np.random.RandomState(4)
    frames = rng.rand(6, 4, 4, 3).astype(np.float32)
    gt = (frames.mean(-1, keepdims=True) * 2.0).astype(np.float32)
    vid = np.array([0, 0, 0, 1, 1, 1])
    params = {"w": np.float32(1.0), "u": np.float32(0.3), "b": np.float32(0.1)}

    def j_apply(p, x):
        return x[..., :3].mean(-1, keepdims=True) * p["w"] + x[..., 3:] * p["u"] + p["b"]

    def t_apply(p, x):  # channel-first
        return x[:3].mean(0, keepdim=True) * p["w"] + x[3:] * p["u"] + p["b"]

    def j_sgd(opt, grads, p):
        return jax.tree.map(lambda a, g: a - 0.5 * g, p, grads), opt

    def t_sgd(opt, grads, p):
        return {k: p[k] - 0.5 * grads[k] for k in p}, opt

    j_step = jt.make_temporal_train_step(j_apply, lambda h, g: jnp.mean((h - g) ** 2), j_sgd, 1,
                                         teacher_forcing)
    t_step = tt.make_temporal_train_step(t_apply, lambda h, g: ((h - g) ** 2).mean(), t_sgd, 1,
                                         teacher_forcing)
    ref_p, _, ref_l = j_step({k: jnp.asarray(v) for k, v in params.items()}, None,
                             jnp.asarray(frames), jnp.asarray(gt), jnp.asarray(vid))
    got_p, _, got_l = t_step({k: torch.tensor(v) for k, v in params.items()}, None,
                             _nchw(frames), _nchw(gt), vid)
    _close(float(got_l), float(ref_l), "loss")
    for k in params:
        _close(float(got_p[k]), float(ref_p[k]), k)


@pytest.fixture(scope="module")
def eye():
    params = jax.tree.map(np.asarray, jax.jit(init_eye_net)(jax.random.PRNGKey(0)))
    net = EyeNet()
    net.load_state_dict(eye_net_state_dict_from_jax(params))
    rng = np.random.RandomState(1)
    images = rng.rand(2, 32, 48, 1).astype(np.float32)
    joints = rng.uniform(2, 14, (2, 6, 2)).astype(np.float32)
    return params, net.eval(), images, joints


def _tree_to_port(tree):
    """A trained reference eye-net tree as the port's trainable tensors."""
    return {k: v for k, v in eye_net_state_dict_from_jax(tree).items() if v.is_floating_point()}


@pytest.mark.parametrize("loss", ["mse"])
def test_heatmap_train_step_matches_reference(eye, loss):
    """One Adam step on the eye net from the reference's weights: the loss
    before it, then every trained tensor (BatchNorm statistics included).
    (The step's other losses are the functions held above.)"""
    params, net, images, joints = eye
    j_init, j_step = jl.make_heatmap_train_step(apply_eye_net, loss=loss, lr=1e-3)
    ref_params, _, ref_loss = j_step(params, j_init(params), jnp.asarray(images),
                                     jnp.asarray(joints))
    init, step = tl.make_heatmap_train_step(net, loss=loss, lr=1e-3)
    tensors = tl.trainable_tensors(net)
    before = {k: v.clone() for k, v in tensors.items()}
    got_loss = step(tensors, init(tensors), _nchw(images), torch.from_numpy(joints))
    _close(float(got_loss), float(ref_loss), "loss")
    want = _tree_to_port(jax.tree.map(np.asarray, ref_params))
    assert sorted(want) == sorted(tensors)
    for k, v in tensors.items():
        _close(v.numpy(), want[k].numpy(), k)
    assert any(not torch.equal(v, before[k]) for k, v in tensors.items())
    # the net the step was made from is untouched
    assert all(torch.equal(net.state_dict()[k], before[k]) for k in before)


def test_validate_and_lr_range_match_reference(eye):
    params, net, images, joints = eye
    rng = np.random.RandomState(5)
    gt = rng.uniform(6, 26, (3, 68, 2)).astype(np.float32)

    def ideal(imgs):
        return tl.gaussian_targets(torch.from_numpy(gt), (32, 32), 1.5)[0]

    got = tl.validate_landmarks(ideal, None, gt)
    ref = jl.validate_landmarks(lambda p, i: jl.gaussian_targets(jnp.asarray(gt), (32, 32),
                                                                 1.5)[0], None, None, gt)
    _close(got["preds"], ref["preds"], "preds")
    _close(got["nme"], ref["nme"], "nme")
    assert got["failure_rate"] == ref["failure_rate"] == 0.0
    batches = [(rng.rand(2, 32, 48, 1).astype(np.float32),
                rng.uniform(2, 14, (2, 6, 2)).astype(np.float32)) for _ in range(3)]
    from dfanerf_tpu.train.optim import adam_init

    lrs_j, losses_j = jl.lr_range_test(apply_eye_net, params, adam_init(params), batches,
                                       lr_min=1e-5, lr_max=1e-2)
    tensors = tl.trainable_tensors(net)
    lrs_t, losses_t = tl.lr_range_test(net, tensors, tl.adam_state(tensors),
                                       [(_nchw(i), torch.from_numpy(j)) for i, j in batches],
                                       lr_min=1e-5, lr_max=1e-2)
    np.testing.assert_allclose(lrs_t, lrs_j, rtol=1e-12)
    # the first loss from the same weights; the later ones after steps
    # compared in test_heatmap_train_step_matches_reference
    _close(losses_t[0], losses_j[0], "first loss")
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
