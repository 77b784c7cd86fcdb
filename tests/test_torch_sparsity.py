"""The serving-bake sparsity prior of the port's train step
(make_train_step(sparsity_lambda > 0), train/step.py) against the reference
package's jitted make_train_step with the same prior, on the CPU: each mode
('points', 'deadzone', 'visibility'), 2 steps, each port step from the
reference's state before it and on the reference's own draws for its key
(the 4th key's points, or its frame and pixel scores, beside the batch's).

A 24x24 synthetic scene (8 frames), a decoder of 4 blocks, 64 wide, z_dim
32, 128 rays of 16 jittered samples, 256 prior points (16 visibility rays),
lambda 0.1; nosmo_iters=1 turns the smoothing on at the second step. The
deadzone's cutoff is set between two of the first step's raw densities at
their median, so its gate splits the points; the visibility runs shift the
density bias (VISIBILITY_SHIFT) so that some samples go unseen.

Bars (tests/test_torch_train_step.py's): float32 losses and grad_norm
within rtol 1e-4; every parameter within Adam's sign-noise bound 2 lr * 2
and 99% of them within 1e-5 after each step; the frustum box within 1e-6
of the reference's. One bf16 step ('points'): losses within rtol 1e-3,
grad_norm 5e-3. Measured (points / visibility / deadzone): losses within
rtol 1.9e-7 / 4.7e-7 / 3.5e-7, grad_norm 1.9e-7 / 1.3e-7 / 1.7e-6,
parameters at most 5.7e-6 / 9.7e-7 / 4.7e-5 apart (all but 0.0006% of the
deadzone's within 1e-5), the box exactly; the prior moves the first step's
loss 0.0277 -> 0.0593 / 0.107 -> 1.61 / 0.0277 -> 0.0344; bf16: losses
within 1.6e-5, grad_norm 1.1e-5.
"""

import inspect
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.config import SignalConfig as JSignalConfig
from dfanerf_tpu.config import TrainConfig as JTrainConfig
from dfanerf_tpu.core.sampling import stratified_z_vals as j_stratified_z_vals
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.train import dataset_to_device as j_dataset_to_device
from dfanerf_tpu.train import make_train_step as j_make_train_step
from dfanerf_torch.compat.from_jax import state_from_jax, state_to_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig, TrainConfig
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.train.step import (
    dataset_to_device, frustum_aabb, make_train_step, pixel_coords_from_scores,
)
from test_torch_multi_identity import initial_state, param_diffs, to_port

DEC = dict(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)
TRAIN = dict(n_rand=128, z_dim=32, perturb=True)
SIGNAL = dict(nosmo_iters=1, noexp_iters=2)
H = W = 24
N_SAMPLES = 16
POINTS = 256
LAM = 0.1
LR = 5e-4
METRICS = ("loss", "loss_head", "loss_com", "grad_norm")
# the visibility prior gates on compositing weights under 1e-4: seeded
# weights' densities (~1e-2) leave every sample seen, so its runs shift the
# density bias until the transmittance dies along the rays
VISIBILITY_SHIFT = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(dtype="float32"):
    render = dict(n_samples=N_SAMPLES, compute_dtype=dtype)
    return (JExperimentConfig(decoder=JDecoderConfig(**DEC), render=JRenderConfig(**render),
                              train=JTrainConfig(**TRAIN), signal=JSignalConfig(**SIGNAL)),
            ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(**render),
                             train=TrainConfig(**TRAIN), signal=SignalConfig(**SIGNAL)))


@pytest.fixture(scope="module")
def scene():
    ds = make_synthetic_dataset(n_frames=8, H=H, W=W, n_samples_gt=16)
    return ds, to_port(ds), jax.random.split(jax.random.PRNGKey(3), 2)


def state1(shift=0.0):
    """initial_state's numpy-seeded weights for one object, the density
    bias shifted by ``shift``."""
    tree = initial_state()
    tree["z_shape"], tree["z_app"] = tree["z_shape"][:2], tree["z_app"][:2]
    tree["params"]["decoder"]["sigma_out"]["b"] += np.float32(shift)
    return tree


def reference_batch(step, key, mode):
    """The reference step's draws for ``key`` (train/step.py:382-391 and the
    4th key's, :164-196) as the port's batch."""
    k_img, k_pix, k_z, k_sparse = jax.random.split(key, 4)
    n_train = step.n_train
    img_i = int(step.i_train[int(jax.random.randint(k_img, (), 0, n_train))])
    u = torch.from_numpy(np.array(jax.random.uniform(k_pix, (H * W,))))
    z = np.asarray(j_stratified_z_vals(0.3, 0.9, TRAIN["n_rand"], N_SAMPLES, key=k_z))
    batch = {"img_i": img_i, "coords": pixel_coords_from_scores(u, H, W, TRAIN["n_rand"], 0.0,
                                                                 None),
             "z_vals": torch.from_numpy(z)}
    if mode == "visibility":
        k_img, k_pix, _ = jax.random.split(k_sparse, 3)
        batch["sparse_img_i"] = int(step.i_train[int(jax.random.randint(k_img, (), 0, n_train))])
        u = torch.from_numpy(np.array(jax.random.uniform(k_pix, (H * W,))))
        batch["sparse_coords"] = pixel_coords_from_scores(u, H, W, step.visibility_rays(), 0.0,
                                                          None)
    else:
        batch["sparse_u"] = torch.from_numpy(np.array(jax.random.uniform(k_sparse, (POINTS, 3))))
    return batch


def closure_value(fn, name):
    """The value ``name`` bound in the closures reachable from ``fn``."""
    seen, todo = set(), [getattr(fn, "__wrapped__", fn)]
    while todo:
        f = todo.pop()
        if id(f) in seen or not inspect.isfunction(f):
            continue
        seen.add(id(f))
        free = inspect.getclosurevars(f).nonlocals
        if name in free:
            return free[name]
        todo += list(free.values())
    raise KeyError(name)


RUNS = {"points": ("points", "float32"), "visibility": ("visibility", "float32"),
        "deadzone": ("deadzone", "float32"), "bf16": ("points", "bfloat16")}


@pytest.fixture(scope="module")
def reference_steps(scene):
    """The reference's step for each of RUNS, compiled at once in threads:
    {run: (jitted step, compiled step, cutoff)}."""
    ds = scene[0]
    cutoff = deadzone_cutoff(scene)
    data, key = j_dataset_to_device(ds), jax.random.PRNGKey(0)

    def build(name):
        mode, dtype = RUNS[name]
        c = cutoff if mode == "deadzone" else 10.0
        jstep = j_make_train_step(configs(dtype)[0], ds, sparsity_lambda=LAM,
                                  sparsity_points=POINTS, sparsity_mode=mode, sparsity_cutoff=c)
        return jstep, jstep.lower(state1(), data, key).compile(), c

    with ThreadPoolExecutor(len(RUNS)) as pool:
        futures = {name: pool.submit(build, name) for name in RUNS}
        return {name: f.result() for name, f in futures.items()}


def run(scene, reference_steps, name, n_steps=2):
    """Each step in both packages from the reference's state before it:
    (reference metrics, port metrics, parameter differences, port step,
    batches, reference step)."""
    ds, tds, keys = scene
    mode, dtype = RUNS[name]
    jfun, jstep, cutoff = reference_steps[name]
    shift = VISIBILITY_SHIFT if mode == "visibility" else 0.0
    _, tcfg = configs(dtype)
    step = make_train_step(tcfg, tds, sparsity_lambda=LAM, sparsity_points=POINTS,
                           sparsity_mode=mode, sparsity_cutoff=cutoff, device="cpu")
    jdata, data = j_dataset_to_device(ds), dataset_to_device(tds, "cpu")
    jstate = state1(shift)
    ref_m, got_m, diffs, batches = [], [], [], []
    for key in keys[:n_steps]:
        state = state_from_jax(jstate, tcfg, device="cpu")
        jstate, m = jstep(jstate, jdata, key)
        jstate = jax.tree.map(np.asarray, jstate)
        batch = reference_batch(step, key, mode)
        state, gm = step.step_on_batch(state, data, batch)
        assert gm["img_i"] == int(m["img_i"])
        ref_m.append({k: float(m[k]) for k in METRICS})
        got_m.append({k: float(gm[k]) for k in METRICS})
        diffs.append(param_diffs(state_to_jax(state), jstate))
        batches.append(batch)
    return ref_m, got_m, diffs, step, batches, jfun


def deadzone_cutoff(scene):
    """A cutoff between the raw densities of the first step's prior points
    (the median over both fields), so the gate splits them."""
    _, tds, keys = scene
    _, tcfg = configs()
    step = make_train_step(tcfg, tds, sparsity_lambda=LAM, sparsity_points=POINTS,
                           device="cpu")
    state = state_from_jax(state1(), tcfg, device="cpu")
    sig = raw_densities(step, state, dataset_to_device(tds, "cpu"),
                        reference_batch(step, keys[0], "points"))
    v = torch.sort(torch.cat(sig)).values
    k = len(v) // 2
    assert v[k] - v[k - 1] > 1e-5  # no density within float32 noise of the cutoff
    return float(v[k - 1] + v[k]) / 2


def raw_densities(step, state, data, batch):
    """Both fields' raw densities at the batch's prior points, with the
    first step's (unsmoothed) signals."""
    lo, hi = step.aabb
    pts = lo + batch["sparse_u"] * (hi - lo)
    dirs = step.down.expand(pts.shape)
    with torch.no_grad():
        signal, signal_torso = step.signals(state["params"], data, batch["img_i"], False)
        return [state["params"].decoder(pts, dirs, state["z_shape"][o], state["z_app"][o], s,
                                        b)[1]
                for o, s, b in ((0, signal, "head"), (1, signal_torso, "torso"))]


def check(ref_m, got_m, diffs, rtol=1e-4):
    for i, (g, r) in enumerate(zip(got_m, ref_m)):
        for k in METRICS:
            np.testing.assert_allclose(g[k], r[k], rtol=rtol, err_msg=f"{k} step {i}")
    for i, d in enumerate(diffs):
        assert d.max() <= 2 * LR * 2, (i, d.max())
        assert (d <= 1e-5).mean() >= 0.99, (i, (d <= 1e-5).mean())


@pytest.mark.parametrize("mode", ["points", "visibility", "deadzone"])
def test_two_steps_match_reference(scene, reference_steps, mode):
    cutoff = reference_steps[mode][2]
    shift = VISIBILITY_SHIFT if mode == "visibility" else 0.0
    ref_m, got_m, diffs, step, batches, jstep = run(scene, reference_steps, mode)
    check(ref_m, got_m, diffs)
    # the port's box is the reference's
    lo, hi = (np.asarray(closure_value(jstep, n)) for n in ("aabb_lo", "aabb_hi"))
    np.testing.assert_allclose(step.aabb[0].numpy(), lo, atol=1e-6)
    np.testing.assert_allclose(step.aabb[1].numpy(), hi, atol=1e-6)
    # not vacuous: the prior moves the loss
    _, tcfg = configs()
    ds, tds, _ = scene
    plain = make_train_step(tcfg, tds, device="cpu")
    state = state_from_jax(state1(shift), tcfg, device="cpu")
    data = dataset_to_device(tds, "cpu")
    with torch.no_grad():
        l0 = plain.loss(state["params"], state, data, batches[0], False, False)[0]
        l1 = step.loss(state["params"], state, data, batches[0], False, False)[0]
    assert float(l1) > float(l0) * (1 + 1e-4), (float(l0), float(l1))
    if mode == "deadzone":
        state = state_from_jax(state1(), tcfg, device="cpu")
        sig = torch.cat(raw_densities(step, state, data, batches[0]))
        below = (sig < cutoff).float().mean()
        assert 0.3 < below < 0.7, float(below)


def test_frustum_box_covers_every_pose(scene):
    """Every training pose's corner rays at near and far lie in the box, and
    it is the reference's to 1e-6 (computed as the reference does)."""
    ds, tds, _ = scene
    lo, hi = (t.numpy() for t in frustum_aabb(tds))
    from dfanerf_tpu.core.rays import get_rays

    corners = []
    for p in ds.poses:
        ro, rd = get_rays(H, W, ds.hwfcxy[2], jnp.asarray(p), ds.hwfcxy[3], ds.hwfcxy[4])
        ro = np.asarray(ro).reshape(-1, 3)[[0, W - 1, -W, -1]]
        rd = np.asarray(rd).reshape(-1, 3)[[0, W - 1, -W, -1]]
        corners += [ro + rd * ds.near, ro + rd * ds.far]
    corners = np.concatenate(corners)
    np.testing.assert_allclose(lo, corners.min(0), atol=1e-6)
    np.testing.assert_allclose(hi, corners.max(0), atol=1e-6)
    assert (hi - lo > 0).all()


def test_unknown_mode_acts_as_points(scene):
    _, tds, keys = scene
    _, tcfg = configs()
    kw = dict(sparsity_lambda=LAM, sparsity_points=POINTS, device="cpu")
    points = make_train_step(tcfg, tds, sparsity_mode="points", **kw)
    other = make_train_step(tcfg, tds, sparsity_mode="no-such-mode", **kw)
    batch = reference_batch(points, keys[0], "points")
    state = state_from_jax(state1(), tcfg, device="cpu")
    data = dataset_to_device(tds, "cpu")
    with torch.no_grad():
        a = points.loss(state["params"], state, data, batch, False, False)[0]
        b = other.loss(state["params"], state, data, batch, False, False)[0]
    assert float(a) == float(b)


def test_one_bf16_step_matches_reference(scene, reference_steps):
    ref_m, got_m, diffs, _, _, _ = run(scene, reference_steps, "bf16", n_steps=1)
    for k in ("loss", "loss_head", "loss_com"):
        np.testing.assert_allclose(got_m[0][k], ref_m[0][k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(got_m[0]["grad_norm"], ref_m[0]["grad_norm"], rtol=5e-3)
    assert diffs[0].max() <= 2 * LR * 2
