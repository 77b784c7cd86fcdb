"""The port's multi-identity step (parallel/multi.py) against the reference
package's make_multi_identity_train_step on the CPU, unsharded, step for
step: static speaker and dynamic speaker, 3 steps of 2 objects each.

Each port step starts from the reference's state before that step (a
numpy-seeded n_object=2 state in the reference's layout, then the
reference's own steps' states, converted with their moments) on two
synthetic scenes (24x24, 8 frames, seeds 0 and 5), with a decoder of 4
blocks, 64 wide, z_dim 32, 128 rays of 16 unperturbed samples. The port is
fed the reference's own draws: per object the 3-way key split, the frame
position over the object's frame list and the pixel scores (through the
port's pixel_coords_from_scores). nosmo_iters=1 and noexp_iters=2 flip the
stage gates inside the 3 steps. The reference's static and dynamic steps
compile at once, in two threads (about 25 s of the file's ~35 s).

Bars (tests/test_torch_train_step.py's, which explains them), after each
step: float32 losses within rtol 1e-4; every parameter within Adam's
sign-noise bound of n_object updates of 2 lr, and 99% of them within 1e-5;
the counters equal; moments within a relative norm of 3e-2 leaf by leaf
(expnet's within 0.3: _check_moments). Measured (static / dynamic): losses
within rtol 1.4e-6 / 1.1e-7; parameters at most 1.9e-4 / 3.2e-4 apart,
99.93% / 99.91% within 1e-5; moments within 4.3e-3 / 3.1e-3. (The bf16
step of this slice is held in tests/test_torch_sparsity.py.)
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.config import SignalConfig as JSignalConfig
from dfanerf_tpu.config import TrainConfig as JTrainConfig
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.parallel.multi import make_multi_identity_train_step as j_make_multi
from dfanerf_torch.compat.from_jax import state_from_jax, state_to_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig, TrainConfig
from dfanerf_torch.data.dataset import FrameDataset
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.parallel.multi import make_multi_identity_train_step
from dfanerf_torch.train.state import init_train_state
from dfanerf_torch.train.step import pixel_coords_from_scores
from test_torch_train_step import _check_moments

DEC = dict(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)
TRAIN = dict(n_rand=128, z_dim=32, n_object=2)
SIGNAL = dict(nosmo_iters=1, noexp_iters=2)
H = W = 24
N_FRAMES = 8
N_SAMPLES = 16
N_STEPS = 3
LR = 5e-4
# an entry's largest move in one step: n_object Adam updates of lr * 2 (the smo groups)
SIGN_NOISE = 2 * (2 * LR) * TRAIN["n_object"]
# frames 0-7 of each object (frames 0-5 train, 6-7 are held out)
SPEAK = (np.array([1, 1, 0, 1, 0, 0, 1, 1], np.int32), np.array([0, 1, 1, 0, 1, 1, 0, 1], np.int32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(dtype="float32", **train):
    render = dict(n_samples=N_SAMPLES, compute_dtype=dtype)
    t = dict(TRAIN, **train)
    return (JExperimentConfig(decoder=JDecoderConfig(**DEC), render=JRenderConfig(**render),
                              train=JTrainConfig(**t), signal=JSignalConfig(**SIGNAL)),
            ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(**render),
                             train=TrainConfig(**t), signal=SignalConfig(**SIGNAL)))


def to_port(ds) -> FrameDataset:
    return FrameDataset(**{f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)})


@pytest.fixture(scope="module")
def scenes():
    return [dataclasses.replace(
        make_synthetic_dataset(n_frames=N_FRAMES, H=H, W=W, n_samples_gt=16, seed=seed),
        speak_frames=speak) for seed, speak in ((0, SPEAK[0]), (5, SPEAK[1]))]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def reference_batches(key, frame_lists, n_rand):
    """The reference multi step's draws for ``key`` (multi.py:183-193), one
    batch per object: the frame through the object's list as jnp indexes it
    (clamped), the pixels through the port's transform."""
    out = []
    for frames in frame_lists:
        key, k_img, k_pix = jax.random.split(key, 3)
        pos = int(jax.random.randint(k_img, (), 0, len(frames)))
        u = torch.from_numpy(np.array(jax.random.uniform(k_pix, (H * W,))))
        out.append({"img_i": int(frames[min(pos, len(frames) - 1)]),
                    "coords": pixel_coords_from_scores(u, H, W, n_rand, 0.0, None)})
    return out


def with_depths(step, batches):
    return [dict(b, z_vals=step.z_vals(ob)) for b, ob in zip(batches, step.objects)]


def initial_state(seed=0):
    """A state in the reference's layout drawn with numpy: every weight and
    bias U(+-1/sqrt(fan_in)), as both packages' inits draw them, the latents
    N(0, 1), zero moments, step 0 (the reference's eager init takes 15-20 s
    of first-call compiles here)."""
    _, tcfg = configs()
    tree = state_to_jax(init_train_state(tcfg, seed=0, device="cpu"))
    rng = np.random.RandomState(seed)

    def draw(node):
        if isinstance(node, list):
            return [draw(v) for v in node]
        if "w" in node:
            bound = 1.0 / np.sqrt(np.prod(node["w"].shape[:-1]))
            return {k: rng.uniform(-bound, bound, v.shape).astype(np.float32)
                    for k, v in node.items()}
        return {k: draw(v) for k, v in node.items()}

    tree["params"] = draw(tree["params"])
    for k in ("z_shape", "z_app"):
        tree[k] = rng.randn(*tree[k].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def reference_steps(scenes):
    """The reference's static and dynamic steps, compiled at once in two
    threads: {dynamic: (compiled step, its data)}."""
    jcfg, _ = configs()
    state = initial_state()

    def build(dynamic):
        jstep, jdata = j_make_multi(jcfg, scenes, dynamic_speaker=dynamic)
        return jstep.lower(state, jdata, jax.random.PRNGKey(0)).compile(), jdata

    with ThreadPoolExecutor(2) as pool:
        futures = {d: pool.submit(build, d) for d in (False, True)}
        return {d: f.result() for d, f in futures.items()}


def run_both(scenes, reference_steps, dynamic, n_steps=N_STEPS):
    """The reference's steps from the initial state, and the port's step
    from each of the reference's states on that step's draws: (reference
    states, reference metrics, port states after each step in the
    reference's layout, port metrics, port step, batches)."""
    _, tcfg = configs()
    jstep, jdata = reference_steps[dynamic]
    step, data = make_multi_identity_train_step(tcfg, [to_port(d) for d in scenes],
                                                dynamic_speaker=dynamic, device="cpu")
    jstate = initial_state()
    frame_lists = [ob.i_train for ob in step.objects]
    keys = jax.random.split(jax.random.PRNGKey(7), n_steps)
    ref_states, ref_m, got_states, got_m, all_batches = [jstate], [], [], [], []
    for key in keys:
        state = state_from_jax(ref_states[-1], tcfg, device="cpu")
        jstate, m = jstep(jstate, jdata, key)
        ref_states.append(np_tree(jstate))
        ref_m.append(np_tree(m))
        batches = with_depths(step, reference_batches(key, frame_lists, TRAIN["n_rand"]))
        state, gm = step.step_on_batch(state, data, batches)
        got_states.append(jax.tree.map(np.array, state_to_jax(state)))
        got_m.append({k: float(v) for k, v in gm.items()})
        all_batches.append(batches)
    return ref_states, ref_m, got_states, got_m, step, all_batches


def param_diffs(a, b):
    return np.concatenate([np.abs(x - y).ravel() for x, y in zip(
        jax.tree_util.tree_leaves(a["params"]), jax.tree_util.tree_leaves(b["params"]))])


def moments_rel(got, ref):
    """The largest relative norm, leaf by leaf, between the moments."""
    return max(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
               for name, o in ref["opt"].items() for k in ("m", "v")
               for a, b in zip(jax.tree_util.tree_leaves(got["opt"][name][k]),
                               jax.tree_util.tree_leaves(o[k])))


def check_run(ref_states, ref_m, got_states, got_m):
    """Each step against the reference's: metrics, parameters, counters and
    moments; returns the largest loss rtol, parameter difference and
    moments' relative norm seen."""
    worst = [0.0, 0.0, 1.0, 0.0]
    for i, (g, r) in enumerate(zip(got_m, ref_m)):
        assert set(g) == set(r), (sorted(g), sorted(r))
        for k in r:
            np.testing.assert_allclose(g[k], float(r[k]), rtol=1e-4, err_msg=f"{k} step {i}")
            worst[0] = max(worst[0], abs(g[k] / float(r[k]) - 1))
        d = param_diffs(got_states[i], ref_states[i + 1])
        assert d.max() <= SIGN_NOISE, (i, d.max())
        assert (d <= 1e-5).mean() >= 0.99, (i, (d <= 1e-5).mean())
        _check_moments(got_states[i], ref_states[i + 1], 3e-2)
        worst[1:] = (max(worst[1], d.max()), min(worst[2], (d <= 1e-5).mean()),
                     max(worst[3], moments_rel(got_states[i], ref_states[i + 1])))
    return worst


@pytest.fixture(scope="module")
def runs(scenes, reference_steps):
    return {d: run_both(scenes, reference_steps, d) for d in (False, True)}


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_three_steps_match_reference(runs, dynamic):
    ref_states, ref_m, got_states, got_m, step, batches = runs[dynamic]
    check_run(ref_states, ref_m, got_states, got_m)
    # the groups' counters advance by n_object a step (expnet from step 2,
    # the smo groups from step 1)
    t = {n: int(o["t"]) for n, o in got_states[-1]["opt"].items()}
    assert t == {"decoder": 6, "audnet": 6, "expnet": 2, "audattnet": 4, "poseattnet": 4}, t
    branches = {step.speaks(o, b["img_i"]) for bs in batches for o, b in enumerate(bs)}
    if dynamic:
        assert branches == {True, False}, "the dynamic case must run both branches"
        # every training frame is drawn, not only the speaking ones
        assert [len(ob.i_train) for ob in step.objects] == [6, 6]
    else:
        assert [len(ob.i_train) for ob in step.objects] == [3, 4]
        assert all(step.speaks(0, i) and not step.speaks(1, i) for i in range(N_FRAMES))


def test_refuses_what_the_reference_refuses(scenes):
    _, tcfg = configs()
    tds = [to_port(d) for d in scenes]
    with pytest.raises(ValueError, match="n_object"):
        make_multi_identity_train_step(tcfg, tds[:1], device="cpu")
    with pytest.raises(ValueError, match="speak_frames"):
        make_multi_identity_train_step(tcfg, [dataclasses.replace(tds[0], speak_frames=None),
                                              tds[1]], dynamic_speaker=True, device="cpu")


def test_state_with_two_objects_round_trips(runs):
    """compat/from_jax.py carries an n_object=2 state (latents [4, z_dim]),
    as the reference's step left it, across both ways bit for bit."""
    _, tcfg = configs()
    jstate = runs[True][0][-1]
    assert jstate["z_shape"].shape == (4, 32)
    back = state_to_jax(state_from_jax(jstate, tcfg, device="cpu"))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    got, ref = flat(back), flat(jstate)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (p, g), (_, r) in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r), p
