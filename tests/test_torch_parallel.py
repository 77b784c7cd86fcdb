"""BASELINE config 5 in the port (parallel/): the process group and the
('dcn', 'rays') mesh over torch.distributed, the ray-sharded train step and
the sharded multi-identity step, against the reference package's
make_sharded_train_step and make_multi_identity_train_step on
jax.devices()[:4] of the 8-device CPU mesh.

One launch of 4 child processes, torchrun's environment by hand over gloo
(two "nodes" of two ranks: LOCAL_WORLD_SIZE 2), importing the port only.
They check the pod mesh's layout and the two-hop all-reduce, then wait for
the reference's states and draws, which the parent computes meanwhile, and
run 3 sharded steps (float32, jittered depths) and 2 sharded static-speaker
multi-identity steps, each from the reference's state before it. The parent
holds every rank's results bit-equal to rank 0's, and rank 0's against the
reference's.

Bars (tests/test_torch_train_step.py's, which explains them): losses within
rtol 1e-5; after each step every parameter within Adam's sign-noise bound
and 99% of them within 1e-5. The relative norm of the parameters'
difference is printed beside them. Measured (sharded / multi-identity):
losses within rtol 2.7e-7 / 2.1e-7; parameters at most 3.4e-4 / 2.9e-4
apart, 99.98% / 99.74% within 1e-5, a relative norm of 2.1e-5 / 4.2e-5
(the entries whose near-eps gradients flip Adam's step, as above).
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.core.sampling import stratified_z_vals as j_stratified_z_vals
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.parallel import make_mesh as j_make_mesh
from dfanerf_tpu.parallel import make_sharded_train_step as j_make_sharded
from dfanerf_tpu.parallel import replicate_state as j_replicate_state
from dfanerf_tpu.parallel.multi import compute_speaker_ids as j_compute_speaker_ids
from dfanerf_tpu.parallel.multi import make_multi_identity_train_step as j_make_multi
from dfanerf_tpu.train import dataset_to_device as j_dataset_to_device
from dfanerf_torch.parallel.distributed import (
    hierarchical_all_reduce, initialize, make_pod_mesh, shard_index,
)
from dfanerf_torch.parallel.mesh import make_sharded_train_step
from dfanerf_torch.parallel.multi import compute_speaker_ids
from dfanerf_torch.train.step import pixel_coords_from_scores
import test_torch_multi_identity as multi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
H = W = 24
N_SAMPLES = 16
SHARDED_STEPS, MULTI_STEPS = 3, 2
TRAIN = dict(n_rand=128, z_dim=32, perturb=True)
LR = 5e-4
TIMEOUT = 120

CHILD = textwrap.dedent('''
    import os, pickle, sys, time
    sys.path.insert(0, %(repo)r)
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from dfanerf_torch.compat.from_jax import state_from_jax, state_to_jax
    from dfanerf_torch.config import ExperimentConfig
    from dfanerf_torch.parallel import make_mesh, make_sharded_train_step, replicate_state
    from dfanerf_torch.parallel.distributed import (
        hierarchical_all_reduce, initialize, make_pod_mesh, shard_index)
    from dfanerf_torch.parallel.multi import make_multi_identity_train_step
    from dfanerf_torch.train.step import dataset_to_device

    assert initialize(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 4 and dist.get_backend() == "gloo"
    pod = make_pod_mesh()
    assert pod.mesh_dim_names == ("dcn", "rays") and tuple(pod.shape) == (2, 2), pod
    # each 'rays' row is one node's local ranks
    local = int(os.environ["LOCAL_WORLD_SIZE"])
    for row in pod.mesh.tolist():
        assert len({r // local for r in row}) == 1, pod.mesh
    index, count = shard_index(pod)
    assert (index, count) == (rank, 4), (index, count)
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    part = x[index * 8 // count:(index + 1) * 8 // count].sum().reshape(1)
    assert float(hierarchical_all_reduce(part, pod)) == float(x.sum())

    mesh = make_mesh()
    path = os.path.join(%(tmp)r, "inputs.pkl")
    deadline = time.time() + %(timeout)d
    while not os.path.exists(path):
        assert time.time() < deadline, "no inputs"
        time.sleep(0.1)
    with open(path, "rb") as f:
        inp = pickle.load(f)

    out = {"sharded": [], "multi": []}
    cfg = ExperimentConfig.from_json(os.path.join(%(tmp)r, "sharded.json"))
    step = make_sharded_train_step(cfg, inp["ds"], mesh)
    data = dataset_to_device(inp["ds"], "cpu")
    for tree, batch in zip(inp["sharded_states"], inp["sharded_batches"]):
        state = state_from_jax(tree, cfg, device="cpu")
        if rank:  # replicate_state must bring rank 0's state everywhere
            with torch.no_grad():
                for p in state["params"].parameters():
                    p.add_(rank)
            state["step"] += rank
        replicate_state(state, mesh)
        state, m = step.step_on_batch(state, data, batch)
        out["sharded"].append(({k: float(v) for k, v in m.items()}, state_to_jax(state)))

    cfg = ExperimentConfig.from_json(os.path.join(%(tmp)r, "multi.json"))
    step, data = make_multi_identity_train_step(cfg, inp["scenes"], mesh=mesh)
    for tree, batches in zip(inp["multi_states"], inp["multi_batches"]):
        state = state_from_jax(tree, cfg, device="cpu")
        batches = [dict(b, z_vals=step.z_vals(ob)) for b, ob in zip(batches, step.objects)]
        state, m = step.step_on_batch(state, data, batches)
        out["multi"].append(({k: float(v) for k, v in m.items()}, state_to_jax(state)))
    with open(os.path.join(%(tmp)r, "out%%d.pkl" %% rank), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    print("CHILD_OK", rank)
''')


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD % {"repo": REPO, "tmp": str(tmp_path), "timeout": TIMEOUT})
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank % 2),
                   LOCAL_WORLD_SIZE="2", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    return procs


def _wait(procs, deadline):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the ranks timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0 and "CHILD_OK" in out, f"a rank failed:\n{out}\n{err}"


def _sharded_batch(key, speaking, n_train, n_shards):
    """The reference sharded step's draws (mesh.py:106-118): a 3-way key
    split, the frame position over every training frame indexing the
    speaking frames (clamped, as jnp's gather is), [n_rand / W, S] depths."""
    k_img, k_pix, k_z = jax.random.split(key, 3)
    pos = int(jax.random.randint(k_img, (), 0, n_train))
    u = torch.from_numpy(np.array(jax.random.uniform(k_pix, (H * W,))))
    z = np.array(j_stratified_z_vals(0.3, 0.9, TRAIN["n_rand"] // n_shards, N_SAMPLES, key=k_z))
    return {"img_i": int(speaking[min(pos, len(speaking) - 1)]),
            "coords": pixel_coords_from_scores(u, H, W, TRAIN["n_rand"], 0.0, None),
            "z_vals": torch.from_numpy(z)}


def _sharded_configs():
    jcfg, tcfg = multi.configs()
    train = dict(TRAIN)
    return (dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, n_object=1, **train)),
            dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, n_object=1, **train)))


def _reference_runs(ds, scenes):
    """The reference's sharded (3 steps) and sharded multi-identity (2
    steps) runs over jax.devices()[:4], compiled at once in two threads:
    ({"states", "metrics", "batches"} each; states[i] is the state before
    step i, states[-1] after the last)."""
    mesh = j_make_mesh(jax.devices()[:WORLD])
    jcfg1, _ = _sharded_configs()
    jcfg2, _ = multi.configs()
    s1 = multi.initial_state()
    s1["z_shape"], s1["z_app"] = s1["z_shape"][:2], s1["z_app"][:2]
    speaking = np.asarray(ds.i_train)

    def sharded():
        step = j_make_sharded(jcfg1, ds, mesh)
        data = j_dataset_to_device(ds)
        keys = jax.random.split(jax.random.PRNGKey(11), SHARDED_STEPS)
        states, metrics = [s1], []
        state = j_replicate_state(s1, mesh)
        for key in keys:
            state, m = step(state, data, key)
            states.append(multi.np_tree(state))
            metrics.append(multi.np_tree(m))
        batches = [_sharded_batch(k, speaking, len(ds.i_train), WORLD) for k in keys]
        return {"states": states, "metrics": metrics, "batches": batches}

    def multi_sharded():
        step, data = j_make_multi(jcfg2, scenes, mesh)
        frames = [np.intersect1d(d.i_train, np.nonzero(d.speak_frames > 0)[0]) for d in scenes]
        keys = jax.random.split(jax.random.PRNGKey(12), MULTI_STEPS)
        states, metrics = [multi.initial_state()], []
        state = j_replicate_state(states[0], mesh)
        for key in keys:
            state, m = step(state, data, key)
            states.append(multi.np_tree(state))
            metrics.append(multi.np_tree(m))
        batches = [multi.reference_batches(k, frames, TRAIN["n_rand"]) for k in keys]
        return {"states": states, "metrics": metrics, "batches": batches}

    with ThreadPoolExecutor(2) as pool:
        a, b = pool.submit(sharded), pool.submit(multi_sharded)
        return a.result(), b.result()


def _compare(tag, ref, got, metric_keys):
    """Rank 0's steps against the reference's; returns the worst loss rtol,
    parameter difference, share within 1e-5 and relative norm."""
    worst = [0.0, 0.0, 1.0, 0.0]
    for i, (gm, gstate) in enumerate(got):
        rm, rstate = ref["metrics"][i], ref["states"][i + 1]
        for k in metric_keys:
            np.testing.assert_allclose(gm[k], float(rm[k]), rtol=1e-5, err_msg=f"{tag} {k} {i}")
            worst[0] = max(worst[0], abs(gm[k] / float(rm[k]) - 1))
        d = multi.param_diffs(gstate, rstate)
        ref_norm = np.linalg.norm(np.concatenate(
            [x.ravel() for x in jax.tree_util.tree_leaves(rstate["params"])]))
        assert d.max() <= 2 * (2 * LR) * 2, (tag, i, d.max())
        assert (d <= 1e-5).mean() >= 0.99, (tag, i, (d <= 1e-5).mean())
        for name, o in rstate["opt"].items():
            assert int(gstate["opt"][name]["t"]) == int(o["t"]), (tag, name)
        assert int(gstate["step"]) == int(rstate["step"])
        worst[1:] = (max(worst[1], d.max()), min(worst[2], (d <= 1e-5).mean()),
                     max(worst[3], np.linalg.norm(d) / ref_norm))
    return worst


def test_four_ranks_match_reference(tmp_path):
    procs = _launch(tmp_path)
    deadline = time.time() + TIMEOUT
    try:
        ds = make_synthetic_dataset(n_frames=8, H=H, W=W, n_samples_gt=16)
        scenes = [dataclasses.replace(make_synthetic_dataset(
            n_frames=8, H=H, W=W, n_samples_gt=16, seed=seed), speak_frames=speak)
            for seed, speak in ((0, multi.SPEAK[0]), (5, multi.SPEAK[1]))]
        sharded, multi_run = _reference_runs(ds, scenes)
        _sharded_configs()[1].save(str(tmp_path / "sharded.json"))
        multi.configs()[1].save(str(tmp_path / "multi.json"))
        inputs = {"ds": multi.to_port(ds), "scenes": [multi.to_port(d) for d in scenes],
                  "sharded_states": sharded["states"][:-1],
                  "sharded_batches": sharded["batches"],
                  "multi_states": multi_run["states"][:-1],
                  "multi_batches": multi_run["batches"]}
        with open(tmp_path / "inputs.tmp", "wb") as f:
            pickle.dump(inputs, f)
        os.replace(tmp_path / "inputs.tmp", tmp_path / "inputs.pkl")
    finally:
        _wait(procs, deadline)
    outs = []
    for rank in range(WORLD):
        with open(tmp_path / f"out{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    # every rank ends every step with rank 0's metrics and state, bit for bit
    for rank, out in enumerate(outs[1:], 1):
        for kind in ("sharded", "multi"):
            for (m0, s0), (m, s) in zip(outs[0][kind], out[kind]):
                assert m == m0, (rank, kind)
                f0, f = (jax.tree_util.tree_flatten_with_path(x)[0] for x in (s0, s))
                assert [p for p, _ in f] == [p for p, _ in f0]
                for (p, a), (_, b) in zip(f0, f):
                    assert np.array_equal(a, b), (rank, kind, p)
    a = _compare("sharded", sharded, outs[0]["sharded"],
                 ("loss", "loss_head", "loss_com", "psnr_head", "psnr_com", "lr"))
    b = _compare("multi", multi_run, outs[0]["multi"],
                 ("loss", "loss_obj0", "loss_obj1", "psnr_com_obj0", "psnr_com_obj1"))
    print(f"[parallel] rank 0 vs the reference: sharded {a}, multi {b} (loss rtol, max "
          "parameter difference, share within 1e-5, relative norm)")


def test_sharded_step_reproduces_the_reference_quirks(tmp_path, world1):
    """The signals are encoded outside the gradient: the audio, expression
    and attention nets keep their parameters while their counters advance;
    the depths are [n_rand / W, S]."""
    _, tcfg = _sharded_configs()
    tcfg = dataclasses.replace(tcfg, signal=dataclasses.replace(tcfg.signal, nosmo_iters=0,
                                                                noexp_iters=0))
    tds = multi.to_port(make_synthetic_dataset(n_frames=8, H=H, W=W, n_samples_gt=16))
    from dfanerf_torch.compat.from_jax import state_from_jax
    from dfanerf_torch.train.step import dataset_to_device

    tree = multi.initial_state()
    tree["z_shape"], tree["z_app"] = tree["z_shape"][:2], tree["z_app"][:2]
    state = state_from_jax(tree, tcfg, device="cpu")
    before = {k: v.clone() for k, v in state["params"].state_dict().items()}
    step = make_sharded_train_step(tcfg, tds, world1)
    batch = step.draw_batch(torch.Generator().manual_seed(0))
    assert batch["z_vals"].shape == (TRAIN["n_rand"], N_SAMPLES)  # W = 1
    state, m = step.step_on_batch(state, dataset_to_device(tds, "cpu"), batch)
    assert "grad_norm" not in m
    after = state["params"].state_dict()
    for k, v in before.items():
        assert k.startswith("decoder.") or torch.equal(after[k], v), k
    assert not torch.equal(after["decoder.fc_in.weight"], before["decoder.fc_in.weight"])
    assert all(o["t"] == 1 for o in state["opt"].values())


@pytest.fixture(scope="module")
def world1():
    """A process group of one rank (gloo) and its flat mesh."""
    from dfanerf_torch.parallel import make_mesh

    assert initialize(f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0, device="cpu")
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_initialize_without_a_job_and_the_flat_mesh(monkeypatch, world1):
    """initialize() does nothing without torchrun's environment; with one
    node the pod mesh is the flat ('rays',) mesh, over which the two-hop
    all-reduce is one hop."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    pod = make_pod_mesh()
    assert pod.mesh_dim_names == ("rays",) and pod.size() == 1
    assert shard_index(pod) == (0, 1)
    t = torch.arange(4.0)
    assert torch.equal(hierarchical_all_reduce(t.clone(), pod), t)
    with pytest.raises(ValueError, match="divide"):
        make_pod_mesh(dcn_axis_size=3)


def test_frame_position_clamps_to_the_last_speaking_frame(world1):
    """n_train = len(ds.i_train) positions index the speaking frames; past
    their end JAX's gather under jit clamps to the last one, and so does
    the port."""
    _, tcfg = _sharded_configs()
    speak = np.array([1, 0, 1, 0, 0, 0, 1, 1], np.int32)  # speaking training frames: 0, 2
    ds = dataclasses.replace(make_synthetic_dataset(n_frames=8, H=H, W=W, n_samples_gt=16),
                             speak_frames=speak)
    step = make_sharded_train_step(tcfg, multi.to_port(ds), world1)
    speaking = j_dataset_to_device(ds)["i_train"]
    assert np.asarray(speaking).tolist() == [0, 2] and step.n_train == 6
    gather = jax.jit(lambda a, i: a[i])
    got = [step.frame(pos) for pos in range(step.n_train)]
    assert got == [int(gather(speaking, jnp.int32(pos))) for pos in range(step.n_train)]
    assert got == [0, 2, 2, 2, 2, 2]
    g = torch.Generator().manual_seed(4)
    frames = [step.draw_batch(g)["img_i"] for _ in range(60)]
    assert set(frames) == {0, 2} and frames.count(2) > 2 * frames.count(0)


def test_compute_speaker_ids_matches_reference():
    rng = np.random.RandomState(3)
    speak = [rng.randint(0, 2, 50) for _ in range(4)] + [np.ones(50, np.int32)]
    got, ref = compute_speaker_ids(speak), j_compute_speaker_ids(speak)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert set(np.concatenate(got)) == {-1, 0, 1}
