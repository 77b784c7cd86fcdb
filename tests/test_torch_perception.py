"""The perception nets of the preprocessing DAG against the reference on the
CPU: BlazeFace, the HRNet landmark net (narrow, and its pose variant), the
GhostNet eye net, the BiSeNet face parser, RAFT-small and the distangler.

Each net's seeded state dict goes through the reference's ``*_from_torch``
and back through the port's ``*_state_dict_from_jax`` bit for bit; then the
port's forward on the converted weights matches the reference's jitted
apply on the same numpy-seeded inputs at rtol 1e-4 / atol 1e-5 (float32).
BlazeFace's raw box regressions (in pixels of its 128x128 input, |x| up to
~95 on seeded weights) and RAFT's flow (in pixels, x8 upsampled) are held
at rtol 1e-4 and atol 1e-5 times the output's largest magnitude: their
float32 summation-order noise is ~1e-6 of that scale, more than 1e-5 in
absolute terms where an element nears zero (ROADMAP.md queue 3).
The reference's applies compile once, in threads, for the whole file.
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from dfanerf_torch.models.perception import bisenet as pbs
from dfanerf_torch.models.perception import blazeface as pbf
from dfanerf_torch.models.perception import ghostnet_eye as pey
from dfanerf_torch.models.perception import hrnet as phr
from dfanerf_torch.models.perception import raft as prf
from dfanerf_torch.models.perception.common import seeded_init_
from dfanerf_torch.pipeline import disentangle as pds
from dfanerf_tpu.models.perception import bisenet as jbs
from dfanerf_tpu.models.perception import blazeface as jbf
from dfanerf_tpu.models.perception import ghostnet_eye as jey
from dfanerf_tpu.models.perception import hrnet as jhr
from dfanerf_tpu.models.perception import raft as jrf
from dfanerf_tpu.pipeline import disentangle as jds

RTOL, ATOL = 1e-4, 1e-5
NARROW = phr.HRNetConfig(stage2=(1, 2, (1, 1), (8, 16)), stage3=(1, 3, (1, 1, 1), (8, 16, 32)),
                         stage4=(2, 4, (1, 2, 1, 1), (8, 16, 32, 64)))
NARROW_POSE = phr.HRNetConfig(**{**NARROW.__dict__, "head": "pose", "up_mode": "nearest",
                                 "final_conv_kernel": 3})
RAFT_ITERS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its inputs are small, and the
    intra-op threads of six suite workers on a few cores cost more than they
    save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return None if t is None else np.asarray(t)


def _jax_apply(name):
    """name -> (reference apply on (params, x), inputs in NHWC)."""
    return {
        "blazeface": jbf.apply_blazeface,
        "hrnet": functools.partial(jhr.apply_hrnet, cfg=jhr.HRNetConfig()),
        "hrnet_pose": functools.partial(jhr.apply_hrnet, cfg=jhr.pose_hrnet_config(
            final_conv_kernel=3)),
        "eye": jey.apply_eye_net,
        "bisenet": jbs.apply_bisenet,
        "raft": lambda p, x: jrf.apply_raft_small(p, x[0], x[1], RAFT_ITERS),
        "distangler": jds.apply_distangler,
    }[name]


# name: (port net, reference converter, port inverse, input shape NHWC)
NETS = {
    "blazeface": (pbf.BlazeFace, jbf.blazeface_from_torch, pbf.blazeface_state_dict_from_jax,
                  (2, 128, 128, 3)),
    "hrnet": (lambda: phr.HRNet(NARROW), lambda sd: jhr.hrnet_from_torch(sd, NARROW),
              phr.hrnet_state_dict_from_jax, (2, 64, 64, 3)),
    "hrnet_pose": (lambda: phr.HRNet(NARROW_POSE),
                   lambda sd: jhr.hrnet_from_torch(sd, NARROW_POSE),
                   phr.hrnet_state_dict_from_jax, (2, 64, 64, 3)),
    "eye": (pey.EyeNet, jey.eye_net_from_torch, pey.eye_net_state_dict_from_jax, (2, 32, 48, 1)),
    "bisenet": (pbs.BiSeNet, jbs.bisenet_from_torch, pbs.bisenet_state_dict_from_jax,
                (2, 64, 64, 3)),
    "raft": (prf.RAFTSmall, jrf.raft_small_from_torch, prf.raft_small_state_dict_from_jax,
             (2, 1, 64, 64, 3)),
    "distangler": (pds.Distangler, jds.distangler_from_torch,
                   pds.distangler_state_dict_from_jax, (5, 79)),
}


def _inputs(name, shape):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "raft":
        base = rng.uniform(0, 255, shape[1:]).astype(np.float32)
        moved = np.roll(base, (1, 2), axis=(1, 2)) + rng.uniform(-5, 5, shape[1:]).astype(
            np.float32)
        return np.stack([base, moved])
    if name == "blazeface":  # its input domain: image / 127.5 - 1
        return rng.uniform(-1, 1, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """Each net: seeded state dict, its reference tree, inputs, and the
    reference's output (compiled and run in threads)."""
    setup = {}
    for i, (name, (make, to_jax, _, shape)) in enumerate(NETS.items()):
        net = seeded_init_(make(), 10 + i).eval()
        sd = {k: v.clone() for k, v in net.state_dict().items()}
        setup[name] = {"net": net, "sd": sd, "tree": _np_tree(to_jax(sd)),
                       "x": _inputs(name, shape)}

    def run_ref(name):
        s = setup[name]
        out = jax.jit(_jax_apply(name))(s["tree"], s["x"])
        return name, jax.tree.map(np.asarray, out)

    with concurrent.futures.ThreadPoolExecutor(len(setup)) as pool:
        for name, out in pool.map(run_ref, setup):
            setup[name]["ref"] = out
    return setup


@pytest.mark.parametrize("name", list(NETS))
def test_state_dict_round_trip(nets, name):
    """port state dict -> reference *_from_torch -> port *_state_dict_from_jax
    gives the same keys and the same bits."""
    s = nets[name]
    back = NETS[name][2](s["tree"])
    assert set(back) == set(s["sd"])
    for k, v in s["sd"].items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _close_scaled(got, want):
    """atol in units of the output's scale (outputs in pixels)."""
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * max(1.0, np.abs(want).max()))


@torch.no_grad()
def _port_net(name, s):
    """The port's net loaded from the state dict the reference's tree gives back."""
    net = NETS[name][0]()
    net.load_state_dict(NETS[name][2](s["tree"]))
    return net.eval()


@torch.no_grad()
def test_blazeface_forward(nets):
    s = nets["blazeface"]
    boxes, scores = _port_net("blazeface", s)(_nchw(s["x"]))
    _close_scaled(boxes.numpy(), s["ref"][0])
    _close_scaled(scores.numpy(), s["ref"][1])


@pytest.mark.parametrize("name", ["hrnet", "hrnet_pose"])
@torch.no_grad()
def test_hrnet_forward(nets, name):
    s = nets[name]
    net = _port_net(name, s)
    assert phr.hrnet_config_from_state_dict(net.state_dict()) == net.cfg
    _close(net(_nchw(s["x"])).permute(0, 2, 3, 1).numpy(), s["ref"])


@torch.no_grad()
def test_eye_net_forward(nets):
    s = nets["eye"]
    out = _port_net("eye", s)(_nchw(s["x"]))
    assert out.shape == (2, 6, 16, 24)
    _close(out.permute(0, 2, 3, 1).numpy(), s["ref"])


@torch.no_grad()
def test_bisenet_forward(nets):
    s = nets["bisenet"]
    outs = _port_net("bisenet", s)(_nchw(s["x"]))
    for got, want in zip(outs, s["ref"]):
        _close(got.permute(0, 2, 3, 1).numpy(), want)


@torch.no_grad()
def test_raft_forward(nets):
    """3 iterations on 64x64 images: the pyramid's last level is one pixel."""
    s = nets["raft"]
    flow, feat = _port_net("raft", s)(_nchw(s["x"][0]), _nchw(s["x"][1]), RAFT_ITERS)
    _close_scaled(flow.permute(0, 2, 3, 1).numpy(), s["ref"][0])
    _close(feat.permute(0, 2, 3, 1).numpy(), s["ref"][1])


@torch.no_grad()
def test_distangler_forward(nets):
    s = nets["distangler"]
    o, m = _port_net("distangler", s)(torch.from_numpy(s["x"]))
    _close(o.numpy(), s["ref"][0])
    _close(m.numpy(), s["ref"][1])
