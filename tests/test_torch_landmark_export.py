"""The port's landmark export (dfanerf_torch/compat/landmark_export.py)
against the reference's tool (tools/export_landmark_model.py, imported as
tests/test_export_tool.py imports it), on the CPU.

From the same seeded checkpoint both write the same header and the same
array names with the same bits, for each of the tool's seven architectures
but pose_hrnet (the reference's tool converts it with the face head's
layout and fails; the port reads the head off the keys). The port loads
the reference tool's npz: from a checkpoint, its net's state dict equals
the checkpoint's bit for bit; from the reference's seeded init, its
forward matches the reference's apply (rtol 1e-4 / atol 1e-5). The port's
own random export reads back to its seeded net."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dfanerf_torch.compat import landmark_export as lx
from dfanerf_torch.models.perception.common import seeded_init_
from dfanerf_tpu.models.perception import ghostnet_eye as jey
from dfanerf_tpu.models.perception import u2net as ju2
from torch_zoo_parity import nchw, one_thread  # noqa: F401  (the module's fixture)

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import export_landmark_model as ex  # noqa: E402

# arch -> kwargs of both tools (the reference's converter and init take them too)
ARCHS = {"hrnet": {}, "eye": {}, "mobilenet": {}, "u2net": {"out_ch": 3, "small": True},
         "face_ghostnet": {"addition_encoder": 2, "addition_decoder": True},
         "shufflenet": {"preset": "x0.5"}}


def _members(path):
    """name -> array, or "object" for an object member (never unpickled)."""
    header, _ = lx.read_npz(path)
    out = {}
    with np.load(path, allow_pickle=False) as data:
        import zipfile

        with zipfile.ZipFile(path) as zf:
            for name in data.files:
                out[name] = "object" if lx._holds_objects(zf, f"{name}.npy") else data[name]
    return header, out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("lms")
    out = {}
    for i, (arch, kw) in enumerate(ARCHS.items()):
        net = seeded_init_(lx.ARCHS[arch].seeded(kw), 20 + i)
        path = str(d / f"{arch}.pth")
        torch.save(net.state_dict(), path)
        out[arch] = (path, net.state_dict(), d)
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_same_npz_as_the_reference_tool(checkpoints, arch):
    path, _, d = checkpoints[arch]
    ref_path, port_path = str(d / f"{arch}_ref.npz"), str(d / f"{arch}_port.npz")
    ex.export(arch, path, ref_path, **ARCHS[arch])
    lx.export(arch, path, port_path, **ARCHS[arch])
    (h_ref, ref), (h_port, port) = _members(ref_path), _members(port_path)
    assert h_port == h_ref
    assert set(port) == set(ref)
    for name, want in ref.items():
        got = port[name]
        if isinstance(want, str):
            assert got == "object", name
        else:
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert np.array_equal(got, want), name
    with np.load(ref_path, allow_pickle=False) as data:
        assert json.loads(bytes(data["__header__"]).decode())["arch"] == arch


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_loads_the_reference_tools_npz(checkpoints, arch):
    path, sd, d = checkpoints[arch]
    ref_path = str(d / f"{arch}_ref_load.npz")
    ex.export(arch, path, ref_path, **ARCHS[arch])
    header, net = lx.load_exported(ref_path, device="cpu")
    assert header["arch"] == arch and not net.training
    got = net.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())


@torch.no_grad()
def test_port_loads_the_reference_tools_random_export(tmp_path, monkeypatch):
    """The reference's seeded init (not a converted checkpoint), eye and
    U^2-Net small: the port's forward on it against the reference's. The
    tool's inits are jitted here (the same draws; eager, they compile op by
    op for a minute)."""
    monkeypatch.setattr(jey, "init_eye_net", jax.jit(jey.init_eye_net))
    monkeypatch.setattr(ju2, "init_u2net", jax.jit(ju2.init_u2net,
                                                   static_argnames=("out_ch", "small")))
    for arch, kw, init, apply, shape in (
            ("eye", {}, jey.init_eye_net, jey.apply_eye_net, (1, 32, 48, 1)),
            ("u2net", {"out_ch": 3, "small": True},
             lambda k: ju2.init_u2net(k, out_ch=3, small=True),
             lambda p, x: ju2.apply_u2net(p, x, small=True)[0], (1, 32, 32, 3))):
        out = str(tmp_path / f"{arch}.npz")
        ex.export(arch, "random:7", out, **kw)
        _, net = lx.load_exported(out, device="cpu")
        x = np.random.RandomState(8).randn(*shape).astype(np.float32)
        want = np.asarray(jax.jit(apply)(init(jax.random.PRNGKey(7)), x))
        got = net(nchw(x))
        got = (got[0] if isinstance(got, tuple) else got).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["pose_hrnet", "shufflenet"])
def test_port_random_export_reads_back(tmp_path, arch):
    out = str(tmp_path / f"{arch}.npz")
    lx.main([arch, "random:3", out])
    header, net = lx.load_exported(out, device="cpu")
    want = seeded_init_(lx.ARCHS[arch].seeded({}), 3).state_dict()
    assert header == {"arch": arch, "module": lx.ARCHS[arch].module,
                      "n_arrays": header["n_arrays"], "kwargs": {}}
    got = net.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())


def test_load_exported_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the check is for machines without one")
    out = str(tmp_path / "eye.npz")
    lx.export("eye", "random:0", out)
    with pytest.raises(RuntimeError):
        lx.load_exported(out)
