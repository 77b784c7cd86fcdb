"""The port's configs and parameter bridge against the reference package:
every dataclass has the same fields and defaults, the shipped JSON configs
load into both packages alike, and a reference train state converts into
the port's modules and back bit for bit."""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

import dfanerf_tpu.config as jcfg
import dfanerf_torch.config as tcfg
from dfanerf_tpu.train import init_train_state as jax_init_train_state
from dfanerf_torch.compat.from_jax import params_to_state_dict, state_dict_to_params, state_from_jax
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.train.state import Params, init_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["RenderConfig", "SignalConfig", "TrainConfig",
                                  "ExperimentConfig", "DecoderConfig"])
def test_dataclass_defaults_equal(name):
    """Same field names, order and defaults (exact)."""
    j = getattr(jcfg, name)() if name != "DecoderConfig" else jcfg.DecoderConfig()
    t = getattr(tcfg, name)() if name != "DecoderConfig" else DecoderConfig()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))))
def test_json_configs_load_into_both(path):
    j = jcfg.ExperimentConfig.from_json(path)
    t = tcfg.ExperimentConfig.from_json(path)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.fixture(scope="module")
def js():
    """A reference train state as numpy arrays (optimizer moments dropped)."""
    state = jax_init_train_state(jax.random.PRNGKey(0), jcfg.ExperimentConfig())
    return jax.tree.map(np.asarray, {k: state[k] for k in ("params", "z_shape", "z_app", "step")})


def test_train_state_round_trip_bit_exact(js):
    """JAX params -> state dict -> the port's Params -> back: every leaf
    bit-equal, and the module tree holds exactly the converted keys."""
    st = state_from_jax(js, tcfg.ExperimentConfig(), device="cpu")
    back = state_dict_to_params(st["params"].state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(js["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], leaf)
    np.testing.assert_array_equal(st["z_shape"].numpy(), js["z_shape"])
    np.testing.assert_array_equal(st["z_app"].numpy(), js["z_app"])
    assert st["step"] == 0


def test_linear_and_conv_layouts(js):
    """Linear w [in, out] -> weight [out, in]; conv1d HIO [k, in, out] ->
    weight [out, in, k]."""
    sd = params_to_state_dict(js["params"])
    np.testing.assert_array_equal(sd["decoder.fc_in.weight"].numpy(),
                                  js["params"]["decoder"]["fc_in"]["w"].T)
    np.testing.assert_array_equal(sd["audattnet.conv1.weight"].numpy(),
                                  js["params"]["audattnet"]["conv1"]["w"].transpose(2, 1, 0))


def test_port_init_has_reference_shapes(js):
    """The port's own seeded init (used where there is no JAX) has every
    parameter of the reference tree, with the same shapes."""
    ref = {k: tuple(v.shape) for k, v in params_to_state_dict(js["params"]).items()}
    st = init_train_state(tcfg.ExperimentConfig(), seed=0, device="cpu")
    got = {k: tuple(v.shape) for k, v in st["params"].state_dict().items()}
    assert got == ref
    assert st["z_shape"].shape == (2, 256) and st["z_app"].shape == (2, 256)
    again = init_train_state(tcfg.ExperimentConfig(), seed=0, device="cpu")["params"].state_dict()
    for k, v in st["params"].state_dict().items():
        assert torch.equal(v, again[k])
    assert isinstance(st["params"], Params)
