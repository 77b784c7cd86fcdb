"""The harness of the port's model-zoo parity tests (tests/test_torch_zoo_*.py,
tests/test_torch_raft_basic.py), after tests/test_torch_perception.py.

A ``Case`` names the port's net, the reference's converter from a torch
state dict (``to_jax``) or, for a family the reference only initialises,
its init (``init``), the port's inverse (``from_jax``), the reference's
apply and the input shape (NHWC). ``build`` seeds each port net
(``seeded_init_``), takes its state dict and the reference's tree of it
(or the reference's seeded init tree), draws numpy-seeded inputs and runs
the reference's jitted applies in a thread pool, once per file.
``check_round_trip``: port state dict -> reference ``*_from_torch`` ->
port ``*_state_dict_from_jax`` gives the same keys and bits.
``check_forward``: the port's net loaded from the tree's state dict
against the reference's output at rtol 1e-4 / atol 1e-5 (float32); the
outputs named in ``scaled`` (raw regressions, flow in pixels) at atol
1e-5 times their largest magnitude, as tests/test_torch_perception.py
holds BlazeFace's boxes and RAFT's flow.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import numpy as np
import pytest
import torch

from dfanerf_torch.models.perception.common import seeded_init_

RTOL, ATOL = 1e-4, 1e-5


class Case(NamedTuple):
    make: Callable[[], torch.nn.Module]
    to_jax: Optional[Callable[[Any], Any]]
    from_jax: Callable[[Any], dict]
    apply: Callable[[Any, Any], Any]
    shape: Tuple[int, ...]
    scaled: Tuple[str, ...] = ()
    init: Optional[Callable[[Any], Any]] = None


def np_tree(t):
    """The reference's tree with numpy leaves (strings and None kept)."""
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return t if t is None or isinstance(t, str) else np.asarray(t)


def arrays_only(t):
    """The tree without its string leaves (block kinds no apply reads), so
    that jit takes it."""
    if isinstance(t, dict):
        return {k: arrays_only(v) for k, v in t.items() if not isinstance(v, str)}
    if isinstance(t, (list, tuple)):
        return [arrays_only(v) for v in t]
    return t


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for the module: its inputs are small, and the
    intra-op threads of six suite workers on a few cores cost more than
    they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(name: str, shape) -> np.ndarray:
    return np.random.RandomState(sum(map(ord, name))).randn(*shape).astype(np.float32)


def build(cases, seed0: int, make_inputs=inputs) -> dict:
    """Each case's seeded state dict, reference tree, inputs and reference
    output (the applies compiled and run in threads)."""
    setup = {}
    for i, (name, c) in enumerate(cases.items()):
        s = {"x": make_inputs(name, c.shape)}
        if c.to_jax is not None:
            net = seeded_init_(c.make(), seed0 + i).eval()
            s["sd"] = {k: v.clone() for k, v in net.state_dict().items()}
            s["tree"] = np_tree(c.to_jax(s["sd"]))
        else:
            s["tree"] = np_tree(jax.jit(lambda k, c=c: arrays_only(c.init(k)))(
                jax.random.PRNGKey(seed0 + i)))
        setup[name] = s

    def run_ref(name):
        s = setup[name]
        out = jax.jit(cases[name].apply)(arrays_only(s["tree"]), s["x"])
        return name, jax.tree.map(np.asarray, out)

    with concurrent.futures.ThreadPoolExecutor(len(setup)) as pool:
        for name, out in pool.map(run_ref, setup):
            setup[name]["ref"] = out
    return setup


def check_round_trip(case: Case, s: dict) -> None:
    back = case.from_jax(s["tree"])
    assert set(back) == set(s["sd"]), set(back) ^ set(s["sd"])
    for k, v in s["sd"].items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def port_net(case: Case, s: dict) -> torch.nn.Module:
    net = case.make()
    net.load_state_dict(case.from_jax(s["tree"]))
    return net.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    x = torch.from_numpy(x)
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def _leaves(out, prefix=""):
    """(name, array) pairs of an output: dicts by key, sequences by index,
    4-d maps in NHWC."""
    if isinstance(out, dict):
        return [p for k in sorted(out) for p in _leaves(out[k], k)]
    if isinstance(out, (list, tuple)):
        return [p for i, v in enumerate(out) for p in _leaves(v, f"{prefix}[{i}]")]
    if torch.is_tensor(out):
        out = out.detach().numpy()
        out = out.transpose(0, 2, 3, 1) if out.ndim == 4 else out
    return [(prefix, np.asarray(out))]


def check_close(got, want, scaled=()) -> None:
    g, w = _leaves(got), _leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(1.0, float(np.abs(b).max())) if name.split("[")[0] in scaled else 1.0
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * scale, err_msg=name)


@torch.no_grad()
def check_forward(case: Case, s: dict) -> None:
    check_close(port_net(case, s)(nchw(s["x"])), s["ref"], case.scaled)
