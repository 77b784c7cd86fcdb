"""The render kernel's epilogue mode and single-field variants, and the
background catch-all, in the port (plain PyTorch versions, on the CPU)
against the reference package (Pallas interpret mode), on the same packed
weights and rays:

- ``fused_render_rays(..., bg_epilogue=True, fields=f)`` for f in both /
  head / torso, with per-field flags that have gaps and an all-zero tile,
  ERT on, and n = 600 (not a multiple of the 256-ray tile). Bars as
  tests/test_torch_fused_render.py (max 2e-4, mean 1.5e-6; measured at most
  7.4e-5 max, 2.4e-7 mean over the three variants);
- the port's epilogue mode against its in-kernel background concat with
  every flag set, at sigma biases 1.0 and -10 (float32 weights), with the
  bars of tests/test_ops.py:184-217: head 2e-5 (measured 0), composite 1e-3
  (measured 4.2e-4: the torso's far-plane colour through the sin/cos PE of
  ``packed_field`` against the kernel's fused sine);
- ``_bg_epilogue``, ``fused_far_eval`` and ``bg_epilogue_fused``, bars as
  tests/test_torch_far_eval.py (3e-4 max, 2e-6 mean; measured at most 1.8e-4
  max, 8.7e-7 mean, the relu far-plane density); the joint plain version is ``far_eval_reference``
  exactly, and so equals the split form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_tpu.ops.pack import pack_field_weights as j_pack
from dfanerf_torch.ops.composite import _bg_epilogue
from dfanerf_torch.ops.far_eval import (
    bg_epilogue_fused, far_eval_reference, far_joint_kernel, fused_far_eval, fused_far_eval_split,
)
from dfanerf_torch.ops.fused_render import (
    fused_render_rays, fused_render_rays_reference, prepare_render_operands, render_rays_kernel,
    view_bias,
)

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
N = 600
S = 32
RENDER_BARS = (2e-4, 1.5e-6)
FAR_BARS = (3e-4, 2e-6)
# per-field flags [2, T, J]: gaps, a tile with no flag (tile 1), and slabs
# that only one field occupies
FLAGS = np.array([[[1, 0, 1, 0], [0, 0, 0, 0], [0, 1, 0, 1]],
                  [[1, 0, 0, 0], [0, 0, 0, 0], [0, 0, 1, 1]]], np.int32)


def _to_torch(pw):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its plain versions run many
    small products, and the intra-op threads of six suite workers on a few
    cores cost more than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda k: init_decoder(k, JDecoderConfig()))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(4)
    vecs = [jnp.asarray(rng.randn(k).astype(np.float32)) for k in (96, 42, 256, 256)]

    def rays():
        return ((rng.randn(N, 3) * 0.05).astype(np.float32),
                (rng.randn(N, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32))

    return {"params": params, "vecs": vecs, "rays": (*rays(), *rays()),
            "bc": rng.rand(N, 3).astype(np.float32), "z": jnp.linspace(0.3, 0.9, S)}


def _packs(params, vecs, dtype):
    sh, st, zs, za = vecs
    return (j_pack(params, JDecoderConfig(), sh, zs, za, "head", dtype),
            j_pack(params, JDecoderConfig(), st, zs, za, "torso", dtype))


def _with_bias(params, bias):
    params = dict(params)
    params["sigma_out"] = {"w": params["sigma_out"]["w"], "b": jnp.full((1,), bias)}
    return params


def _port_args(setup, pw_h, pw_t):
    return (_to_torch(pw_h), _to_torch(pw_t), *(torch.from_numpy(r) for r in setup["rays"]),
            torch.tensor(np.asarray(setup["z"])), torch.from_numpy(setup["bc"]))


def _check(got, ref, bars):
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g).all()
        err = np.abs(g - r)
        assert err.max() < bars[0] and err.mean() < bars[1], (err.max(), err.mean())


@pytest.mark.parametrize("fields", ["both", "head", "torso"])
def test_epilogue_variants_match_interpret_kernel(setup, fields):
    pw_h, pw_t = _packs(setup["params"], setup["vecs"], jnp.bfloat16)
    kw = dict(ert_eps=1e-4, bg_epilogue=True, fields=fields)
    ref = jf.fused_render_rays(pw_h, pw_t, *(jnp.asarray(r) for r in setup["rays"]), setup["z"],
                               jnp.asarray(setup["bc"]), interpret=True,
                               occupancy=jnp.asarray(FLAGS), **kw)
    got = fused_render_rays(*_port_args(setup, pw_h, pw_t), occupancy=torch.from_numpy(FLAGS),
                            **kw)
    _check([g.numpy() for g in got], ref, RENDER_BARS)


def test_all_zero_tile_runs_no_slab(setup):
    """In epilogue mode a tile without flags runs no slab: accumulators 0
    and transmittances 1, exactly; the other tiles run their flagged slabs,
    the last one unforced. A left-out field runs on no slab either."""
    pw_h, pw_t = _packs(setup["params"], setup["vecs"], jnp.bfloat16)
    args = _port_args(setup, pw_h, pw_t)
    for fields in ("both", "head", "torso"):
        ops = prepare_render_operands(*args, ert_eps=0.0, occupancy=torch.from_numpy(FLAGS),
                                      bg_epilogue=True, fields=fields)
        acc_h, acc_c, slabs, t_h, t_c = fused_render_rays_reference(ops)
        assert slabs.tolist() == [2, 0, 3]  # the joint flags' slabs of each tile
        tile = slice(256, 512)
        assert not acc_h[tile].any() and not acc_c[tile].any()
        assert bool((t_h[tile] == 1).all() and (t_c[tile] == 1).all())
        assert float(ops.dists_h[-1].abs().max()) == float(ops.dists_t[-1].abs().max()) == 0.0


@pytest.mark.parametrize("sigma_bias", [1.0, -10.0])
def test_epilogue_matches_kernel_mode(setup, sigma_bias):
    """With every flag set, the per-ray epilogue reproduces the in-kernel
    background concat (the reference's own check of the two modes)."""
    pw_h, pw_t = _packs(_with_bias(setup["params"], sigma_bias), setup["vecs"], jnp.float32)
    args = _port_args(setup, pw_h, pw_t)
    ones = torch.ones((2, 3, S // 8), dtype=torch.int32)
    h0, c0 = fused_render_rays(*args)
    h1, c1 = fused_render_rays(*args, occupancy=ones, bg_epilogue=True)
    assert float((h1 - h0).abs().max()) < 2e-5
    assert float((c1 - c0).abs().max()) < 1e-3


def _epilogue_inputs(setup):
    rng = np.random.RandomState(5)
    acc = [rng.rand(N, 3).astype(np.float32) * 0.5 for _ in range(2)]
    trans = [rng.rand(N, 1).astype(np.float32) for _ in range(2)]
    return acc, trans


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_bg_epilogue_matches_reference(setup, act):
    pw_h, pw_t = _packs(setup["params"], setup["vecs"], jnp.bfloat16)
    acc, trans = _epilogue_inputs(setup)
    ref = jf._bg_epilogue(pw_h, pw_t, *(jnp.asarray(r) for r in setup["rays"]), setup["z"],
                          jnp.asarray(setup["bc"]), 1e10, *(jnp.asarray(x) for x in acc + trans),
                          act=act)
    got = _bg_epilogue(*_port_args(setup, pw_h, pw_t), 1e10,
                       *(torch.from_numpy(x) for x in acc + trans), act=act)
    _check([g.numpy() for g in got], ref, FAR_BARS)


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_fused_far_eval_matches_reference(setup, act):
    pw_h, pw_t = _packs(setup["params"], setup["vecs"], jnp.bfloat16)
    far = float(np.asarray(setup["z"])[-1])
    ref = jf.fused_far_eval(pw_h, pw_t, *(jnp.asarray(r) for r in setup["rays"]),
                            jnp.float32(far), interpret=True, act=act)
    port_args = _port_args(setup, pw_h, pw_t)[:6]
    got = fused_far_eval(*port_args, far, act)
    assert tuple(got[0].shape) == (N, 1) and tuple(got[1].shape) == (N, 3)
    _check([g.numpy() for g in got], ref, FAR_BARS)
    # the joint plain version is far_eval_reference, and equals the split form
    vr_t = view_bias(port_args[1], port_args[5]).to(torch.bfloat16)
    for other in (far_eval_reference(*port_args, far, vr_t, act),
                  fused_far_eval_split(*port_args, far, act)):
        for g, o in zip(got, other):
            assert torch.equal(g, o)


def test_bg_epilogue_fused_matches_reference(setup):
    """As in the reference, the far-plane density is relu'd whatever the
    decoder's activation: bg_epilogue_fused passes no ``act``."""
    pw_h, pw_t = _packs(setup["params"], setup["vecs"], jnp.bfloat16)
    acc, trans = _epilogue_inputs(setup)
    ref = jf.bg_epilogue_fused(pw_h, pw_t, *(jnp.asarray(r) for r in setup["rays"]), setup["z"],
                               jnp.asarray(setup["bc"]), 1e10,
                               *(jnp.asarray(x) for x in acc + trans), interpret=True)
    port = _port_args(setup, pw_h, pw_t)
    tail = (1e10, *(torch.from_numpy(x) for x in acc + trans))
    got = bg_epilogue_fused(*port, *tail)
    _check([g.numpy() for g in got], ref, FAR_BARS)
    relu = _bg_epilogue(*port, *tail, act="relu")
    for g, r in zip(got, relu):
        assert float((g - r).abs().max()) < FAR_BARS[0]


def test_new_kernel_wrappers_refuse_cpu_tensors(setup):
    pw_h, pw_t = _packs(setup["params"], setup["vecs"], jnp.bfloat16)
    args = _port_args(setup, pw_h, pw_t)
    for fields in ("both", "head", "torso"):
        ops = prepare_render_operands(*args, bg_epilogue=True, fields=fields)
        with pytest.raises(ValueError, match="CUDA"):
            render_rays_kernel(ops)
    vr_t = torch.zeros(N, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        far_joint_kernel(*args[:6], 0.9, vr_t)
    assert render_rays_kernel.launches == far_joint_kernel.launches == 0
    assert far_joint_kernel._lib is None
