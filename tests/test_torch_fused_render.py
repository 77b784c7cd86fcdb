"""The port's fused_render_rays (its plain PyTorch version, on the CPU)
against the reference package's fused_render_rays run in Pallas interpret
mode, on the same packed weights and rays.

Both sides follow the same bf16 rounding points and fp32 recurrences; the
differences left are float32 summation order in the products and ulp-level
differences in sin/exp, which flip an occasional bf16 rounding. The bars
are about twice the largest error measured over these cases: max 1.01e-4
(one ray of the saturating-field case, where the first sample carries the
whole ray and one flipped bf16 rounding shows undiluted; 7.5e-6 in the
other cases), mean 9.0e-7. They are far inside tests/test_ops.py:97-99
(head max 2e-2, head mean 2e-3, composite mean 5e-3). The kernel holds the
width at 256, so the decoder is full width here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.ops.fused_render import fused_render_rays as j_fused_render_rays
from dfanerf_tpu.ops.pack import pack_field_weights as j_pack
from dfanerf_torch.ops.fused_render import (
    fused_render_rays, fused_render_rays_reference, prepare_render_operands,
)

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
MAX_ERR = 2e-4
MEAN_ERR = 1.5e-6


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
    rng = np.random.RandomState(0)
    n = 300

    def rays():
        o = (rng.randn(n, 3) * 0.05).astype(np.float32)
        d = (rng.randn(n, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
        return o, d

    ro, rd = rays()
    ro_t, rd_t = rays()
    vecs = [rng.randn(k).astype(np.float32) for k in (96, 42, 256, 256)]
    return {"params": params, "rays": (ro, rd, ro_t, rd_t),
            "bc": rng.rand(n, 3).astype(np.float32), "vecs": vecs}


def _packs(params, vecs, dtype):
    sh, st, zs, za = (jnp.asarray(v) for v in vecs)
    pw_h = j_pack(params, JDecoderConfig(), sh, zs, za, "head", dtype)
    pw_t = j_pack(params, JDecoderConfig(), st, zs, za, "torso", dtype)
    return pw_h, pw_t


def _to_torch(pw):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}


def _inputs(setup, dtype, n, S, params):
    pw_h, pw_t = _packs(params or setup["params"], setup["vecs"], dtype)
    return pw_h, pw_t, [r[:n] for r in setup["rays"]], setup["bc"][:n], jnp.linspace(0.3, 0.9, S)


def _port(setup, dtype, n, S, params=None, occupancy=None, **kw):
    pw_h, pw_t, rays, bc, z = _inputs(setup, dtype, n, S, params)
    h, c = fused_render_rays(
        _to_torch(pw_h), _to_torch(pw_t), *(torch.from_numpy(r) for r in rays),
        torch.tensor(np.asarray(z)), torch.from_numpy(bc),
        occupancy=None if occupancy is None else torch.from_numpy(occupancy), **kw)
    return h.numpy(), c.numpy()


def _run_both(setup, dtype, n, S, params=None, occupancy=None, **kw):
    pw_h, pw_t, rays, bc, z = _inputs(setup, dtype, n, S, params)
    h_j, c_j = j_fused_render_rays(
        pw_h, pw_t, *(jnp.asarray(r) for r in rays), z, jnp.asarray(bc), interpret=True,
        occupancy=None if occupancy is None else jnp.asarray(occupancy), **kw)
    return _port(setup, dtype, n, S, params, occupancy, **kw), (np.asarray(h_j), np.asarray(c_j))


def _check(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.isfinite(g).all()
        err = np.abs(g - r)
        assert err.max() < MAX_ERR, err.max()
        assert err.mean() < MEAN_ERR, err.mean()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_matches_interpret_kernel(setup, dtype):
    got, ref = _run_both(setup, dtype, 300, 16)
    _check(got, ref)


def test_softplus_density(setup):
    got, ref = _run_both(setup, jnp.bfloat16, 300, 16, act="softplus")
    _check(got, ref)


def test_occupancy_flags_with_zeros(setup):
    """Flagged-off (tile, slab) pairs are skipped exactly as in the
    reference kernel (the last slab always runs)."""
    occ = np.array([[1, 0, 1, 1], [0, 0, 1, 0]], np.int32)
    got, ref = _run_both(setup, jnp.bfloat16, 300, 32, occupancy=occ)
    _check(got, ref)


def test_early_ray_termination(setup):
    """A density-saturating field (sigma bias 200): with ert_eps=1e-4 the
    middle slabs are skipped on both sides and the results agree."""
    params = jax.tree.map(lambda x: x, setup["params"])
    params["sigma_out"] = {"w": params["sigma_out"]["w"], "b": jnp.full((1,), 200.0)}
    got, ref = _run_both(setup, jnp.bfloat16, 300, 32, params=params, ert_eps=1e-4)
    _check(got, ref)
    # the port's slab count shows the skip: in tile 0 slab 0 and the last
    # slab run and slabs 1-2 are terminated; tile 1 holds padding rays
    # (zero direction, transmittance stays 1), so it runs all four
    pw_h, pw_t = (_to_torch(p) for p in _packs(params, setup["vecs"], jnp.bfloat16))
    rays = [torch.from_numpy(r) for r in setup["rays"]]
    ops = prepare_render_operands(pw_h, pw_t, *rays, torch.tensor(
        np.asarray(jnp.linspace(0.3, 0.9, 32))), torch.from_numpy(setup["bc"]), ert_eps=1e-4)
    _, _, slabs, _, _ = fused_render_rays_reference(ops)
    assert slabs.tolist() == [2, 4]


def test_ragged_ray_count(setup):
    """n = 257 (one ray into the second tile): matches the reference, and the
    padding rays do not leak into real rays (same values as the first 257
    of the n = 300 render, tests/test_ops.py:102-113)."""
    got, ref = _run_both(setup, jnp.bfloat16, 257, 16)
    _check(got, ref)
    full = _port(setup, jnp.bfloat16, 300, 16)
    for g, f in zip(got, full):
        np.testing.assert_allclose(g, f[:257], atol=1e-6)
