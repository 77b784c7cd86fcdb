"""The hierarchical render's operations in the port (their plain PyTorch
versions, on the CPU) against the reference package's, run as its own tests
run them: the Pallas kernels in interpret mode, the XLA parts on the CPU.
Same packed weights (JAX init, packed by the reference and converted), same
rays and depths, made with numpy from a seed.

Both sides round the PE and every activation to bf16 at the same points;
sin and the float32 sums differ in the last bits and now and then flip one
bf16 activation. Bars, each about twice or more the largest value measured
over these cases:
- densities (float32, after the activation): max 1e-3 (measured 3.9e-4 on
  densities of a few 1e-2), mean 1e-5; clear slabs exactly 0;
- the fine render's head colour: max 2e-4 and mean 1.5e-6, the bars of
  tests/test_torch_fused_render.py, whose kernel composites the same way;
- the pair buffers' bf16 colours: at most one bf16 ulp apart, in at most 1%
  of the listed entries;
- deferred_composite_head on equal buffers: 1e-6 (XLA's cumprod against
  torch.cumprod);
- occupancy flags: every fine node on the same side of the threshold, then
  the flags exactly equal, with and without the cached summed-area table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.core.rays import get_rays as j_get_rays
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_tpu.ops.pack import pack_field_weights as j_pack
from dfanerf_torch.core.rays import linspace
from dfanerf_torch.ops import occupancy as occ_mod
from dfanerf_torch.ops.composite import deferred_composite_head
from dfanerf_torch.ops.fused_render import density_act
from dfanerf_torch.ops.occupancy import node_grid_kernel
from dfanerf_torch.ops.pair_hier import (
    pair_field_eval_perz, pair_field_perz_kernel, pair_sigma_eval, pair_sigma_kernel,
)
from dfanerf_torch.ops.render_head import (
    fused_render_head, fused_render_head_reference, prepare_head_operands, render_head_kernel,
)
from dfanerf_torch.ops.sigma_head import fused_sigma_head, sigma_head_kernel

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
SIG_MAX, SIG_MEAN = 1e-3, 1e-5
HEAD_MAX, HEAD_MEAN = 2e-4, 1.5e-6
RGB_ULPS, RGB_FRAC = 1.0, 0.01
COMPOSITE = 1e-6
FLAGS = np.array([[1, 0, 1, 1], [0, 1, 0, 1]], np.int32)  # [T, J] with gaps


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda k: init_decoder(k, JDecoderConfig()))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    vecs = [jnp.asarray(rng.randn(k).astype(np.float32)) for k in (96, 256, 256)]
    n = 300
    o = (rng.randn(n, 3) * 0.05).astype(np.float32)
    d = (rng.randn(n, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    z = np.sort(rng.uniform(0.3, 0.9, (n, 32)).astype(np.float32), axis=1)
    return {"params": params, "vecs": vecs, "o": o, "d": d, "z": z,
            "bc": rng.rand(n, 3).astype(np.float32)}


def _pack(setup, params=None):
    return j_pack(params or setup["params"], JDecoderConfig(), *setup["vecs"], "head",
                  jnp.bfloat16)


def _to_torch(pw):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _ulps(a, b):
    """|a - b| in bf16 ulps of b (bf16 has 8 significant bits)."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    return np.abs(a - b) / step


def _check_sigma(got, ref):
    err = np.abs(got - ref)
    assert err.max() < SIG_MAX and err.mean() < SIG_MEAN, (err.max(), err.mean())


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_fused_sigma_head_matches_interpret_kernel(setup, act):
    pw = _pack(setup)
    z = np.asarray(jnp.linspace(0.3, 0.9, 32))
    ref = np.asarray(jf.fused_sigma_head(pw, jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
                                         jnp.asarray(z), interpret=True,
                                         occupancy=jnp.asarray(FLAGS), act=act))
    got = fused_sigma_head(_to_torch(pw), _t(setup["o"]), _t(setup["d"]), _t(z),
                           occupancy=_t(FLAGS), act=act).numpy()
    assert got.shape == ref.shape == (300, 32) and got.dtype == np.float32
    _check_sigma(got, ref)
    clear = np.repeat(np.repeat(FLAGS == 0, 256, axis=0)[:300], 8, axis=1)
    assert (got[clear] == 0).all() and (got[~clear] != 0).mean() > 0.5
    assert sigma_head_kernel.launches == 0


@pytest.mark.parametrize("case", ["per-ray z, flags", "shared z, softplus"])
def test_fused_render_head_matches_interpret_kernel(setup, case):
    pw = _pack(setup)
    if case == "per-ray z, flags":
        z, occ, act = setup["z"], FLAGS, "relu"
    else:
        z, occ, act = np.asarray(jnp.linspace(0.3, 0.9, 32)), None, "softplus"
    ref = np.asarray(jf.fused_render_head(
        pw, jnp.asarray(setup["o"]), jnp.asarray(setup["d"]), jnp.asarray(z),
        jnp.asarray(setup["bc"]), interpret=True, ert_eps=1e-4,
        occupancy=None if occ is None else jnp.asarray(occ), act=act))
    got = fused_render_head(_to_torch(pw), _t(setup["o"]), _t(setup["d"]), _t(z), _t(setup["bc"]),
                            ert_eps=1e-4, occupancy=None if occ is None else _t(occ),
                            act=act).numpy()
    assert got.shape == ref.shape == (300, 3) and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert err.max() < HEAD_MAX and err.mean() < HEAD_MEAN, (err.max(), err.mean())
    assert render_head_kernel.launches == 0


def test_fused_render_head_early_ray_termination(setup):
    """A density-saturating field (sigma bias 200) on per-ray depths: with
    ert_eps=1e-4 tile 0 stops after slab 1 (slab 0 leaves some ray's
    transmittance above 1e-4) and runs the last slab, skipping slab 2; tile
    1 holds padding rays (transmittance 1), so it runs all four. Both
    packages agree on the colours."""
    params = dict(setup["params"])
    params["sigma_out"] = {"w": params["sigma_out"]["w"], "b": jnp.full((1,), 200.0)}
    pw = _pack(setup, params)
    ref = np.asarray(jf.fused_render_head(
        pw, jnp.asarray(setup["o"]), jnp.asarray(setup["d"]), jnp.asarray(setup["z"]),
        jnp.asarray(setup["bc"]), interpret=True, ert_eps=1e-4))
    ops = prepare_head_operands(_to_torch(pw), _t(setup["o"]), _t(setup["d"]), _t(setup["z"]),
                                _t(setup["bc"]), ert_eps=1e-4)
    rgb, slabs = fused_render_head_reference(ops)
    assert slabs.tolist() == [3, 4]
    err = np.abs(rgb[:300].numpy() - ref)
    assert err.max() < HEAD_MAX and err.mean() < HEAD_MEAN, (err.max(), err.mean())


def _listed(J, T, t_i, j_i):
    m = np.zeros((J, 8, T + 1, 256), bool)
    m[j_i, :, t_i, :] = True
    return m.reshape(J, 8, -1)


def _pair_case(setup):
    """Two whole tiles of rays, per-ray sorted depths in the buffers'
    blocking, and the pair list of FLAGS."""
    n = 512
    rng = np.random.RandomState(5)
    o = (rng.randn(n, 3) * 0.05).astype(np.float32)
    d = (rng.randn(n, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    z = np.sort(rng.uniform(0.3, 0.9, (n, 32)).astype(np.float32), axis=1)
    z_buf = np.concatenate([z.reshape(2, 256, 4, 8).transpose(2, 3, 0, 1).reshape(4, 8, n),
                            np.zeros((4, 8, 256), np.float32)], axis=2)
    t_i, j_i = (x.astype(np.int32) for x in np.nonzero(FLAGS))
    return o, d, z, z_buf, t_i, j_i


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_pair_sigma_eval_matches_interpret_kernel(setup, act):
    pw = _pack(setup)
    o, d, _, _, t_i, j_i = _pair_case(setup)
    z = np.asarray(jnp.linspace(0.3, 0.9, 32))
    ref = np.asarray(jf.pair_sigma_eval(pw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                                        jnp.asarray(t_i), jnp.asarray(j_i), interpret=True,
                                        act=act))
    got = pair_sigma_eval(_to_torch(pw), _t(o), _t(d), _t(z), _t(t_i), _t(j_i), act).numpy()
    assert got.shape == ref.shape == (4, 8, 768) and got.dtype == np.float32
    listed = _listed(4, 2, t_i, j_i)
    _check_sigma(got[listed], ref[listed])
    assert np.isnan(got[~listed]).all()
    empty = torch.zeros(0, dtype=torch.int32)
    zero = pair_sigma_eval(_to_torch(pw), _t(o), _t(d), _t(z), empty, empty)
    assert zero.shape == (4, 8, 768) and not zero.any()
    assert pair_sigma_kernel.launches == 0


def test_pair_field_eval_perz_and_composite_match_reference(setup):
    pw = _pack(setup)
    o, d, z, z_buf, t_i, j_i = _pair_case(setup)
    ref = jf.pair_field_eval_perz(pw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z_buf),
                                  jnp.asarray(t_i), jnp.asarray(j_i), interpret=True)
    got = pair_field_eval_perz(_to_torch(pw), _t(o), _t(d), _t(z_buf), _t(t_i), _t(j_i))
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref] == [(4, 8, 768)] * 4
    assert got[0].dtype == torch.float32 and all(g.dtype == torch.bfloat16 for g in got[1:])
    listed = _listed(4, 2, t_i, j_i)
    g_np = [g.float().numpy() for g in got]
    r_np = [np.asarray(r.astype(jnp.float32)) for r in ref]
    _check_sigma(g_np[0][listed], r_np[0][listed])
    for g, r in zip(g_np[1:], r_np[1:]):
        ulps = _ulps(g[listed], r[listed])
        assert ulps.max() <= RGB_ULPS and (ulps > 0).mean() < RGB_FRAC
    assert all(np.isnan(g[~listed]).all() for g in g_np)

    # the head composite over these buffers: the port's (NaN in unlisted
    # blocks) and the reference's, each on its own buffers, and both on the
    # reference's buffers
    diffs = np.concatenate([z[:, 1:] - z[:, :-1], np.zeros((512, 1), np.float32)], axis=1)
    dists = (diffs * np.linalg.norm(d, axis=-1, keepdims=True)).T.copy()
    bc = np.random.RandomState(6).rand(512, 3).astype(np.float32)
    head_ref = np.asarray(jf.deferred_composite_head(ref, jnp.asarray(FLAGS), jnp.asarray(dists),
                                                     jnp.asarray(bc)))
    head_same = deferred_composite_head([_t(np.asarray(r)) if i == 0 else
                                         torch.from_numpy(np.asarray(r.astype(jnp.float32))).to(
                                             torch.bfloat16) for i, r in enumerate(ref)],
                                        _t(FLAGS), _t(dists), _t(bc)).numpy()
    head = deferred_composite_head(got, _t(FLAGS), _t(dists), _t(bc)).numpy()
    assert np.isfinite(head).all()
    assert np.abs(head_same - head_ref).max() < COMPOSITE
    err = np.abs(head - head_ref)
    assert err.max() < HEAD_MAX and err.mean() < HEAD_MEAN, (err.max(), err.mean())
    empty = torch.zeros(0, dtype=torch.int32)
    zeros = pair_field_eval_perz(_to_torch(pw), _t(o), _t(d), _t(z_buf), empty, empty)
    assert all(not b.float().any() for b in zeros)
    assert pair_field_perz_kernel.launches == 0


def _camera(H):
    """Spatial-tile-ordered rays of a camera at z = 0.6 looking down -z
    (tests/test_torch_occupancy.py)."""
    rays_o, rays_d = j_get_rays(H, H, 40.0, jnp.eye(4).at[2, 3].set(0.6))
    perm = jf.spatial_tile_permutation(H, H)
    return np.array(rays_o.reshape(-1, 3)[perm]), np.array(rays_d.reshape(-1, 3)[perm])


@pytest.mark.parametrize("act, thresh", [("relu", 0.095), ("softplus", 2.82)])
def test_occupancy_flags_and_sat_match_reference(setup, act, thresh):
    pw = _pack(setup)
    tw = _to_torch(pw)
    ro, rd = _camera(32)
    n = ro.shape[0]
    rng = np.random.RandomState(7)
    z_c = np.broadcast_to(np.asarray(jnp.linspace(0.3, 0.9, 16)), (n, 16)).copy()
    z_f = np.sort(rng.uniform(0.32, 0.88, (n, 32)).astype(np.float32), axis=1)
    ref_c, cache = jf.occupancy_flags_and_sat(pw, "head", jnp.asarray(ro), jnp.asarray(rd),
                                              jnp.asarray(z_c), thresh, 16, act=act)
    got_c, t_cache = occ_mod.occupancy_flags_and_sat(tw, "head", _t(ro), _t(rd), _t(z_c), thresh,
                                                     16, act=act)
    # the grid: the same extent, and every fine node on the same side of
    # the threshold in both packages
    sat, lo, span = t_cache
    np.testing.assert_array_equal(lo.numpy(), np.asarray(cache[1]))
    np.testing.assert_array_equal(span.numpy(), np.asarray(cache[2]))
    g = linspace(0.0, 1.0, 32)
    gz, gy, gx = torch.meshgrid(g, g, g, indexing="ij")
    nodes = lo + torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * span
    raw = occ_mod.packed_sigma_xla(tw, nodes, "head")
    raw_ref = np.asarray(jf.packed_sigma_xla(pw, jnp.asarray(nodes.numpy()), "head"))
    assert np.abs(raw.numpy() - raw_ref).max() < SIG_MAX
    np.testing.assert_array_equal((density_act(raw, act) > thresh * 0.25).numpy(),
                                  np.asarray(jf.density_act(raw_ref, act) > thresh * 0.25))
    np.testing.assert_array_equal(sat.numpy(), np.asarray(cache[0]))
    # then the flags, coarse and (through the cached table) fine
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    assert got_c.dtype == torch.int32 and 0 < got_c.float().mean() < 1
    ref_f = jf.occupancy_flags_dynamic_z(pw, "head", jnp.asarray(ro), jnp.asarray(rd),
                                         jnp.asarray(z_f), thresh, 16, sat_cache=cache, act=act)
    got_f = occ_mod.occupancy_flags_dynamic_z(tw, "head", _t(ro), _t(rd), _t(z_f), thresh, 16,
                                              sat_cache=t_cache, act=act)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))
    assert got_f.shape == (4, 4) and 0 < got_f.float().mean() < 1


@pytest.mark.parametrize("act, thresh", [("relu", 0.095), ("softplus", 2.82)])
def test_node_grid_semantics_give_the_reference_coarse_flags(setup, act, thresh):
    """The node-grid kernel's semantics (occupancy.node_grid_rows) on the
    coarse pass's grid: every node density within SIG_MAX of the plain
    grid's, every node on the same side of the threshold, and the flags of
    those nodes, through the cached summed-area table, the reference
    package's coarse flags exactly."""
    pw = _pack(setup)
    tw = _to_torch(pw)
    ro, rd = _camera(32)
    z_c = np.broadcast_to(np.asarray(jnp.linspace(0.3, 0.9, 16)), (ro.shape[0], 16)).copy()
    ref_c, _ = jf.occupancy_flags_and_sat(pw, "head", jnp.asarray(ro), jnp.asarray(rd),
                                          jnp.asarray(z_c), thresh, 16, act=act)
    _, (_, lo, span) = occ_mod.occupancy_flags_and_sat(tw, "head", _t(ro), _t(rd), _t(z_c),
                                                       thresh, 16, act=act)
    plain = occ_mod.node_density_reference(tw, "head", lo, span, 16, act)
    got = occ_mod.node_grid_rows(tw, "head", lo, span, 16, torch.arange(32 ** 3), act)
    assert float((got - plain.reshape(-1)).abs().max()) < SIG_MAX
    on = (got > thresh * 0.25).reshape(32, 32, 32)
    assert torch.equal(on, plain > thresh * 0.25)
    flags, _ = occ_mod.occupancy_flags_and_sat(tw, "head", _t(ro), _t(rd), _t(z_c), thresh, 16,
                                               (occ_mod._occupancy_sat(on), lo, span), act)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(ref_c))
    assert 0 < flags.float().mean() < 1


def test_wrappers_refuse_what_the_kernels_cannot_serve(setup):
    """CPU tensors never reach a kernel; bad shapes raise."""
    pw = _to_torch(_pack(setup))
    o, d, _, z_buf, t_i, j_i = _pair_case(setup)
    z = torch.linspace(0.3, 0.9, 32)
    ti, ji = _t(t_i), _t(j_i)
    occ = torch.ones((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sigma_head_kernel(pw, _t(o), _t(d), z, occ)
    with pytest.raises(ValueError, match="CUDA"):
        render_head_kernel(prepare_head_operands(pw, _t(o), _t(d), z, _t(o)))
    with pytest.raises(ValueError, match="CUDA"):
        pair_sigma_kernel(pw, _t(o), _t(d), z, ti, ji)
    with pytest.raises(ValueError, match="CUDA"):
        pair_field_perz_kernel(pw, _t(o), _t(d), torch.zeros(512, 256, dtype=torch.bfloat16),
                               _t(z_buf), ti, ji)
    with pytest.raises(ValueError, match="whole"):
        pair_sigma_eval(pw, _t(o)[:300], _t(d)[:300], z, ti, ji)
    with pytest.raises(ValueError, match="z_buf"):
        pair_field_eval_perz(pw, _t(o), _t(d), _t(z_buf)[:, :, :512], ti, ji)
    with pytest.raises(ValueError, match="multiple"):
        fused_sigma_head(pw, _t(o), _t(d), z[:30])
    lo, span = torch.zeros(3), torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        node_grid_kernel(pw, "head", lo, span, 8)
    with pytest.raises(ValueError, match="activation"):
        node_grid_kernel(pw, "head", lo, span, 8, act="gelu")
    with pytest.raises(ValueError, match="activation"):
        occ_mod.node_density(pw, "head", lo, span, 8, act="gelu")
    with pytest.raises(ValueError, match="branch"):
        occ_mod.node_density(pw, "face", lo, span, 8)
    with pytest.raises(ValueError, match="fine nodes"):
        node_grid_kernel(pw, "head", lo, span, 1000)
    for k in (sigma_head_kernel, render_head_kernel, pair_sigma_kernel, pair_field_perz_kernel,
              node_grid_kernel):
        assert k.launches == 0
