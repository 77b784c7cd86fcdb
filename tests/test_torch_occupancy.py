"""The port's occupancy flags (dfanerf_torch/ops/occupancy.py, plain
PyTorch) against the reference package's (XLA on the CPU), on the same
packed weights and camera rays.

Layout helpers and the summed-area-table query are integer or copy work and
must be exactly equal. The density-only forward rounds activations to bf16
at the same points; sin and the float32 sums differ in the last bits, which
now and then flips one bf16 activation: node densities differ by up to
4.2e-4 (measured over these cases; bar 1e-3), on densities that span only
+-0.04 for random-init weights. No fixed margin can then separate every
node from the node threshold sigma_thresh / 4 (these grids have no gap
between node densities wider than 2e-3), so each case checks the property
equal flags rest on: every fine node takes the same side of the threshold
in both packages. The flags, built from those decisions by exact integer
work, must then be exactly equal, and each case has set and clear flags."""

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
from dfanerf_torch.ops.fused_render import density_act, pe_freq_phase, pe_replicate

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
NODE_DIFF = 1e-3  # |port - reference| node density (measured 4.2e-4)


@pytest.fixture(scope="module")
def packs():
    params = jax.jit(lambda k: init_decoder(k, JDecoderConfig()))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    sh, st, zs, za = (jnp.asarray(rng.randn(k).astype(np.float32)) for k in (96, 42, 256, 256))
    pw_h = j_pack(params, JDecoderConfig(), sh, zs, za, "head", jnp.bfloat16)
    pw_t = j_pack(params, JDecoderConfig(), st, zs, za, "torso", jnp.bfloat16)
    return pw_h, pw_t


def _to_torch(pw):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}


def _camera(H):
    """Spatial-tile-ordered rays of a camera at z = 0.6 looking down -z
    (tests/test_ops.py TestConservativeOccupancy)."""
    rays_o, rays_d = j_get_rays(H, H, 40.0, jnp.eye(4).at[2, 3].set(0.6))
    perm = jf.spatial_tile_permutation(H, H)
    return np.array(rays_o.reshape(-1, 3)[perm]), np.array(rays_d.reshape(-1, 3)[perm])


def test_pe_replicate_and_freq_phase_equal():
    rays = np.random.RandomState(1).randn(300, 3).astype(np.float32)
    np.testing.assert_array_equal(pe_replicate(torch.from_numpy(rays)).numpy(),
                                  np.asarray(jf.pe_replicate(jnp.asarray(rays))))
    for got, ref in zip(pe_freq_phase(), jf.pe_freq_phase()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tile_corner_rays_equal():
    _, rd = _camera(32)
    np.testing.assert_array_equal(occ_mod.tile_corner_rays(torch.from_numpy(rd)).numpy(),
                                  np.asarray(jf.tile_corner_rays(jnp.asarray(rd))))


def test_sat_box_any_equal():
    rng = np.random.RandomState(2)
    G = 12
    occ = (rng.rand(G, G, G) < 0.05).astype(np.int32)
    sat = np.pad(occ, ((1, 0), (1, 0), (1, 0))).cumsum(0).cumsum(1).cumsum(2).astype(np.int32)
    a = rng.randint(0, G, (50, 7, 3))
    b = rng.randint(0, G, (50, 7, 3))
    i_lo, i_hi = np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(np.int32)
    got = occ_mod._sat_box_any(torch.from_numpy(sat), torch.from_numpy(i_lo),
                               torch.from_numpy(i_hi)).numpy()
    ref = np.asarray(jf._sat_box_any(jnp.asarray(sat), jnp.asarray(i_lo), jnp.asarray(i_hi)))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1


def _fine_nodes(ro, rd, z, grid_res):
    """The fine grid nodes conservative_occupancy samples (supersample 2),
    built as the port builds them."""
    zs = z.reshape(-1, 8)
    z_ends = torch.stack([zs[:, 0], zs[:, -1]], dim=1)
    o_c = occ_mod.tile_corner_rays(ro)
    d_c = occ_mod.tile_corner_rays(rd)
    pts = o_c[:, None, None] + d_c[:, None, None] * z_ends[None, :, :, None, None]
    lo = pts.reshape(-1, 3).amin(0)
    span = torch.clamp_min(pts.reshape(-1, 3).amax(0) - lo, 1e-6)
    g = linspace(0.0, 1.0, 2 * grid_res)
    gz, gy, gx = torch.meshgrid(g, g, g, indexing="ij")
    return lo + torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * span


@pytest.mark.parametrize("H, thresh, act", [(32, 0.13, "relu"), (24, 0.14, "relu"),
                                            (32, 2.83, "softplus")])
def test_conservative_occupancy_flags_equal(packs, H, thresh, act):
    pw_h, pw_t = packs
    ro, rd = _camera(H)
    z = np.array(jnp.linspace(0.3, 0.9, 16))
    ref = np.asarray(jf.conservative_occupancy(pw_h, pw_t, ro, rd, ro, rd, jnp.asarray(z),
                                               thresh, grid_res=16, act=act))
    t_h, t_t = _to_torch(pw_h), _to_torch(pw_t)
    rays = [torch.from_numpy(x) for x in (ro, rd, ro, rd)]
    got = occ_mod.conservative_occupancy(t_h, t_t, *rays, torch.from_numpy(z), thresh,
                                         grid_res=16, act=act).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape == (2, (-(-H // 16)) ** 2, 2)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1, "the case should have both set and clear flags"

    # the density-only forward at the fine grid nodes: close, and every node
    # on the same side of the threshold in both packages
    nodes = _fine_nodes(rays[0], rays[1], torch.from_numpy(z), 16)
    for pw, tw, branch in ((pw_h, t_h, "head"), (pw_t, t_t, "torso")):
        raw = occ_mod.packed_sigma_xla(tw, nodes, branch)
        raw_ref = jf.packed_sigma_xla(pw, jnp.asarray(nodes.numpy()), branch)
        assert np.abs(raw.numpy() - np.asarray(raw_ref)).max() < NODE_DIFF
        on = (density_act(raw, act) > thresh * 0.25).numpy()
        on_ref = np.asarray(jf.density_act(raw_ref, act) > thresh * 0.25)
        np.testing.assert_array_equal(on, on_ref)


@pytest.mark.parametrize("H, thresh, act", [(32, 0.13, "relu"), (32, 2.83, "softplus")])
def test_conservative_occupancy_half_slab_flags_equal(packs, H, thresh, act):
    """occ_pack2's flags: 4 samples per slab, [2, T, S / 4]. The node grid
    spans the same points as at 8 samples per slab (the corner points'
    extremes lie at the first and last sample), so the node-side check is
    the 8-sample one."""
    pw_h, pw_t = packs
    ro, rd = _camera(H)
    z = np.array(jnp.linspace(0.3, 0.9, 16))
    ref = np.asarray(jf.conservative_occupancy(pw_h, pw_t, ro, rd, ro, rd, jnp.asarray(z),
                                               thresh, grid_res=16, act=act, s_slab=4))
    t_h, t_t = _to_torch(pw_h), _to_torch(pw_t)
    rays = [torch.from_numpy(x) for x in (ro, rd, ro, rd)]
    got = occ_mod.conservative_occupancy(t_h, t_t, *rays, torch.from_numpy(z), thresh,
                                         grid_res=16, act=act, s_slab=4).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape == (2, (-(-H // 16)) ** 2, 4)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1, "the case should have both set and clear flags"
    lo, span, _ = occ_mod.occupancy_boxes(*rays, torch.from_numpy(z), 16, s_slab=4)
    lo8, span8, _ = occ_mod.occupancy_boxes(*rays, torch.from_numpy(z), 16)
    assert torch.equal(lo, lo8) and torch.equal(span, span8)
    nodes = _fine_nodes(rays[0], rays[1], torch.from_numpy(z), 16)
    for pw, tw, branch in ((pw_h, t_h, "head"), (pw_t, t_t, "torso")):
        raw = occ_mod.packed_sigma_xla(tw, nodes, branch)
        raw_ref = jf.packed_sigma_xla(pw, jnp.asarray(nodes.numpy()), branch)
        assert np.abs(raw.numpy() - np.asarray(raw_ref)).max() < NODE_DIFF
        on = (density_act(raw, act) > thresh * 0.25).numpy()
        on_ref = np.asarray(jf.density_act(raw_ref, act) > thresh * 0.25)
        np.testing.assert_array_equal(on, on_ref)


# The node-grid kernel (csrc/node_grid.cu) runs only on the card; its
# semantics in plain PyTorch (occupancy.node_grid_rows: its PE as one sin
# over the slot tables, the torso's deformation adding the bf16 PE, its bf16
# rounding points and its point arithmetic) are held here against the plain
# grid the CPU path runs (node_density_reference), on the reference
# package's packed weights and the grid of a camera's (tile, slab) boxes.
@pytest.mark.parametrize("act, thresh", [("relu", 0.13), ("softplus", 2.83)])
@pytest.mark.parametrize("branch", ["head", "torso"])
@pytest.mark.parametrize("grid_res", [8, 16])
def test_node_grid_semantics_match_the_plain_grid(packs, grid_res, branch, act, thresh):
    """Every node density within NODE_DIFF (measured 5.6e-4), and every
    node farther than that from the node threshold on the same side of
    it."""
    pw = _to_torch(packs[0 if branch == "head" else 1])
    ro, rd = (torch.from_numpy(x) for x in _camera(32))
    z = torch.from_numpy(np.array(jnp.linspace(0.3, 0.9, 16)))
    lo, span, _ = occ_mod.occupancy_boxes(ro, rd, ro, rd, z, grid_res)
    gf = grid_res * occ_mod.SUPERSAMPLE
    ref = occ_mod.node_density_reference(pw, branch, lo, span, grid_res, act).reshape(-1)
    got = occ_mod.node_grid_rows(pw, branch, lo, span, grid_res, torch.arange(gf ** 3), act)
    assert got.shape == ref.shape == (gf ** 3,) and got.dtype == torch.float32
    assert float((got - ref).abs().max()) < NODE_DIFF
    thr = thresh * 0.25
    on, on_ref = got > thr, ref > thr
    assert not bool((on != on_ref)[(ref - thr).abs() > NODE_DIFF].any())
    assert 0 < float(on_ref.float().mean()) < 1, "the case should have nodes on both sides"


@pytest.mark.parametrize("branch", ["head", "torso"])
def test_node_density_on_the_cpu_is_the_plain_grid(packs, branch):
    """CPU tensors never reach the kernel: node_density returns the plain
    grid's tensor bit for bit, and launches nothing."""
    pw = _to_torch(packs[0 if branch == "head" else 1])
    ro, rd = (torch.from_numpy(x) for x in _camera(24))
    z = torch.from_numpy(np.array(jnp.linspace(0.3, 0.9, 16)))
    lo, span, _ = occ_mod.occupancy_boxes(ro, rd, ro, rd, z, 8)
    launches = occ_mod.node_grid_kernel.launches
    got = occ_mod.node_density(pw, branch, lo, span, 8, "softplus")
    assert torch.equal(got, occ_mod.node_density_reference(pw, branch, lo, span, 8, "softplus"))
    assert got.shape == (16, 16, 16) and occ_mod.node_grid_kernel.launches == launches
