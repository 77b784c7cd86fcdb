"""Photometric 3DMM refinement and its splat (ops/splat.py,
pipeline/photometric.py, face3dmm.py forward_geo / forward_tex) on the
CPU against the reference package, on the same synthetic 3DMM (the
reference's seeded bases, copied) and the forward-facing vertex sheet of
tests/test_photometric.py, at 32x32.

Bars: within 1e-5 (relative to each output's largest magnitude where that
exceeds 1) for the geometry, the texture, the splat's images and its
gradients, the photometric loss and its gradients, and one refinement
step from the reference's initial state. The splat's sums run in another
order here (index_add against XLA's scatter), so images agree to float32
rounding; where a rigid move precedes the splat, its normalised images are
held on covered pixels (below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_photometric import _mesh_setup

from dfanerf_tpu.pipeline import photometric as jp
from dfanerf_tpu.pipeline.face3dmm import forward_geo as j_geo
from dfanerf_tpu.pipeline.face3dmm import forward_tex as j_tex
from dfanerf_tpu.pipeline.face3dmm import make_synthetic_3dmm as j_synthetic
from dfanerf_torch.pipeline import face3dmm as tf
from dfanerf_torch.pipeline import photometric as tp

TOL = 1e-5
H = W = 32
FOCAL, CXY = 40.0, (W / 2.0, H / 2.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: small tensors, six suite workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=TOL * scale, rtol=0, err_msg=what)


def _port_model(m):
    return tf.Face3DMM(**{k: torch.from_numpy(np.array(getattr(m, k))) for k in (
        "base_id", "base_exp", "mu", "base_tex", "mu_tex", "sig_id", "sig_exp", "sig_tex")},
        lands_info=np.asarray(m.lands_info))


@pytest.fixture(scope="module")
def mesh():
    model, tris, vert_tris = _mesh_setup()
    return model, _port_model(model), np.array(tris), np.array(vert_tris)


def _frames(model, n):
    """n frames of the sheet 3 units in front of the camera, with a target
    texture and lighting, as the reference's refinement test makes them."""
    rng = np.random.RandomState(0)
    exp = (rng.randn(n, model.base_exp.shape[0]) * 0.1).astype(np.float32)
    euler = (rng.randn(n, 3) * 0.05).astype(np.float32)
    trans = np.tile(np.array([[0.0, 0.0, -3.0]], np.float32), (n, 1)) + (
        rng.randn(n, 3) * 0.02).astype(np.float32)
    tex = (rng.randn(model.base_tex.shape[0]) * 0.3).astype(np.float32)
    light = np.zeros((9, 3), np.float32)
    light[0], light[2] = 60.0, 20.0
    return exp, euler, trans, tex, light


def test_forward_geo_and_tex_match_reference():
    m = j_synthetic(jax.random.PRNGKey(5), point_num=200)
    t = _port_model(m)
    rng = np.random.RandomState(1)
    idp, exp, tex = (rng.randn(3, k).astype(np.float32) for k in (20, 12, 8))
    _close(tf.forward_geo(t, torch.from_numpy(idp), torch.from_numpy(exp)).numpy(),
           j_geo(m, jnp.asarray(idp), jnp.asarray(exp)), "geo")
    _close(tf.forward_tex(t, torch.from_numpy(tex)).numpy(), j_tex(m, jnp.asarray(tex)), "tex")


def test_splat_and_its_gradients_match_reference():
    from dfanerf_tpu.ops.splat import render_geometry_points as j_render
    from dfanerf_tpu.ops.splat import splat_points as j_splat
    from dfanerf_torch.ops.splat import render_geometry_points, splat_points

    rng = np.random.RandomState(2)
    pts = np.concatenate([rng.uniform(-1, 1, (300, 2)), rng.uniform(-3.5, -2.5, (300, 1))],
                         1).astype(np.float32)
    pts[:5, :2] = 3.0  # off the image: clipped indices, zero weight
    cols = rng.rand(300, 3).astype(np.float32)
    ref = jax.jit(lambda p, c: j_splat(p, c, FOCAL, CXY, (H, W)))(jnp.asarray(pts),
                                                                  jnp.asarray(cols))
    got = splat_points(torch.from_numpy(pts), torch.from_numpy(cols), FOCAL, CXY, (H, W))
    for g, r, name in zip(got, ref, ("color", "depth", "weight")):
        _close(g.numpy(), r, name)

    def j_loss(p, c):
        col, dep, wt = j_splat(p, c, FOCAL, CXY, (H, W))
        return jnp.sum(col * wt[..., None]) + 0.1 * jnp.sum(dep * wt)

    gp, gc = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(pts), jnp.asarray(cols))
    p_t, c_t = (torch.from_numpy(x).requires_grad_(True) for x in (pts, cols))
    col, dep, wt = splat_points(p_t, c_t, FOCAL, CXY, (H, W))
    (col * wt[..., None]).sum().add(0.1 * (dep * wt).sum()).backward()
    _close(p_t.grad.numpy(), gp, "d/dpts")
    _close(c_t.grad.numpy(), gc, "d/dcolors")

    euler, trans = np.array([0.05, -0.1, 0.02], np.float32), np.array([0, 0, 0.2], np.float32)
    ref = jax.jit(lambda *a: j_render(*a, FOCAL, CXY, (H, W)))(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(euler), jnp.asarray(trans))
    got = render_geometry_points(torch.from_numpy(pts), torch.from_numpy(cols),
                                 torch.from_numpy(euler), torch.from_numpy(trans), FOCAL, CXY,
                                 (H, W))
    # the rigid move's 3x3 product rounds differently in the two packages,
    # which shifts each point's bilinear weights by ~1e-6: the weighted sums
    # hold the bar, the normalised images where the weight is that of a
    # covered pixel (the photometric loss's weight > 1e-4)
    (col, dep, wt), (r_col, r_dep, r_wt) = (g.numpy() for g in got), (np.asarray(r) for r in ref)
    _close(wt, r_wt, "weight")
    _close(col * wt[..., None], r_col * r_wt[..., None], "color x weight")
    _close(dep * wt, r_dep * r_wt, "depth x weight")
    covered = r_wt > 1e-4
    assert covered.sum() > 100
    _close(col[covered], r_col[covered], "color where covered")
    _close(dep[covered], r_dep[covered], "depth where covered")


def test_photometric_loss_and_gradients_match_reference(mesh):
    jm, tm, tris, vert_tris = mesh
    exp, euler, trans, tex, light = _frames(jm, 2)
    idp = np.zeros(jm.base_id.shape[0], np.float32)
    rng = np.random.RandomState(3)
    images = (rng.rand(2, H, W, 3) * 255).astype(np.float32)
    lands = (rng.rand(2, 64, 2) * W).astype(np.float32)
    # the pieces
    geo = np.array(j_geo(jm, jnp.asarray(idp[None]), jnp.asarray(exp[:1])))[0]
    _close(tp.compute_tri_normal(torch.from_numpy(geo), torch.from_numpy(tris)).numpy(),
           jp.compute_tri_normal(jnp.asarray(geo), jnp.asarray(tris)), "normals")
    n = rng.randn(50, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    _close(tp.sh9_basis(torch.from_numpy(n)).numpy(), jp.sh9_basis(jnp.asarray(n)), "sh9")
    pts = rng.randn(50, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tp.vertex_visibility(torch.from_numpy(pts), torch.from_numpy(n)).numpy(),
        np.asarray(jp.vertex_visibility(jnp.asarray(pts), jnp.asarray(n))))

    def j_total(tex_p, light_p, euler_p, trans_p):
        def frame(f):
            pl = jp.photometric_loss(jm, jnp.asarray(tris), jnp.asarray(vert_tris),
                                     jnp.asarray(idp), jnp.asarray(exp[f]), tex_p, light_p,
                                     euler_p[f], trans_p[f], FOCAL, CXY, jnp.asarray(images[f]),
                                     jnp.asarray(lands[f]))
            return pl.color, pl.landmark
        c, l_ = zip(*(frame(f) for f in range(2)))
        return jnp.mean(jnp.stack(c) + jnp.stack(l_)), (jnp.stack(c), jnp.stack(l_))

    args = [jnp.asarray(x) for x in (tex, light, euler, trans)]
    (ref_total, (ref_c, ref_l)), ref_g = jax.jit(jax.value_and_grad(
        j_total, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (tex, light, euler, trans)]
    out = tp.photometric_losses(tm, torch.from_numpy(tris), torch.from_numpy(vert_tris),
                                torch.from_numpy(idp), torch.from_numpy(exp), *leaves, FOCAL, CXY,
                                torch.from_numpy(images), torch.from_numpy(lands))
    total = (out.color + out.landmark).mean()
    total.backward()
    assert float(out.color.detach().min()) > 0 and float(out.landmark.detach().min()) > 0
    _close(out.color.detach().numpy(), ref_c, "color")
    _close(out.landmark.detach().numpy(), ref_l, "landmark")
    _close(total.detach().numpy(), ref_total, "total")
    for leaf, g, name in zip(leaves, ref_g, ("tex", "light", "euler", "trans")):
        _close(leaf.grad.numpy(), g, f"d/d{name}")
    one = tp.photometric_loss(tm, torch.from_numpy(tris), torch.from_numpy(vert_tris),
                              torch.from_numpy(idp), torch.from_numpy(exp[1]),
                              *(torch.from_numpy(x) for x in (tex, light, euler[1], trans[1])),
                              FOCAL, CXY, torch.from_numpy(images[1]))
    _close(one.color.numpy(), ref_c[1], "one frame")
    assert float(one.landmark) == 0.0


def test_refinement_step_matches_reference(mesh):
    """One Adam step of refine_photometric from the reference's initial state
    (texture 0, light 3.0 on the constant term), on frames rendered from a
    target texture and lighting: the loss before the step and every
    parameter after it. Back-facing vertices sit at depth 1e3 and nothing
    turns NaN."""
    jm, tm, tris, vert_tris = mesh
    exp, euler, trans, tex, light = _frames(jm, 3)
    idp = np.zeros(jm.base_id.shape[0], np.float32)
    images = np.stack([np.asarray(jp.splat_points(
        jp.rot_trans_pts(j_geo(jm, jnp.asarray(idp[None]), jnp.asarray(exp[f:f + 1])),
                         jp.euler2rot(jnp.asarray(euler[f:f + 1])), jnp.asarray(trans[f:f + 1]))[0],
        j_tex(jm, jnp.asarray(tex[None]))[0] * 100.0, FOCAL, CXY, (H, W))[0])
        for f in range(3)])
    euler0 = euler + 0.02
    ref = jp.refine_photometric(jm, jnp.asarray(tris), jnp.asarray(vert_tris), jnp.asarray(idp),
                                jnp.asarray(exp), jnp.asarray(euler0), jnp.asarray(trans),
                                FOCAL, CXY, jnp.asarray(images), n_iters=1, lr=1e-2)
    got = tp.refine_photometric(tm, tris, vert_tris, torch.from_numpy(idp), torch.from_numpy(exp),
                                euler0, trans, FOCAL, CXY, torch.from_numpy(images), n_iters=1,
                                lr=1e-2)
    for k in ("loss", "tex", "light", "euler", "trans"):
        _close(got[k].numpy(), ref[k], k)
    assert np.isfinite(float(got["loss"])) and float(got["loss"]) > 0
