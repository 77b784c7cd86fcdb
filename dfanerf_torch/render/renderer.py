"""Full-frame renderer (port of the fused paths of
dfanerf_tpu/render/renderer.py).

``make_frame_renderer`` returns render_frame(params, z_shape, z_app, pose,
pose_torso, signal, signal_torso, bc_img) -> (rgb_head, rgb_com), each
[H, W, 3] float32. Per frame it folds the signals into both fields' weights
(ops/pack.py) and builds the rays, in 16x16 spatial tiles when
``spatial_tiles`` is set or occupancy is on. Then:

- dense (``occ_sigma_thresh == 0``): ``fused_render_rays`` renders every
  (tile, slab) of both fields and the renderer untiles;
- pair-compacted (``occ_sigma_thresh > 0`` with ``occ_pair_compaction``,
  the serving path): each field is evaluated only on its occupied (tile,
  slab) pairs (``pair_field_eval``), the far plane once per ray
  (``fused_far_eval_split``), and ``deferred_composite`` + ``bg_blend``
  composite the union-occupied tiles and the background catch-all. Flags
  are rebuilt every ``occ_refresh_every`` frames (see
  ``_make_pair_compaction_renderer``).

Kernels run on a CUDA device, their plain versions on the CPU. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; without CUDA a
call with no device raises. Not ported yet, each raising
NotImplementedError: the unfused ``render_ray_batch`` path
(``use_fused_kernel=False``), the occupancy paths without pair compaction
(tile classes, tile compaction) and the pair path's further levers (listed
in ``_refuse_unported``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.core.rays import get_rays, linspace
from dfanerf_torch.device import resolve_device
from dfanerf_torch.ops.composite import bg_blend, deferred_composite
from dfanerf_torch.ops.far_eval import fused_far_eval_split
from dfanerf_torch.ops.fused_render import (
    R_T, S_SLAB, fused_render_rays, spatial_tile_permutation, spatial_untile,
)
from dfanerf_torch.ops.occupancy import conservative_occupancy
from dfanerf_torch.ops.pack import pack_field_weights
from dfanerf_torch.ops.pair_field import pair_field_eval
from dfanerf_torch.train.signals import encode_signal, encode_signal_torso


def make_frame_renderer(cfg: ExperimentConfig, hwfcxy, near: float, far: float, device=None):
    """Build the fused frame renderer on ``device`` (default CUDA): dense,
    or pair-compacted when ``occ_sigma_thresh > 0``."""
    dev = resolve_device(device)
    H, W, focal, cx, cy = hwfcxy
    H, W = int(H), int(W)
    rcfg, dcfg = cfg.render, cfg.decoder
    if not rcfg.use_fused_kernel:
        raise NotImplementedError(
            "use_fused_kernel=False (the render_ray_batch path) is not ported yet "
            "(ROADMAP.md queue 1, items 4 and 8)")
    if rcfg.occ_sigma_thresh > 0 and not rcfg.occ_pair_compaction:
        raise NotImplementedError(
            "occ_sigma_thresh > 0 without occ_pair_compaction (the occupancy, tile-class and "
            "tile-compaction paths) is not ported yet (ROADMAP.md queue 1, item 8; queue 2)")
    if not rcfg.concate_bg or rcfg.n_samples % S_SLAB:
        raise ValueError("the fused renderer needs concate_bg and n_samples % 8 == 0")
    if rcfg.occ_sigma_thresh > 0:
        _refuse_unported(rcfg)

    act = dcfg.density_activation
    use_tiles = rcfg.spatial_tiles or rcfg.occ_sigma_thresh > 0
    z_vals_c = linspace(near, far, rcfg.n_samples, device=dev)
    pdt = torch.bfloat16 if rcfg.compute_dtype == "bfloat16" else torch.float32
    if use_tiles:
        # one 16x16 pixel block per ray tile (spatial_tile_permutation owns
        # the layout): tiling gathers pixels by perm, untiling undoes it.
        # Camera-space pixel dirs are built once, so a frame's rays are three
        # broadcast mul-adds (same pixel math as get_rays).
        perm = spatial_tile_permutation(H, W).to(dev)
        _cx = W * 0.5 if cx is None else cx
        _cy = H * 0.5 if cy is None else cy
        ii, jj = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
        dirs = np.stack([(ii - _cx) / focal, -(jj - _cy) / focal,
                         -np.ones_like(ii, np.float32)], axis=-1).astype(np.float32)
        dirs_tiled = torch.from_numpy(dirs.reshape(-1, 3)).to(dev)[perm]

        def tiled_rays(pose):
            R = pose[:3, :3]
            rd = (dirs_tiled[:, 0:1] * R[:, 0][None] + dirs_tiled[:, 1:2] * R[:, 1][None]
                  + dirs_tiled[:, 2:3] * R[:, 2][None])
            return pose[:3, -1].expand(rd.shape).contiguous(), rd

    def untile(v):
        return spatial_untile(v, H, W) if use_tiles else v.reshape(H, W, 3)

    def as_f32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

    @torch.no_grad()
    def frame_inputs(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        """(pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p): both fields' packed
        weights, the rays and the background pixels, in tile order when
        tiling."""
        pose, pose_torso = as_f32(pose), as_f32(pose_torso)
        z_shape, z_app = as_f32(z_shape), as_f32(z_app)
        bc = torch.as_tensor(bc_img).to(dev).float() / 255.0
        if use_tiles:
            ro, rd = tiled_rays(pose)
            ro_t, rd_t = tiled_rays(pose_torso)
            bc_p = bc.reshape(-1, 3)[perm]
        else:
            ro, rd = (x.reshape(-1, 3) for x in get_rays(H, W, focal, pose, cx, cy))
            ro_t, rd_t = (x.reshape(-1, 3) for x in get_rays(H, W, focal, pose_torso, cx, cy))
            bc_p = bc.reshape(-1, 3)
        pw_h = pack_field_weights(params.decoder, as_f32(signal), z_shape[0], z_app[0], "head",
                                  param_dtype=pdt)
        pw_t = pack_field_weights(params.decoder, as_f32(signal_torso), z_shape[1], z_app[1],
                                  "torso", param_dtype=pdt)
        return pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p

    if rcfg.occ_sigma_thresh > 0:
        return _make_pair_compaction_renderer(
            rcfg, act, len(perm) // R_T, z_vals_c, float(np.float32(far)), frame_inputs, untile)

    @torch.no_grad()
    def render_frame(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p = frame_inputs(
            params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img)
        head, com = fused_render_rays(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c, bc_p,
                                      last_dist=rcfg.last_dist, ert_eps=rcfg.ert_eps, act=act)
        return untile(head), untile(com)

    return render_frame


def _refuse_unported(rcfg: RenderConfig) -> None:
    """The pair path's levers that are not ported yet raise, each naming its
    ROADMAP.md item."""
    unported = [
        (rcfg.occ_prune_budget > 0 or rcfg.occ_budget_color or rcfg.occ_budget_iters != 1,
         "the budgeted prune (occ_prune_budget, occ_budget_color, occ_budget_iters)"),
        (rcfg.occ_prune_carry > 0 or rcfg.occ_prune_hist_decay > 0 or rcfg.occ_live_keys,
         "occ_prune_carry, occ_prune_hist_decay and occ_live_keys"),
        (rcfg.occ_async_refresh, "occ_async_refresh (the async refresh worker)"),
        (rcfg.far_skip_tol > 0, "far_skip_tol > 0"),
        (rcfg.far_subsample > 1, "far_subsample > 1"),
        (rcfg.occ_pack2, "occ_pack2 (_pair2_field_kernel)"),
    ]
    for on, what in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md queue 1, item 8)")


def _make_pair_compaction_renderer(rcfg: RenderConfig, act: str, T: int, z_vals_c, far: float,
                                   frame_inputs, untile):
    """The (tile, slab)-pair-compacted serving path (port of the semantics
    of the reference's _make_pair_compaction_renderer, renderer.py :502).

    A refresh frame (the first, then every ``occ_refresh_every``-th) builds
    per-field flags [2, T, J] with ``conservative_occupancy``, copies them to
    the host and derives the pair lists (``set_flags``); it renders under
    these unpruned flags and returns that image. With ``occ_prune_trans`` or
    ``occ_prune_contrib`` set, its composite diagnostics then drop the pairs
    behind saturated opacity or invisible to every stack (``prune_flags``),
    and the following frames render under the pruned lists. A steady frame
    copies nothing to the host: it gathers the union-occupied tiles, runs
    each field's pair kernel over exactly its listed pairs and both
    far-plane kernels over every ray, composites the gathered tiles, scatters
    them back, blends the background catch-all and untiles.

    The reference pads pair lists and tile sets to bucket sizes so that XLA
    compiles few programs; its padding pairs write only a dummy tile row and
    its padding tiles carry zero flags, so the port launches exactly K pairs
    and gathers exactly the union tiles and gets the same images.

    ``render.cache`` holds the flag state: ``lists`` (per field, the pair
    coordinates t_idx, j_idx as int32 device tensors, t in union-tile
    positions), ``tiles_u`` (the union tiles, host int64), ``occ`` ([2, T, J]
    flags in force), ``occ_sub`` (their union-tile rows) and ``age``.
    ``render.inputs_fn`` is the frame-input builder and ``render.run_fast``
    renders a frame under the current flags without advancing the cadence."""
    dev = z_vals_c.device
    J = rcfg.n_samples // S_SLAB
    prune_on = rcfg.occ_prune_trans > 0 or rcfg.occ_prune_contrib > 0
    cache = {"age": 0, "lists": None, "occ": None, "tiles_u": None, "tiles_sel": None,
             "occ_sub": None}

    def occ_fn(inputs):
        pw_h, pw_t, ro, rd, ro_t, rd_t, _ = inputs
        return conservative_occupancy(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c,
                                      rcfg.occ_sigma_thresh, grid_res=rcfg.occ_grid_res, act=act)

    def set_flags(occ_np):
        """Pair lists and union tiles of host flags [2, T, J] (reference
        set_flags :724, without padding). np.nonzero lists a field's pairs
        tile-major, slabs ascending, so consecutive pairs of one tile read
        the same rays."""
        occ_np = np.ascontiguousarray(occ_np, dtype=np.int32)
        tiles_u = np.nonzero(occ_np.max(axis=(0, 2)))[0]
        pos_of = np.zeros(T, np.int32)
        pos_of[tiles_u] = np.arange(len(tiles_u), dtype=np.int32)
        lists = []
        for f in range(2):
            t_i, j_i = np.nonzero(occ_np[f])
            lists.append((torch.from_numpy(pos_of[t_i]).to(dev),
                          torch.from_numpy(j_i.astype(np.int32)).to(dev)))
        cache.update(age=0, lists=lists, occ=torch.from_numpy(occ_np).to(dev), tiles_u=tiles_u,
                     tiles_sel=torch.from_numpy(tiles_u).to(dev),
                     occ_sub=torch.from_numpy(np.ascontiguousarray(occ_np[:, tiles_u])).to(dev))

    def run(inputs, diag: bool = False):
        """One frame under the cached flags; with ``diag`` also the prune
        diagnostics, in union-tile rows."""
        pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p = inputs
        sel = cache["tiles_sel"]

        def gather(x):
            return x.reshape(T, R_T, -1).index_select(0, sel).reshape(-1, x.shape[-1])

        ro_g, rd_g, ro_t_g, rd_t_g = (gather(x) for x in (ro, rd, ro_t, rd_t))
        (ti_h, ji_h), (ti_t, ji_t) = cache["lists"]
        buf_h = pair_field_eval(pw_h, "head", ro_g, rd_g, z_vals_c, ti_h, ji_h, act)
        buf_t = pair_field_eval(pw_t, "torso", ro_t_g, rd_t_g, z_vals_c, ti_t, ji_t, act)
        sh, ct = fused_far_eval_split(pw_h, pw_t, ro, rd, ro_t, rd_t, far, act)
        out = deferred_composite(buf_h, buf_t, cache["occ_sub"], rd_g, rd_t_g, z_vals_c,
                                 with_diagnostics=diag)

        def scatter(x, fill):
            full = x.new_full((T, R_T, x.shape[-1]), fill)
            return full.index_copy_(0, sel, x.reshape(-1, R_T, x.shape[-1])).reshape(T * R_T, -1)

        ah, ac, t_h, t_c = out[:4]
        head, com = bg_blend(sh, ct, rd, rd_t, bc_p, rcfg.last_dist, scatter(ah, 0.0),
                             scatter(ac, 0.0), scatter(t_h, 1.0), scatter(t_c, 1.0))
        imgs = (untile(head), untile(com))
        return (imgs, *out[4:]) if diag else imgs

    def expand_tiles(x_sub):
        """[K_u, J] union-tile diagnostic -> [T, J] on the host, zero off
        the union (reference expand_tiles :831)."""
        full = np.zeros((T, J), np.float32)
        full[cache["tiles_u"]] = x_sub.cpu().numpy()
        return full

    def prune_flags(tm_h, tm_c, cb_h, cb_t):
        """Keep-masks [T, J] from one frame's composite diagnostics: the
        transmittance prune and the contribution prune of the reference's
        prune_flags (:878-883, :929-932)."""
        keep_h = np.ones((T, J), bool)
        keep_t = np.ones((T, J), bool)
        if rcfg.occ_prune_trans > 0:
            eps = rcfg.occ_prune_trans
            tm_h_f, tm_c_f = expand_tiles(tm_h), expand_tiles(tm_c)
            keep_h &= np.maximum(tm_h_f, tm_c_f) > eps
            keep_t &= tm_c_f > eps
        if rcfg.occ_prune_contrib > 0:
            eps = rcfg.occ_prune_contrib
            keep_h &= expand_tiles(cb_h) > eps
            keep_t &= expand_tiles(cb_t) > eps
        return keep_h, keep_t

    @torch.no_grad()
    def render(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        inputs = frame_inputs(params, z_shape, z_app, pose, pose_torso, signal, signal_torso,
                              bc_img)
        if cache["lists"] is not None and cache["age"] < max(rcfg.occ_refresh_every, 1):
            cache["age"] += 1
            return run(inputs)
        occ_np = occ_fn(inputs).cpu().numpy()
        set_flags(occ_np)
        if prune_on:
            imgs, tm_h, tm_c, cb_h, cb_t = run(inputs, diag=True)
            keep_h, keep_t = prune_flags(tm_h, tm_c, cb_h, cb_t)
            set_flags(np.stack([occ_np[0] * keep_h, occ_np[1] * keep_t]))
        else:
            imgs = run(inputs)
        cache["age"] = 1  # this frame consumed the refresh
        return imgs

    @torch.no_grad()
    def run_fast(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        return run(frame_inputs(params, z_shape, z_app, pose, pose_torso, signal, signal_torso,
                                bc_img))

    def refresh_union(*_, **__):
        raise NotImplementedError(
            "refresh_union (the offline per-window flags) is not ported yet "
            "(ROADMAP.md queue 1, item 8)")

    def precompile_headroom(*_, **__):
        raise NotImplementedError(
            "precompile_headroom and occ_class_clamp (the async worker's program classes) are "
            "not ported yet (ROADMAP.md queue 1, item 8)")

    render.cache = cache
    render.inputs_fn = frame_inputs
    render.run_fast = run_fast
    render.refresh_union = refresh_union
    render.precompile_headroom = precompile_headroom
    return render


@torch.no_grad()
def encode_frame_signals(params, auds, exps, poses, img_i: int, n_valid: int,
                         cfg: ExperimentConfig, use_smoothing: bool):
    """Conditioning signals of one frame: (signal [dim_signal],
    signal_torso [dim_et_embed]). auds/exps/poses are tensors on the
    params' device."""
    sig = encode_signal(params, auds, exps, img_i, n_valid, cfg.signal.smo_size,
                        use_smoothing, cfg.signal.audio_net)
    sig_t = encode_signal_torso(params, poses, img_i, n_valid, cfg.signal.smo_torso_size,
                                use_smoothing, cfg.signal.et_multires)
    return sig, sig_t


def render_video_frames(state, data, cfg: ExperimentConfig, hwfcxy, near: float, far: float,
                        frame_indices: Sequence[int], pose_body=None,
                        use_smoothing: bool = True, device=None):
    """Render a sequence of frames with the torso camera pinned to
    ``pose_body`` (the first frame's pose by default). data holds "auds",
    "exps", "poses" and "bc_img". Returns uint8 composite and head-only
    frames, each [T, H, W, 3]."""
    dev = resolve_device(device)
    render = make_frame_renderer(cfg, hwfcxy, near, far, device=dev)
    auds, exps, poses = (torch.as_tensor(data[k]).to(device=dev, dtype=torch.float32)
                         for k in ("auds", "exps", "poses"))
    if pose_body is None:
        pose_body = poses[0]
    out_com, out_head = [], []
    for i in frame_indices:
        sig, sig_t = encode_frame_signals(state["params"], auds, exps, poses, int(i),
                                          auds.shape[0], cfg, use_smoothing)
        rgb_head, rgb_com = render(state["params"], state["z_shape"], state["z_app"], poses[i],
                                   pose_body, sig, sig_t, data["bc_img"])
        out_com.append((rgb_com.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
        out_head.append((rgb_head.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    return np.stack(out_com), np.stack(out_head)

