"""Full-frame renderer (port of dfanerf_tpu/render/renderer.py).

``make_frame_renderer`` returns render_frame(params, z_shape, z_app, pose,
pose_torso, signal, signal_torso, bc_img) -> (rgb_head, rgb_com), each
[H, W, 3] float32. Per frame it folds the signals into both fields' weights
(ops/pack.py) and builds the rays, in 16x16 spatial tiles when
``spatial_tiles`` is set or occupancy is on. Then:

- dense (``occ_sigma_thresh == 0``): ``fused_render_rays`` renders every
  (tile, slab) of both fields and the renderer untiles;
- occupancy (``occ_sigma_thresh > 0``, no pair compaction): per-field flags
  from ``conservative_occupancy``, rebuilt every ``occ_refresh_every``
  frames, skip the empty slabs of ``fused_render_rays`` in its epilogue mode
  (the background catch-all per ray, ``_bg_epilogue``). Without
  ``occ_tile_compaction`` one call covers every tile under the joint flags
  (``_make_occupancy_renderer``); with it, the shipped serving
  configuration (configs/obama_serve_tpu.json), the tiles are split into
  per-field classes, each rendered by its kernel variant
  (``_make_tile_class_renderer``, ``tile_classes``);
- pair-compacted (``occ_sigma_thresh > 0`` with ``occ_pair_compaction``):
  each field is evaluated only on its occupied (tile, slab) pairs
  (``pair_field_eval``; with ``occ_pack2`` on 4-sample half-slabs, two
  pairs per block, ``pair2_field_eval``), the far plane once per ray
  (``fused_far_eval_split``), and ``deferred_composite`` + ``bg_blend``
  composite the union-occupied tiles and the background catch-all. Flags
  are rebuilt every ``occ_refresh_every`` frames, or pinned over a window
  by ``render.refresh_union``; the serving levers of BASELINE config 3
  (the budgeted prune, ``far_skip_tol``, ``far_subsample``,
  ``occ_prune_carry``, and the live ones: ``occ_async_refresh``,
  ``occ_live_keys``, ``occ_prune_hist_decay``) act on this path (see
  ``_make_pair_compaction_renderer``).

With ``use_fused_kernel=False`` both renderers run the unfused field that
training optimises instead: render/fields.py over tiles of ``tile_rays``
rays, in plain PyTorch.

Kernels run on a CUDA device, their plain versions on the CPU. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; without CUDA a
call with no device raises. Not ported: the pair renderer's
``precompile_headroom``, which raises NotImplementedError.

The reference's debug lines, in its formats and only when the variable is
set: ``DFANERF_DEBUG_COMPACTION`` (``[classes]`` at a tile-class refresh;
``[pairs:<tag>]``, ``[pairs:far_skip]``, ``[pairs:iter<n>]`` and
``[pairs:async]`` on the pair path), ``DFANERF_DEBUG_HIER`` (``[hier]`` at
a hierarchical pair refresh) and ``DFANERF_DEBUG_HIER_T`` (``[hier:t]``, the
hierarchical pair frame's stage times, from its spans in event mode).

Spans (dfanerf_torch/spans.py): ``render.signals`` (encode_frame_signals);
``render.frame``, each serving renderer's call, and inside it the stages
``render.inputs`` (weights packed, rays, background), ``occupancy.flags``
(launching the flags), ``occupancy.download`` (the host blocked in a copy
to the host), ``occupancy.lists`` (classes or pair lists built on the host
and uploaded), ``render.gather``, ``render.segment`` (a field or class
kernel's call), ``render.sigma``, ``render.resample``, ``render.fine``,
``render.finish``, ``render.untile``; on the pair path ``render.poll`` (a
finished worker swapped in) and, on the worker's thread,
``worker.refresh``.

Every serving renderer's ``render.cache`` counts its frames (``served``)
and its flag-state installs (``gen``: a synchronous, carried or pinned
refresh, a worker's swap), with ``gen_src``, the index of the served frame
whose inputs built the installed state (the worker's snapshot frame; -1
for ``refresh_union``'s window): host ints, read with no device sync.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import deque
from typing import Sequence

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.core.compositing import calc_volume_weights
from dfanerf_torch.core.rays import get_rays, linspace
from dfanerf_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
from dfanerf_torch.device import resolve_device
from dfanerf_torch.ops._build import worker_launches
from dfanerf_torch.ops.composite import (
    _bg_epilogue, bg_blend, deferred_composite, deferred_composite_head,
)
from dfanerf_torch.ops.far_eval import fused_far_eval_split
from dfanerf_torch.ops.fused_render import (
    R_T, S_SLAB, fused_render_rays, spatial_tile_permutation, spatial_untile,
)
from dfanerf_torch.ops.occupancy import conservative_occupancy, occupancy_flags_and_sat
from dfanerf_torch.ops.pack import pack_field_weights
from dfanerf_torch.ops.pair_field import pair2_field_eval, pair_field_eval
from dfanerf_torch.ops.pair_hier import pair_field_eval_perz, pair_sigma_eval
from dfanerf_torch.ops.render_head import fused_render_head
from dfanerf_torch.ops.sigma_head import fused_sigma_head
from dfanerf_torch.render.fields import render_head_hierarchical, render_ray_batch
from dfanerf_torch.spans import elapsed_ms, span, timed
from dfanerf_torch.train.signals import encode_signal, encode_signal_torso


def budget_drop_masks(wr_h: np.ndarray, wr_t: np.ndarray,
                      cand: np.ndarray, budget: float,
                      base: np.ndarray = None) -> np.ndarray:
    """Greedy budgeted pair-drop decision (RenderConfig.occ_prune_budget;
    a copy of the reference's, renderer.py :27-64, call for call, so the
    same float32 inputs give the same drops bit for bit).

    wr_h/wr_t [J, K, R] — per-ray drop cost of each field's (tile, slab)
    pair on each of the tile's rays: raw compositing mass, or the
    first-order color-error estimate under occ_budget_color (both from
    deferred_composite with_ray_diag); cand [2, K, J] bool — pairs
    eligible to drop. Per tile, candidates from BOTH fields are dropped
    in ascending order of max-ray cost while the ACCUMULATED dropped cost
    on every ray stays <= budget (the greedy prefix over sorted
    candidates — feasibility is monotone in the prefix since costs are
    nonnegative). ``base`` [K, R] seeds each ray's ledger with an already
    realized error. Returns drop [2, K, J] bool, always a subset of cand.
    Pure host-side numpy: K tiles x 2J candidates, vectorized over
    tiles."""
    J = wr_h.shape[0]
    # [K, R, 2J]: both fields in one per-ray ledger
    W = np.concatenate([wr_h.transpose(1, 2, 0),
                        wr_t.transpose(1, 2, 0)], axis=2)
    c = cand.transpose(1, 0, 2).reshape(W.shape[0], 2 * J)
    key = np.where(c, W.max(axis=1), np.inf)  # non-candidates sort last
    Wm = np.where(c[:, None, :], W, 0.0)
    order = np.argsort(key, axis=1)
    Ws = np.take_along_axis(Wm, order[:, None, :], axis=2)
    feas = np.take_along_axis(key, order, axis=1) < np.inf
    cum = Ws.cumsum(axis=2)
    if base is not None:
        cum = cum + base[:, :, None]
    ok = (cum.max(axis=1) <= budget) & feas
    drop_sorted = np.cumprod(ok, axis=1).astype(bool)
    drop = np.zeros_like(ok)
    np.put_along_axis(drop, order, drop_sorted, axis=1)
    return drop.reshape(-1, 2, J).transpose(1, 0, 2)


def make_frame_renderer(cfg: ExperimentConfig, hwfcxy, near: float, far: float, device=None):
    """Build the frame renderer on ``device`` (default CUDA): unfused with
    ``use_fused_kernel=False``; else fused, dense, or with
    ``occ_sigma_thresh > 0`` the occupancy path, its per-field tile classes
    (``occ_tile_compaction``) or the pair-compacted path
    (``occ_pair_compaction``), dispatched as the reference does (:184-205)."""
    dev = resolve_device(device)
    H, W, focal, cx, cy = hwfcxy
    H, W = int(H), int(W)
    rcfg, dcfg = cfg.render, cfg.decoder
    if not rcfg.use_fused_kernel:
        return _make_unfused_frame_renderer(rcfg, hwfcxy, near, far, dev)
    if not rcfg.concate_bg or rcfg.n_samples % S_SLAB:
        raise ValueError("the fused renderer needs concate_bg and n_samples % 8 == 0")

    act = dcfg.density_activation
    use_tiles = rcfg.spatial_tiles or rcfg.occ_sigma_thresh > 0
    z_vals_c = linspace(near, far, rcfg.n_samples, device=dev)
    pdt = torch.bfloat16 if rcfg.compute_dtype == "bfloat16" else torch.float32
    if use_tiles:
        perm = spatial_tile_permutation(H, W).to(dev)
        tiled_rays = _tiled_ray_fn(hwfcxy, perm)

    def untile(v):
        with span("render.untile"):
            return spatial_untile(v, H, W) if use_tiles else v.reshape(H, W, 3)

    def as_f32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

    @torch.no_grad()
    def frame_inputs(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        """(pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p): both fields' packed
        weights, the rays and the background pixels, in tile order when
        tiling."""
        with span("render.inputs"):
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
        T = len(perm) // R_T
        if rcfg.occ_pair_compaction:
            return _make_pair_compaction_renderer(
                rcfg, act, T, z_vals_c, float(np.float32(far)), frame_inputs, untile,
                lambda img: img.reshape(-1, img.shape[-1])[perm])
        if rcfg.occ_tile_compaction:
            return _make_tile_class_renderer(rcfg, act, T, z_vals_c, frame_inputs, untile)
        return _make_occupancy_renderer(rcfg, act, z_vals_c, frame_inputs, untile)

    @torch.no_grad()
    def render_frame(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        with span("render.frame"):
            pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p = frame_inputs(
                params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img)
            with span("render.segment"):
                head, com = fused_render_rays(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c, bc_p,
                                              last_dist=rcfg.last_dist, ert_eps=rcfg.ert_eps,
                                              act=act)
            return untile(head), untile(com)

    return render_frame


def _tile_slices(n: int, tile: int):
    return [slice(a, min(a + tile, n)) for a in range(0, n, tile)]


def _make_unfused_frame_renderer(rcfg: RenderConfig, hwfcxy, near: float, far: float, dev):
    """render_ray_batch over tiles of ``tile_rays`` rays in scanline order
    (reference :459-497), the shared depths uniform. Same call and outputs
    as the fused renderers."""
    H, W, focal, cx, cy = hwfcxy
    H, W = int(H), int(W)
    tile = min(rcfg.tile_rays, H * W)
    z_vals = stratified_z_vals(near, far, tile, rcfg.n_samples, device=dev)

    def as_f32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

    @torch.no_grad()
    def render_frame(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        ro, rd = (x.reshape(-1, 3) for x in get_rays(H, W, focal, as_f32(pose), cx, cy))
        ro_t, rd_t = (x.reshape(-1, 3) for x in get_rays(H, W, focal, as_f32(pose_torso), cx, cy))
        bc = torch.as_tensor(bc_img).to(dev).reshape(-1, 3).float() / 255.0
        z_shape, z_app = as_f32(z_shape), as_f32(z_app)
        signal, signal_torso = as_f32(signal), as_f32(signal_torso)
        heads, coms = [], []
        for sl in _tile_slices(H * W, tile):
            head, com = render_ray_batch(
                params.decoder, rcfg, ro[sl], rd[sl], ro_t[sl], rd_t[sl],
                z_vals[:sl.stop - sl.start], signal, signal_torso, z_shape[0], z_app[0],
                z_shape[1], z_app[1], bc[sl])
            heads.append(head)
            coms.append(com)
        return torch.cat(heads).reshape(H, W, 3), torch.cat(coms).reshape(H, W, 3)

    return render_frame


def _tiled_ray_fn(hwfcxy, perm: torch.Tensor):
    """pose -> (rays_o, rays_d) [len(perm), 3] in spatial-tile order. One
    16x16 pixel block per ray tile (spatial_tile_permutation owns the
    layout): tiling gathers pixels by perm, untiling undoes it. Camera-space
    pixel dirs are built once, so a frame's rays are three broadcast
    mul-adds (same pixel math as get_rays)."""
    H, W, focal, cx, cy = hwfcxy
    H, W = int(H), int(W)
    _cx = W * 0.5 if cx is None else cx
    _cy = H * 0.5 if cy is None else cy
    ii, jj = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    dirs = np.stack([(ii - _cx) / focal, -(jj - _cy) / focal,
                     -np.ones_like(ii, np.float32)], axis=-1).astype(np.float32)
    dirs_tiled = torch.from_numpy(dirs.reshape(-1, 3)).to(perm.device)[perm]

    def tiled_rays(pose):
        R = pose[:3, :3]
        rd = (dirs_tiled[:, 0:1] * R[:, 0][None] + dirs_tiled[:, 1:2] * R[:, 1][None]
              + dirs_tiled[:, 2:3] * R[:, 2][None])
        return pose[:3, -1].expand(rd.shape).contiguous(), rd

    return tiled_rays


# The flag state a per-window slot holds (reference _SLOT_KEYS :935, less
# tiles_scatter: the port scatters by tiles_sel, with no padding rows).
SLOT_KEYS = ("lists", "occ", "tiles_u", "tiles_sel", "occ_sub", "far_skip", "far_cmix_err",
             "lists2", "occ_sub_a", "occ_sub_b")


def far_subgrid(x: torch.Tensor, ss: int) -> torch.Tensor:
    """[T * 256, C] in tile order -> each tile's (16/ss)^2 cell-centre
    subgrid, pixels ss/2 + i*ss in each direction (reference _sub_tiles
    :1049). Returns [T * (16/ss)^2, C]."""
    c = x.shape[-1]
    v = x.reshape(-1, 16, 16, c)[:, ss // 2::ss, ss // 2::ss, :]
    return v.reshape(-1, c)


def far_upsample_matrix(ss: int) -> np.ndarray:
    """[16, 16/ss] float32: row x interpolates the two nearest cell centres
    of ``far_subgrid`` (edge-clamped at the tile border; reference _up_matrix
    :1064)."""
    m = 16 // ss
    centers = (ss // 2 + np.arange(m) * ss).astype(np.float64)
    A = np.zeros((16, m), np.float32)
    for x in range(16):
        i = np.clip(np.searchsorted(centers, x) - 1, 0, m - 2)
        w = np.clip((x - centers[i]) / (centers[i + 1] - centers[i]), 0.0, 1.0) if m > 1 else 0.0
        A[x, i] = 1.0 - w
        A[x, min(i + 1, m - 1)] += w
    return A


def far_upsample(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The bilinear inverse of ``far_subgrid`` with its matrix A [16, m]:
    [T * m^2, C] -> [T * 256, C], separably per axis (reference _up_tiles
    :1078)."""
    m, c = A.shape[1], x.shape[-1]
    v = torch.einsum("xj,tjkc,yk->txyc", A, x.reshape(-1, m, m, c), A)
    return v.reshape(-1, c)


def _make_pair_compaction_renderer(rcfg: RenderConfig, act: str, T: int, z_vals_c, far: float,
                                   frame_inputs, untile, tile_order):
    """The (tile, slab)-pair-compacted serving path (port of the semantics
    of the reference's _make_pair_compaction_renderer, renderer.py :502).

    A refresh frame (the first, then every ``occ_refresh_every``-th) builds
    per-field flags [2, T, J] with ``conservative_occupancy``, copies them to
    the host and derives the pair lists (``set_flags``); it renders under
    these unpruned flags and returns that image. With ``occ_prune_trans``,
    ``occ_prune_contrib`` or ``occ_prune_budget`` set, its composite
    diagnostics then drop pairs (``prune_flags``) and the following frames
    render under the pruned lists. A steady frame copies nothing to the
    host: it gathers the union-occupied tiles, runs each field's pair kernel
    over exactly its listed pairs and both far-plane kernels, composites the
    gathered tiles, scatters them back, blends the background catch-all and
    untiles.

    Two kinds of frame, as in the reference: a frame that builds or measures
    flags (a refresh frame, the diagnostic and verify renders of
    ``refresh_union``) is a pipeline frame (reference run_pipeline :795),
    with the full pair lists and the far plane at every ray; every other
    frame (steady, pinned, ``window_slot``, a carried refresh) is a fast
    frame (reference run_fast :1299), with the packed-2 lists under
    ``occ_pack2`` and the far plane on the ``far_subsample`` subgrid.

    The prunes (reference prune_flags :839):
    - ``occ_prune_trans``: pairs behind saturated opacity (tile-max
      slab-start transmittance) drop;
    - ``occ_prune_budget`` > 0, the budgeted prune, replaces the
      contribution prune: per tile, the occupied pairs the trans prune kept
      drop greedily in ascending order of their largest per-ray cost while
      every ray's summed cost stays within the budget
      (``budget_drop_masks``); the cost is the slab mass, or with
      ``occ_budget_color`` a first-order colour-error estimate
      (``deferred_composite(with_ray_diag=True, ray_err_bc=...)``);
    - otherwise ``occ_prune_contrib``: pairs whose max-ray summed weight is
      at most the threshold drop.

    ``far_skip_tol`` > 0 (with ``last_dist`` >= 1e8, where both far alphas
    are exactly 1): at each refresh the exact largest deviation of the
    composite's far-plane colour from the background pixel is measured
    (``far_cmix_err``); within the tolerance the state's frames skip the far
    plane (``far_skip``) and blend the background pixel instead.
    ``far_subsample`` = ss > 1: fast frames run the far kernels on each
    tile's (16/ss)^2 cell-centre subgrid and upsample bilinearly.
    ``occ_prune_carry`` = c > 0: after a full refresh, the next c refreshes
    are cheap: fresh conservative flags times the carried keep-masks, the
    frame rendered as a fast frame.

    With ``occ_pack2`` a slab is a 4-sample half-slab (sp = 4, J = S / 4):
    the flags are built at that size and a pipeline frame renders the full
    per-field lists with ``pair_field_eval`` at sp = 4. A fast frame
    renders their even/odd split (``lists2``: pairs 0, 2, 4, ... of the
    tile-major list in A, 1, 3, 5, ... in B) with one ``pair2_field_eval``
    per field and composites the A and B quartets under the matching flag
    partitions ``occ_sub_a`` and ``occ_sub_b``.

    The reference pads pair lists and tile sets to bucket sizes so that XLA
    compiles few programs; its padding pairs write only a dummy tile row and
    its padding tiles carry zero flags, so the port launches exactly K pairs
    (A ceil(K/2), B floor(K/2)) and gathers exactly the union tiles and gets
    the same images and prune decisions.

    ``render.cache`` holds the flag state: ``lists`` (per field, the pair
    coordinates t_idx, j_idx as int32 device tensors, t in union-tile
    positions), ``tiles_u`` (the union tiles, host int64), ``occ`` ([2, T, J]
    flags in force), ``occ_sub`` (their union-tile rows), with ``occ_pack2``
    ``lists2`` (per field, tA, jA, tB, jB) and ``occ_sub_a``/``occ_sub_b``,
    ``far_skip`` and ``far_cmix_err``, ``age``, and with pruning ``keeps``
    (the keep-masks of the last full refresh) and ``keep_age``.
    ``render.refresh_union(window_inputs, per_slot=False)`` pins flags built
    over a window of ``render.inputs_fn`` results (the offline mode,
    reference :947): the union of the frames' flags, pruned to every pair
    some frame's composite keeps, after which ``render`` no longer refreshes
    (``cache["pinned"]``); with ``per_slot`` it first builds each frame's
    own pruned state into ``cache["slots"]`` (with the budget, refined over
    ``occ_budget_iters`` rounds, each verified; ``cache["slot_prep"]`` holds
    each slot's pair counts per round and reverted tiles), and
    ``render(..., window_slot=i)`` renders under slot ``i % len(slots)``.
    ``render.inputs_fn`` is the frame-input builder and ``render.run_fast``
    renders a fast frame under the current flags without advancing the
    cadence.

    The live levers (cfg2 of benchmarks/serve_trained.py:313-321):
    - ``occ_prune_hist_decay`` = d > 0: a live refresh's prune reads and
      updates ``cache["hist"]``, running maxima of its keys decayed by d
      (``prune_flags``);
    - ``occ_async_refresh``: after the first (synchronous) refresh, frames
      are served as fast frames under the flags in force while a worker
      thread (``render.worker``: thread, result, error, fails, stream)
      builds the next state from a snapshot of one frame's inputs (the
      occupancy, the far_skip decision and the prune); the next frame that
      finds it finished swaps it in (``cache["swaps"]`` counts them). A
      refresh is due past ``occ_refresh_every`` frames plus a jitter
      ``cache["rjit"]`` cycling 0, 1, 2. On the card the worker runs on a
      stream of its own, waits on an event recorded after the snapshot,
      copies to and from the host through pinned memory and event waits
      (the serving thread copies nothing in a steady frame, and its copies
      elsewhere stay plain, seen by torch's sync debug mode), marks its state
      used by the serving stream, and the swap waits for an event recorded
      after the state, polled, never waited on. Its kernel launches count
      in each binding's ``worker_launches``. A worker failure is
      served stale and retried at the next refresh; the third in a row
      raises;
    - ``occ_live_keys`` (with the worker and a trans or budget prune):
      each fast frame's composite also reports its per-(tile, slab) prune
      keys, kept on the device in ``cache["key_frames"]`` (the last 12,
      each with its union tiles and an event); the worker derives the
      keep-masks from their running max and the history with no
      diagnostic render, except every ``occ_live_remeasure``-th derive
      (``cache["derive_ct"]``), which renders the snapshot under the
      unpruned lists and measures every pair. Pairs never measured
      (``cache["ever_measured"]``) are not dropped by a keys derive.
    - ``occ_class_clamp``: the reference re-pads a fresh state onto a
      program class XLA has compiled, bit for bit the same frames, and its
      worker renders a throwaway frame to compile a class it has not run.
      The port lists exactly K pairs and compiles nothing per class, so
      the clamp changes nothing and the worker renders no throwaway frame
      (whose keys the reference also stashes)."""
    dev = z_vals_c.device
    pack2 = rcfg.occ_pack2
    sp = 4 if pack2 else S_SLAB
    J = rcfg.n_samples // sp
    budget_on = rcfg.occ_prune_budget > 0
    prune_on = rcfg.occ_prune_trans > 0 or rcfg.occ_prune_contrib > 0 or budget_on
    ss = max(int(rcfg.far_subsample), 1)
    if 16 % ss:
        raise ValueError(f"far_subsample={ss} must divide the 16-pixel tile")
    up_A = torch.from_numpy(far_upsample_matrix(ss)).to(dev) if ss > 1 else None
    cache = {"age": 0, "lists": None, "occ": None, "tiles_u": None, "tiles_sel": None,
             "occ_sub": None, "served": 0, "gen": 0, "gen_src": -1}
    cuda = dev.type == "cuda"
    # occ_live_keys: fast frames report their own prune keys, from which the
    # async worker derives keep-masks (reference :1176-1177)
    live_keys = (rcfg.occ_async_refresh and rcfg.occ_live_keys
                 and (rcfg.occ_prune_trans > 0 or budget_on))
    cache_lock = threading.Lock()  # the cache entries both threads touch
    worker = {"thread": None, "result": None, "error": None, "fails": 0, "stream": None}

    def on_worker() -> bool:
        return cuda and torch.cuda.current_stream(dev) == worker["stream"]

    def upload(a: np.ndarray) -> torch.Tensor:
        """A host array on the device; on the refresh worker's stream through
        pinned memory, a copy the host does not wait for (see download)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(dev, non_blocking=True) if on_worker() else t.to(dev)

    def download(*xs: torch.Tensor):
        """Device tensors as host arrays. On the refresh worker's stream:
        copies into pinned memory and one wait on an event recorded after
        them, since the serving thread may be in a steady frame under torch's
        sync debug mode, which is process-wide and flags stream and device
        synchronizes, not event waits. Elsewhere plain copies, which that
        mode sees."""
        with span("occupancy.download"):
            if not on_worker():
                return [x.cpu().numpy() for x in xs]
            outs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
            for o, x in zip(outs, xs):
                o.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            return [o.numpy() for o in outs]

    def occ_fn(inputs):
        pw_h, pw_t, ro, rd, ro_t, rd_t, _ = inputs
        with span("occupancy.flags"):
            return conservative_occupancy(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c,
                                          rcfg.occ_sigma_thresh, grid_res=rcfg.occ_grid_res,
                                          act=act, s_slab=sp)

    def to_dev(x):
        return upload(np.asarray(x, dtype=np.int32))

    def set_flags(occ_np, st=None, tag="flags"):
        """Pair lists and union tiles of host flags [2, T, J] into the state
        ``st`` (default the cache; reference set_flags :724, without
        padding). np.nonzero lists a field's pairs tile-major, slabs
        ascending, so consecutive pairs of one tile read the same rays.
        ``tag`` names the call in DFANERF_DEBUG_COMPACTION's line, as the
        reference's call sites name theirs."""
        st = cache if st is None else st
        occ_np = np.ascontiguousarray(occ_np, dtype=np.int32)
        if os.environ.get("DFANERF_DEBUG_COMPACTION"):
            print(f"[pairs:{tag}] head={int(occ_np[0].sum())} torso={int(occ_np[1].sum())}",
                  flush=True)
        with span("occupancy.lists"):
            tiles_u = np.nonzero(occ_np.max(axis=(0, 2)))[0]
            pos_of = np.zeros(T, np.int32)
            pos_of[tiles_u] = np.arange(len(tiles_u), dtype=np.int32)
            occ_sub = np.ascontiguousarray(occ_np[:, tiles_u])
            occ_ab = np.zeros((2,) + occ_sub.shape, np.int32)  # [A/B, field, k_u, J]
            lists, lists2 = [], []
            for f in range(2):
                t_i, j_i = np.nonzero(occ_np[f])
                t_i = pos_of[t_i]
                lists.append((to_dev(t_i), to_dev(j_i)))
                if pack2:
                    halves = ((t_i[0::2], j_i[0::2]), (t_i[1::2], j_i[1::2]))
                    for h, (t_h, j_h) in enumerate(halves):
                        occ_ab[h, f, t_h, j_h] = occ_sub[f, t_h, j_h]
                    lists2.append(tuple(to_dev(x) for half in halves for x in half))
            st.update(age=0, lists=lists, occ=upload(occ_np), tiles_u=tiles_u,
                      tiles_sel=upload(tiles_u), occ_sub=upload(occ_sub))
            if pack2:
                st.update(lists2=lists2, occ_sub_a=upload(occ_ab[0]),
                          occ_sub_b=upload(occ_ab[1]))

    def set_pruned(occ_np, keeps, st=None, tag="pruned"):
        set_flags(np.stack([occ_np[0] * keeps[0], occ_np[1] * keeps[1]]), st, tag)

    def far_plane(inputs, fast: bool):
        """(sh [n, 1], ct [n, 3]) at every ray's far point; a fast frame
        evaluates them on the far_subsample subgrid and upsamples."""
        pw_h, pw_t, ro, rd, ro_t, rd_t, _ = inputs
        if not fast or ss == 1:
            return fused_far_eval_split(pw_h, pw_t, ro, rd, ro_t, rd_t, far, act)
        sh, ct = fused_far_eval_split(pw_h, pw_t, *(far_subgrid(x, ss) for x in (ro, rd, ro_t,
                                                                                 rd_t)), far, act)
        return far_upsample(sh, up_A), far_upsample(ct, up_A)

    def run(inputs, st, diag: bool = False, fast: bool = False):
        """One frame under the flag state ``st``: a pipeline frame, or with
        ``fast`` a fast frame (see above); with ``diag`` also the prune
        diagnostics in union-tile rows (reference run_pipeline :795 and
        run_fast :1299)."""
        pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p = inputs
        sel = st["tiles_sel"]

        def gather(x):
            return x.reshape(T, R_T, -1).index_select(0, sel).reshape(-1, x.shape[-1])

        with span("render.gather"):
            ro_g, rd_g, ro_t_g, rd_t_g = (gather(x) for x in (ro, rd, ro_t, rd_t))
        with span("render.segment"):
            if fast and pack2:
                lh, lt = st["lists2"]
                (buf_h, buf_h2) = pair2_field_eval(pw_h, "head", ro_g, rd_g, z_vals_c, *lh, act,
                                                   sp)
                (buf_t, buf_t2) = pair2_field_eval(pw_t, "torso", ro_t_g, rd_t_g, z_vals_c, *lt,
                                                   act, sp)
                occ, extra = st["occ_sub_a"], dict(buf_h2=buf_h2, buf_t2=buf_t2,
                                                   occ2=st["occ_sub_b"])
            else:
                (ti_h, ji_h), (ti_t, ji_t) = st["lists"]
                buf_h = pair_field_eval(pw_h, "head", ro_g, rd_g, z_vals_c, ti_h, ji_h, act, sp)
                buf_t = pair_field_eval(pw_t, "torso", ro_t_g, rd_t_g, z_vals_c, ti_t, ji_t, act,
                                        sp)
                occ, extra = st["occ_sub"], {}
        with span("render.finish"):
            far_skip = st.get("far_skip", False)
            far_vals = None if far_skip else far_plane(inputs, fast)
            keyed = fast and live_keys
            if (diag and budget_on) or keyed:
                extra.update(ray_err_bc=gather(bc_p) if rcfg.occ_budget_color else None,
                             **({"with_keys": True} if keyed else {"with_ray_diag": True}))
            out = deferred_composite(buf_h, buf_t, occ, rd_g, rd_t_g, z_vals_c,
                                     with_diagnostics=diag, s_slab=sp, **extra)
            if keyed:
                stash_keys(out[4], st["tiles_u"])

            def scatter(x, fill):
                full = x.new_full((T, R_T, x.shape[-1]), fill)
                return full.index_copy_(0, sel, x.reshape(-1, R_T, x.shape[-1])).reshape(
                    T * R_T, -1)

            ah, ac, t_h, t_c = (scatter(x, fill)
                                for x, fill in zip(out[:4], (0.0, 0.0, 1.0, 1.0)))
            if far_skip:
                # both far alphas are exactly 1: the catch-all colour is the
                # background pixel (reference blend_nofar_fn :647)
                bc = bc_p.float()
                head, com = ah + t_h * bc, ac + t_c * bc
            else:
                head, com = bg_blend(*far_vals, rd, rd_t, bc_p, rcfg.last_dist, ah, ac, t_h, t_c)
        imgs = (untile(head), untile(com))
        return (imgs, *out[4:]) if diag else imgs

    def update_far_skip(window_inputs, st):
        """The far_skip decision of ``st`` from the exact largest deviation
        of bg_blend's composite far colour c_mix from the background pixel
        over the frames (reference cmix_err_fn :668, update_far_skip :680):
        the only far-dependent term once last_dist saturates both far
        alphas."""
        if rcfg.far_skip_tol <= 0 or rcfg.last_dist < 1e8:
            st["far_skip"] = False
            return
        err = 0.0
        for inputs in window_inputs:
            sh, ct = far_plane(inputs, fast=False)
            bc = inputs[6].float()
            ssum = sh + 1e-6
            c_mix = (sh * bc + 1e-6 * ct) / torch.where(ssum == 0.0, 1e-4, ssum)
            err = max(err, float(download((c_mix - bc).abs().max())[0]))
        st["far_cmix_err"] = err
        st["far_skip"] = err <= rcfg.far_skip_tol
        if os.environ.get("DFANERF_DEBUG_COMPACTION"):
            print(f"[pairs:far_skip] cmix_err={err:.2e} skip={st['far_skip']}", flush=True)

    def expand_tiles(x_sub, st):
        """[K_u, J] union-tile diagnostic -> [T, J] on the host, zero off
        the union (reference expand_tiles :831)."""
        full = np.zeros((T, J), np.float32)
        full[st["tiles_u"]] = download(x_sub)[0]
        return full

    def prune_flags(st, tm_h, tm_c, cb_h, cb_t, wr_h=None, wr_t=None, base_led=None,
                    hist=None):
        """Keep-masks [T, J] from one frame's composite diagnostics under the
        flag state ``st`` (reference prune_flags :839-933): the transmittance
        prune, then the budgeted prune when per-ray costs wr_h/wr_t [J, K_u,
        R_T] are given, else the contribution prune. ``base_led`` [T, R_T]
        seeds each ray's budget ledger with a measured error (the refinement
        rounds).

        ``hist`` (the live refreshes; the offline preps pass none) is a dict
        read and updated in place: with occ_prune_hist_decay = d > 0 it keeps
        per-key running maxima in full tile coordinates, and the prune uses
        max(current, d * history) for the transmittances and, per pair (the
        largest over the tile's rays), for the budget's costs, so a pair
        visible on a recent frame keeps its key when this frame's estimate
        is near 0."""
        keep_h = np.ones((T, J), bool)
        keep_t = np.ones((T, J), bool)
        dk = rcfg.occ_prune_hist_decay

        def histmax(name, full):
            if hist is None or dk <= 0:
                return full
            if name in hist:
                full = np.maximum(full, hist[name] * dk)
            hist[name] = full
            return full

        if rcfg.occ_prune_trans > 0:
            eps = rcfg.occ_prune_trans
            tm_h_f = histmax("tm_h", expand_tiles(tm_h, st))
            tm_c_f = histmax("tm_c", expand_tiles(tm_c, st))
            keep_h &= np.maximum(tm_h_f, tm_c_f) > eps
            keep_t &= tm_c_f > eps
        if budget_on and wr_h is not None:
            # candidates: the occupied pairs the trans prune kept (pairs
            # behind saturated opacity drop anyway and spend no budget)
            tiles_u = st["tiles_u"]
            occ_sub, wr_h, wr_t = download(st["occ_sub"], wr_h, wr_t)
            if hist is not None and dk > 0:
                # every ray of a pair floored at the pair's decayed
                # historical max-ray cost (never at this frame's own)
                wr_h, wr_t = wr_h.copy(), wr_t.copy()
                for name, w in (("wr_h", wr_h), ("wr_t", wr_t)):
                    cur = np.zeros((J, T), np.float32)
                    cur[:, tiles_u] = w.max(axis=2)
                    old = hist[name] * dk if name in hist else np.zeros_like(cur)
                    hist[name] = np.maximum(cur, old)
                    w[:] = np.maximum(w, old[:, tiles_u, None])
            cand = occ_sub.astype(bool)  # [2, K_u, J]
            cand &= np.stack([keep_h[tiles_u], keep_t[tiles_u]])
            base = None if base_led is None else base_led[tiles_u]
            drop = budget_drop_masks(wr_h, wr_t, cand, rcfg.occ_prune_budget, base=base)
            keep_h[tiles_u] &= ~drop[0]
            keep_t[tiles_u] &= ~drop[1]
        elif rcfg.occ_prune_contrib > 0:
            eps = rcfg.occ_prune_contrib
            keep_h &= expand_tiles(cb_h, st) > eps
            keep_t &= expand_tiles(cb_t, st) > eps
        return keep_h, keep_t

    def err_led(imgs0, imgs1):
        """The realized per-ray error of imgs1 against imgs0, the larger
        over channels and both images, [T, R_T] in tile order on the host
        (reference err_led_fn :940)."""
        e = torch.maximum((imgs1[0] - imgs0[0]).abs().amax(-1),
                          (imgs1[1] - imgs0[1]).abs().amax(-1))
        return download(tile_order(e[..., None]).reshape(T, R_T))[0]

    def refresh(inputs, st, hist=None, derive=None, frame=True, kind=""):
        """A full refresh into ``st``: fresh flags and the far_skip
        decision, the frame rendered under the unpruned lists; with pruning,
        the pruned state (``hist``: prune_flags'). ``derive`` (the live
        worker's keys derive) maps the host flags to keep-masks, or to None
        for the diagnostic render and prune; ``frame=False`` renders no
        frame where nothing is measured. ``kind`` ("", "slot" or "async")
        names the refresh in the debug lines. Returns (imgs or None, host
        flags, keep-masks or None)."""
        occ_np = download(occ_fn(inputs))[0]
        set_flags(occ_np, st, "async" if kind == "async" else "flags")
        update_far_skip([inputs], st)
        if not prune_on:
            return (run(inputs, st) if frame else None), occ_np, None
        imgs = None
        keeps = None if derive is None else derive(occ_np)
        if keeps is None:
            imgs, *diags = run(inputs, st, diag=True)
            keeps = prune_flags(st, *diags, hist=hist)
        set_pruned(occ_np, keeps, st, f"pruned-{kind}" if kind else "pruned")
        return imgs, occ_np, keeps

    def carry_refresh(inputs, st, keeps, tag="pruned-carry"):
        """A cheap refresh into ``st``: fresh conservative flags times the
        carried keep-masks (reference :1485-1491, :1621-1636)."""
        set_pruned(download(occ_fn(inputs))[0], keeps, st, tag)
        update_far_skip([inputs], st)

    def refine(inputs, st, imgs0, occ_np, keeps, prep, it=0):
        """Refinement round ``it`` of a slot's budgeted prune (reference
        :978-1019): the diagnostics under the pruned state, the budget
        ledger seeded with the realized error against the unpruned image
        imgs0, the refined drops, then a verify render that reverts them in
        every tile whose realized error grew by more than the budget."""
        kh, kt = keeps
        imgs1, *diags = run(inputs, st, diag=True)
        led = err_led(imgs0, imgs1)
        kh2, kt2 = prune_flags(st, *diags, base_led=led)
        kh_new, kt_new = kh & kh2, kt & kt2
        set_pruned(occ_np, (kh_new, kt_new), st, "pruned-slot")
        led2 = err_led(imgs0, run(inputs, st))
        bad = led2.max(1) > led.max(1) + rcfg.occ_prune_budget
        if os.environ.get("DFANERF_DEBUG_COMPACTION"):
            print(f"[pairs:iter{it + 1}] led_max={led.max():.4f} led2_max={led2.max():.4f} "
                  f"extra_drops={int((kh & ~kh2).sum())}+{int((kt & ~kt2).sum())} "
                  f"reverted_tiles={int(bad.sum())}", flush=True)
        if bad.any():
            kh_new[bad], kt_new[bad] = kh[bad], kt[bad]
            set_pruned(occ_np, (kh_new, kt_new), st, "pruned-slot")
        prep["refined"].append(int((occ_np[0].astype(bool) & kh & ~kh2).sum()
                                   + (occ_np[1].astype(bool) & kt & ~kt2).sum()))
        prep["reverted"].append(int(bad.sum()))
        prep["pairs"].append(pair_counts(st))
        return kh_new, kt_new

    def pair_counts(st):
        return tuple(int(t.numel()) for t, _ in st["lists"])

    def stash_keys(keys, tiles_u):
        """A fast frame's prune keys, kept on the device with the union tiles
        that place them and, on the card, an event recorded after them on
        the serving stream (reference run_fast :1299-1319)."""
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        with cache_lock:
            cache.setdefault("key_frames", deque(maxlen=12)).append((keys, tiles_u, done))

    def derive_keeps_from_keys(occ_np):
        """Keep-masks from the running max of the keys the recent served
        frames reported and the decayed history, with no diagnostic render
        (reference _derive_keeps_from_keys :1391-1440): the trans prune,
        then the budget per pair (every ray floored at the pair's max-ray
        key, so the ledger is the tile's summed key: budget_drop_masks with
        R = 1) over the flags ``occ_np`` that were measured at least once.
        None when no frame has reported keys yet."""
        with cache_lock:
            frames = list(cache.get("key_frames", ()))
        if not frames:
            return None
        if cuda:
            stream = torch.cuda.current_stream(dev)
            for keys, _, done in frames:
                stream.wait_event(done)
                for k in keys:
                    k.record_stream(stream)
        host = download(*(k for keys, _, _ in frames for k in keys))
        agg = [np.zeros((T, J), np.float32) for _ in range(4)]
        for i, (_, tiles_u_f, _) in enumerate(frames):
            for a, x in zip(agg, host[4 * i:4 * i + 4]):
                a[tiles_u_f] = np.maximum(a[tiles_u_f], x)
        dk = max(rcfg.occ_prune_hist_decay, 0.0)
        hist = cache.setdefault("hist", {})
        for name, a in zip(("ktm_h", "ktm_c", "ke_h", "ke_t"), agg):
            if dk > 0 and name in hist:
                np.maximum(a, hist[name] * dk, out=a)
            hist[name] = a
        tm_h_k, tm_c_k, e_h_k, e_t_k = agg
        keep_h = np.ones((T, J), bool)
        keep_t = np.ones((T, J), bool)
        if rcfg.occ_prune_trans > 0:
            eps = rcfg.occ_prune_trans
            keep_h &= np.maximum(tm_h_k, tm_c_k) > eps
            keep_t &= tm_c_k > eps
        if budget_on:
            cand = occ_np.astype(bool)
            cand[0] &= keep_h
            cand[1] &= keep_t
            em = cache.get("ever_measured")
            if em is not None:
                cand &= em  # pairs never measured (new geometry) are kept
            drop = budget_drop_masks(e_h_k.T[:, :, None], e_t_k.T[:, :, None], cand,
                                     rcfg.occ_prune_budget)
            keep_h &= ~drop[0]
            keep_t &= ~drop[1]
        return keep_h, keep_t

    def measured(occ_np):
        em = cache.get("ever_measured")
        return occ_np > 0 if em is None else em | (occ_np > 0)

    def tensors_of(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (dict, list, tuple)):
            for v in (x.values() if isinstance(x, dict) else x):
                yield from tensors_of(v)

    def live_derive(occ_np):
        """The worker's keys derive (derive_keeps_from_keys), or None on the
        turn of a full diagnostic derive: every ``occ_live_remeasure``-th,
        counted by ``cache["derive_ct"]`` (reference :1497-1503)."""
        n_der = cache.get("derive_ct", 0)
        cache["derive_ct"] = n_der + 1
        rm = rcfg.occ_live_remeasure
        return derive_keeps_from_keys(occ_np) if rm <= 0 or n_der % rm != 0 else None

    def refresh_async(inputs, keeps, keep_age, src, ready, serving):
        """The worker: the next flag state from the snapshot ``inputs`` of
        served frame ``src`` (reference _refresh_async :1478-1544), a
        carried or a full refresh with no served frame, on its own stream on
        the card, its launches counted apart (worker_launches). It waits on
        ``ready``, recorded on the serving stream after the inputs; the
        state it builds is marked used by the serving stream, and an event
        recorded after it tells render when the swap may land. A full
        diagnostic derive marks every flagged pair measured
        (``cache["ever_measured"]``), a keys derive the pairs it keeps."""
        try:
            stream = worker["stream"]
            with span("worker.refresh"), torch.no_grad(), worker_launches(), (
                    torch.cuda.stream(stream) if cuda else contextlib.nullcontext()):
                if cuda:
                    stream.wait_event(ready)
                    for x in tensors_of(inputs):
                        x.record_stream(stream)
                st = {}
                if (prune_on and rcfg.occ_prune_carry > 0 and keeps is not None
                        and keep_age < rcfg.occ_prune_carry):
                    carry_refresh(inputs, st, keeps, "pruned-carry-async")
                    keep_age += 1
                else:
                    imgs, occ_np, kk = refresh(inputs, st, hist=cache.setdefault("hist", {}),
                                               derive=live_derive if live_keys else None,
                                               frame=False, kind="async")
                    if kk is not None:
                        keeps, keep_age = kk, 0
                        pruned = np.stack([occ_np[0] * kk[0], occ_np[1] * kk[1]])
                        cache["ever_measured"] = measured(occ_np if imgs is not None else pruned)
                done = None
                if cuda:
                    for x in tensors_of(st):
                        x.record_stream(serving)
                    done = torch.cuda.Event()
                    done.record()
            worker["result"] = (st, keeps, keep_age, src, done)
        except Exception as e:  # noqa: BLE001 -- raised by poll_worker
            worker["error"] = e

    def poll_worker():
        """Swap a finished worker's state in (reference _poll_worker
        :1546-1570), once its device work is done: a failure is served
        stale and retried at the next trigger; the third in a row
        raises."""
        th = worker["thread"]
        if th is None or th.is_alive():
            return
        if worker["error"] is not None:
            worker["thread"] = None
            err, worker["error"] = worker["error"], None
            worker["fails"] += 1
            if worker["fails"] >= 3:
                raise err
            if os.environ.get("DFANERF_DEBUG_COMPACTION"):
                print(f"[pairs:async] refresh failed (retrying next cycle): {err}", flush=True)
            # the reference's [pairs:clamp] line (:1474) reports its class
            # clamp's re-padding, which has no counterpart while R10 (the
            # program classes) is unported
            return
        st, keeps, keep_age, src, done = worker["result"]
        if done is not None and not done.query():
            return
        worker.update(thread=None, result=None, fails=0)
        with cache_lock:
            cache.update({k: st[k] for k in SLOT_KEYS if k in st})
            cache.update(keeps=keeps, keep_age=keep_age, age=1, swaps=cache.get("swaps", 0) + 1,
                         gen=cache["gen"] + 1, gen_src=src)

    def serve_async(inputs, i):
        """Served frame ``i`` of the async live mode (reference render
        :1582-1610): swap in a finished refresh, advance the age and serve
        the frame under the flags in force. Past occ_refresh_every plus the
        trigger jitter rjit (0, 1, 2 in turn, so the snapshots do not lock
        onto the phase of a periodic input), this frame's inputs go to a new
        worker thread, started once the frame is served: its keys derive
        then always includes this frame's keys (the reference starts its
        worker first, and what the derive sees depends on which thread is
        faster)."""
        with span("render.poll"):
            poll_worker()
        cache["age"] += 1
        if not (cache["age"] > max(rcfg.occ_refresh_every, 1) + cache.get("rjit", 0)
                and worker["thread"] is None):
            return run(inputs, cache, fast=True)
        cache["rjit"] = (cache.get("rjit", 0) + 1) % 3
        args = (inputs, cache.get("keeps"), cache.get("keep_age", 0), i)
        ready = serving = None
        if cuda:
            if worker["stream"] is None:
                worker["stream"] = torch.cuda.Stream(dev)
            serving = torch.cuda.current_stream(dev)
            ready = torch.cuda.Event()
            ready.record()
        imgs = run(inputs, cache, fast=True)
        worker["thread"] = threading.Thread(target=refresh_async, args=args + (ready, serving),
                                            daemon=True)
        worker["thread"].start()
        return imgs

    @torch.no_grad()
    def render(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img,
               window_slot=None):
        with span("render.frame"):
            i = cache["served"]
            cache["served"] = i + 1
            inputs = frame_inputs(params, z_shape, z_app, pose, pose_torso, signal, signal_torso,
                                  bc_img)
            slots = cache.get("slots")
            if window_slot is not None and slots:
                # pinned per-slot serving: a window frame under its own lists
                return run(inputs, slots[window_slot % len(slots)], fast=True)
            if rcfg.occ_async_refresh and cache["lists"] is not None and not cache.get("pinned"):
                return serve_async(inputs, i)
            if cache["lists"] is not None and (cache.get("pinned")
                                               or cache["age"] < max(rcfg.occ_refresh_every, 1)):
                cache["age"] += 1
                return run(inputs, cache, fast=True)
            cache.update(gen=cache["gen"] + 1, gen_src=i)
            if (prune_on and rcfg.occ_prune_carry > 0 and cache.get("keeps") is not None
                    and cache["keep_age"] < rcfg.occ_prune_carry):
                # cheap refresh, rendered as a fast frame
                carry_refresh(inputs, cache, cache["keeps"])
                cache["keep_age"] += 1
                cache["age"] = 1
                return run(inputs, cache, fast=True)
            imgs, _, keeps = refresh(inputs, cache, hist=cache.setdefault("hist", {}))
            if keeps is not None:
                cache.update(keeps=keeps, keep_age=0)
            cache["age"] = 1  # this frame consumed the refresh
            return imgs

    @torch.no_grad()
    def run_fast(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        return run(frame_inputs(params, z_shape, z_app, pose, pose_torso, signal, signal_torso,
                                bc_img), cache, fast=True)

    @torch.no_grad()
    def refresh_union(window_inputs, per_slot: bool = False):
        """Flags for a window of prepped frames (each a ``render.inputs_fn``
        result; reference refresh_union :947): with ``per_slot`` first each
        frame's own pruned state as a slot, then the union of the frames'
        flags, pruned to the pairs that some frame's composite under the
        union keeps. Pins the union state: ``render`` no longer refreshes
        until the next call."""
        slots, slot_prep = [], []
        iters = max(int(rcfg.occ_budget_iters), 1) if budget_on else 1
        if per_slot:
            for inp in window_inputs:
                st = {}
                imgs0, occ_np, keeps = refresh(inp, st, kind="slot")
                prep = {"pairs": [tuple(int(x) for x in occ_np.sum(axis=(1, 2))),
                                  pair_counts(st)], "refined": [], "reverted": []}
                for it in range(iters - 1):
                    keeps = refine(inp, st, imgs0, occ_np, keeps, prep, it)
                slots.append({k: st[k] for k in SLOT_KEYS if k in st})
                slot_prep.append(prep)
        occ = occ_fn(window_inputs[0])
        for inp in window_inputs[1:]:
            occ = torch.maximum(occ, occ_fn(inp))
        occ_np = download(occ)[0]
        set_flags(occ_np)
        update_far_skip(window_inputs, cache)
        if prune_on:
            keeps = None
            for inp in window_inputs:
                _, *diags = run(inp, cache, diag=True)
                kh, kt = prune_flags(cache, *diags)
                keeps = (kh, kt) if keeps is None else (keeps[0] | kh, keeps[1] | kt)
            set_pruned(occ_np, keeps)
        cache.update(pinned=True, slots=slots, slot_prep=slot_prep, gen=cache["gen"] + 1,
                     gen_src=-1)

    def precompile_headroom(*_, **__):
        raise NotImplementedError(
            "precompile_headroom (the reference's off-stream compile of program classes) is not "
            "ported; a torch analogue, such as one CUDA-graph capture per pair-count class, is "
            "to be measured before it is built (ROADMAP.md queue 2, R10)")

    render.cache = cache
    render.worker = worker
    render.inputs_fn = frame_inputs
    render.run_fast = run_fast
    render.refresh_union = refresh_union
    render.precompile_headroom = precompile_headroom
    return render


def _make_occupancy_renderer(rcfg: RenderConfig, act: str, z_vals_c, frame_inputs, untile):
    """The occupancy serving path without tile classes (reference
    :205-249): per-field flags from ``conservative_occupancy`` on the first
    frame and then every ``occ_refresh_every`` frames, kept on the device;
    each frame one ``fused_render_rays`` in epilogue mode over every tile
    under the joint flags. Nothing is copied to the host. ``render.cache``
    holds ``occ`` ([2, T, J] int32), ``age``, ``served``, ``gen`` and
    ``gen_src``."""
    cache = {"occ": None, "age": 0, "served": 0, "gen": 0, "gen_src": -1}

    @torch.no_grad()
    def render(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        with span("render.frame"):
            i = cache["served"]
            cache["served"] = i + 1
            pw_h, pw_t, ro, rd, ro_t, rd_t, bc_p = frame_inputs(
                params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img)
            if cache["occ"] is None or cache["age"] >= max(rcfg.occ_refresh_every, 1):
                with span("occupancy.flags"):
                    cache["occ"] = conservative_occupancy(
                        pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c, rcfg.occ_sigma_thresh,
                        grid_res=rcfg.occ_grid_res, act=act)
                cache.update(age=0, gen=cache["gen"] + 1, gen_src=i)
            cache["age"] += 1
            with span("render.segment"):
                head, com = fused_render_rays(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c, bc_p,
                                              last_dist=rcfg.last_dist, ert_eps=rcfg.ert_eps,
                                              occupancy=cache["occ"], bg_epilogue=True, act=act)
            return untile(head), untile(com)

    render.cache = cache
    render.inputs_fn = frame_inputs
    return render


BUCKETS = (0, 64, 128, 256, 384, 512, 768)  # segment sizes in tiles, below T (reference :354)
CLASS_FIELDS = ("both", "head", "torso")     # the kernel variant of each rendered class


def tile_classes(occ_np: np.ndarray):
    """The per-field tile classes of host flags [2, T, J] (reference
    refresh_flags :362-428, exactly). Tiles with head and torso flags form
    the "both" segment, head-only and torso-only tiles the "head" and
    "torso" segments, the rest "none". Each segment is padded to the next
    rung of ``BUCKETS`` + [T]: "both" borrows tiles from the head, torso and
    none pools in that order, each by ``pop()`` (from its end), and keeps
    their joint flags, so the two-field kernel also evaluates a borrowed
    tile's other field wherever its joint flags are set; "head" and "torso"
    borrow from the none pool with zero flags (they run no slab). The
    padding decides pixels, so it is kept.

    Returns (order [T] int64: the segments' tiles in order, "none" last;
    ks = (k_both, k_head, k_torso) tile counts; occs: the [k, J] int32 flags
    each segment's kernel runs under, joint for "both", the field's own for
    "head" and "torso", None where k is 0)."""
    occ_np = np.asarray(occ_np, dtype=np.int32)
    T, J = occ_np.shape[1:]
    rungs = [k for k in BUCKETS if k < T] + [T]

    def bucket(n):
        return next(k for k in rungs if k >= n)

    th = occ_np[0].max(axis=1) > 0
    tt = occ_np[1].max(axis=1) > 0
    seg_b = list(np.nonzero(th & tt)[0])
    pool = [list(np.nonzero(th & ~tt)[0]), list(np.nonzero(tt & ~th)[0]),
            list(np.nonzero(~th & ~tt)[0])]
    kb = bucket(len(seg_b))
    borrowed = []
    for p in pool:
        while len(seg_b) + len(borrowed) < kb and p:
            borrowed.append(p.pop())
    seg_h, seg_t, none = pool

    def pad_from_none(seg):
        pad = []
        while len(seg) + len(pad) < bucket(len(seg)) and none:
            pad.append(none.pop())
        return pad

    pad_h = pad_from_none(seg_h)
    pad_t = pad_from_none(seg_t)

    def flags(main, n_pad, fl):
        f = np.zeros((len(main) + n_pad, J), np.int32)
        f[:len(main)] = fl[np.array(main, np.int64)]
        return f

    segs = (seg_b + borrowed, seg_h + pad_h, seg_t + pad_t)
    occs = (flags(segs[0], 0, occ_np.max(axis=0)), flags(seg_h, len(pad_h), occ_np[0]),
            flags(seg_t, len(pad_t), occ_np[1]))
    order = np.array(segs[0] + segs[1] + segs[2] + none, np.int64)
    ks = tuple(len(seg) for seg in segs)
    return order, ks, tuple(o if k else None for o, k in zip(occs, ks))


def _make_tile_class_renderer(rcfg: RenderConfig, act: str, T: int, z_vals_c, frame_inputs,
                              untile):
    """The occupancy serving path with per-field tile classes (reference
    :251-457; ``occ_tile_compaction``, the shipped serving configuration).

    A refresh frame (the first, then every ``occ_refresh_every``-th) copies
    the per-field flags [2, T, J] to the host (~54 KB at 450x450, 64
    samples) and splits the tiles into classes (``tile_classes``). Every
    frame gathers the rays in class order, runs ``fused_render_rays`` in
    epilogue mode once per non-empty segment with its variant ("both",
    "head", "torso") and flags, closes the "none" tiles with the background
    epilogue alone (accumulators 0, transmittances 1), scatters the tiles
    back and untiles. A steady frame makes no host sync: the segment sizes
    are host ints of the last refresh and the gathers index with device
    tensors. (The reference runs the gather, each kernel and the epilogue
    with the scatter as separate programs to avoid a fault of its TPU
    runtime; one program of PyTorch calls needs no such split.)

    ``render.cache`` holds ``order`` (int64 device tensor), ``ks``, ``occs``
    (int32 device tensors or None) and ``age`` with the reference's
    meanings, and ``served``, ``gen``, ``gen_src``; ``render.inputs_fn`` is
    the frame-input builder;
    ``render.stages`` the stage functions (``flags``, ``refresh``,
    ``gather``, ``segment``, ``finish``, ``untile``) whose composition is a
    frame."""
    dev = z_vals_c.device
    cache = {"order": None, "ks": None, "occs": None, "age": 0, "served": 0, "gen": 0,
             "gen_src": -1}

    def flags(inputs):
        pw_h, pw_t, ro, rd, ro_t, rd_t, _ = inputs
        with span("occupancy.flags"):
            return conservative_occupancy(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c,
                                          rcfg.occ_sigma_thresh, grid_res=rcfg.occ_grid_res,
                                          act=act)

    def refresh(occ_np):
        """The classes of host flags [2, T, J] into the cache."""
        if os.environ.get("DFANERF_DEBUG_COMPACTION"):
            th, tt = occ_np[0].max(axis=1) > 0, occ_np[1].max(axis=1) > 0
            print(f"[classes] T={T} both={int((th & tt).sum())} head={int((th & ~tt).sum())} "
                  f"torso={int((tt & ~th).sum())} none={int((~th & ~tt).sum())} "
                  f"head_dens={occ_np[0].mean():.4f} torso_dens={occ_np[1].mean():.4f}",
                  flush=True)
        with span("occupancy.lists"):
            order, ks, occs = tile_classes(occ_np)
            cache.update(order=torch.from_numpy(order).to(dev), ks=ks, age=0,
                         occs=tuple(None if o is None else torch.from_numpy(o).to(dev)
                                    for o in occs))

    def gather(inputs):
        """Rays and background pixels (ro, rd, ro_t, rd_t, bc) in class
        order, each [T * 256, 3]: segment c is a contiguous run of tiles."""
        sel = cache["order"]
        with span("render.gather"):
            return [x.reshape(T, R_T, -1).index_select(0, sel).reshape(-1, x.shape[-1])
                    for x in inputs[2:]]

    def bounds():
        """(first ray, end ray) of the segments both, head, torso, none."""
        edges = np.cumsum((0,) + tuple(cache["ks"]) + (T - sum(cache["ks"]),)) * R_T
        return list(zip(edges[:-1].tolist(), edges[1:].tolist()))

    def segment(pw_h, pw_t, rays, c):
        """Class c's kernel on its rays: (head, com) [k * 256, 3]."""
        (a, b), occ = bounds()[c], cache["occs"][c]
        ro, rd, ro_t, rd_t, bc = (x[a:b] for x in rays)
        with span("render.segment"):
            return fused_render_rays(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c, bc,
                                     last_dist=rcfg.last_dist, ert_eps=rcfg.ert_eps,
                                     occupancy=occ, bg_epilogue=True, fields=CLASS_FIELDS[c],
                                     act=act)

    def finish(pw_h, pw_t, rays, outs):
        """The none tiles' epilogue and the scatter back to tile order: outs
        are the rendered segments' (head, com) in order; returns (head, com)
        [T * 256, 3] in tile order."""
        a, b = bounds()[3]
        order = cache["order"]

        def scatter(parts):
            v = torch.cat(parts).reshape(T, R_T, 3)
            return torch.empty_like(v).index_copy_(0, order, v).reshape(-1, 3)

        with span("render.finish"):
            if b > a:
                ro, rd, ro_t, rd_t, bc = (x[a:b] for x in rays)
                zeros, ones = ro.new_zeros((b - a, 3)), ro.new_ones((b - a, 1))
                outs = outs + [_bg_epilogue(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals_c, bc,
                                            rcfg.last_dist, zeros, zeros, ones, ones, act=act)]
            return scatter([h for h, _ in outs]), scatter([c for _, c in outs])

    @torch.no_grad()
    def render(params, z_shape, z_app, pose, pose_torso, signal, signal_torso, bc_img):
        with span("render.frame"):
            i = cache["served"]
            cache["served"] = i + 1
            inputs = frame_inputs(params, z_shape, z_app, pose, pose_torso, signal, signal_torso,
                                  bc_img)
            if cache["order"] is None or cache["age"] >= max(rcfg.occ_refresh_every, 1):
                occ = flags(inputs)
                with span("occupancy.download"):
                    occ_np = occ.cpu().numpy()  # the host sync of a refresh frame
                refresh(occ_np)
                cache.update(gen=cache["gen"] + 1, gen_src=i)
            cache["age"] += 1
            pw_h, pw_t = inputs[:2]
            rays = gather(inputs)
            outs = [segment(pw_h, pw_t, rays, c) for c in range(3) if cache["ks"][c]]
            head, com = finish(pw_h, pw_t, rays, outs)
            return untile(head), untile(com)

    render.cache = cache
    render.inputs_fn = frame_inputs
    render.stages = {"flags": flags, "refresh": refresh, "gather": gather, "segment": segment,
                     "finish": finish, "untile": untile}
    return render


def make_head_hierarchical_renderer(cfg: ExperimentConfig, hwfcxy, near: float, far: float,
                                    device=None):
    """Head-only coarse + fine full-frame renderer (BASELINE config 2:
    ``n_samples`` coarse + ``n_importance`` fine samples; port of the fused
    branches of the reference's make_head_hierarchical_renderer :1718) on
    ``device`` (default CUDA).

    Returns render(params, z_shape, z_app, pose, signal, bc_img) -> rgb
    [H, W, 3] float32, the head stack over the background. Rays are in 16x16
    spatial tiles. Dense (no pair compaction, or ``occ_sigma_thresh == 0``):
    - coarse: ``fused_sigma_head`` at the shared depths, under the head's
      coarse occupancy flags when ``occ_sigma_thresh > 0`` (their summed-area
      table is kept);
    - resample: the coarse weights (with the background concat's +1e-6 on
      the last density), the deterministic inverse-CDF resample and the
      sorted union of coarse and fine depths; fine flags from the same
      table;
    - fine: ``fused_render_head`` on the per-ray union, with ERT.
    With ``occ_pair_compaction`` and ``occ_sigma_thresh > 0`` both passes run
    on pair lists instead (``_make_hier_pair_renderer``).

    ``render.stages`` holds the stage functions in order (the dense frame is
    their composition), for timing them apart. With ``use_fused_kernel=False``
    the unfused render_head_hierarchical runs instead, over tiles of
    ``tile_rays`` rays (reference :1852-1875), and has no stages."""
    dev = resolve_device(device)
    H, W = int(hwfcxy[0]), int(hwfcxy[1])
    rcfg, dcfg = cfg.render, cfg.decoder
    if rcfg.n_importance <= 0:
        raise ValueError("the hierarchical renderer needs n_importance > 0")
    if not rcfg.use_fused_kernel:
        return _make_unfused_hier_renderer(rcfg, hwfcxy, near, far, dev)
    S_c, S_f = rcfg.n_samples, rcfg.n_samples + rcfg.n_importance
    if not rcfg.concate_bg or S_c % S_SLAB or S_f % S_SLAB:
        raise ValueError("the fused hierarchical renderer needs concate_bg and n_samples and "
                         "n_samples + n_importance multiples of 8")
    act = dcfg.density_activation
    pdt = torch.bfloat16 if rcfg.compute_dtype == "bfloat16" else torch.float32
    perm = spatial_tile_permutation(H, W).to(dev)
    tiled_rays = _tiled_ray_fn(hwfcxy, perm)
    z_c = linspace(near, far, S_c, device=dev)
    thresh, grid_res = rcfg.occ_sigma_thresh, rcfg.occ_grid_res

    def as_f32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

    def pack(params, z_shape, z_app, signal):
        return pack_field_weights(params.decoder, as_f32(signal), as_f32(z_shape)[0],
                                  as_f32(z_app)[0], "head", param_dtype=pdt)

    def bc_tiled(bc_img):
        return (torch.as_tensor(bc_img).to(dev).reshape(-1, 3).float() / 255.0)[perm]

    def fine_depths(rd, sigma_c):
        """The sorted coarse + fine union [n, S_f] from coarse densities
        [n, S_c] (and the coarse weights [n, S_c])."""
        sigma_c = sigma_c.clone()
        sigma_c[:, -1] += 1e-6  # the background concat's density bump
        z_b = z_c.expand(sigma_c.shape[0], S_c)
        weights = calc_volume_weights(z_b, rd, sigma_c, last_dist=rcfg.last_dist)
        return hierarchical_z_vals(z_b, weights, rcfg.n_importance, det=True), weights

    if rcfg.occ_pair_compaction and thresh > 0:
        return _make_hier_pair_renderer(rcfg, act, H, W, z_c, tiled_rays, pack, bc_tiled,
                                        fine_depths)

    @torch.no_grad()
    def prep(params, z_shape, z_app, pose, signal, bc_img):
        with span("render.inputs"):
            ro, rd = tiled_rays(as_f32(pose))
            return pack(params, z_shape, z_app, signal), ro, rd, bc_tiled(bc_img)

    @torch.no_grad()
    def coarse_flags(pw, ro, rd):
        if thresh <= 0:
            return None, None
        with span("occupancy.flags"):
            return occupancy_flags_and_sat(pw, "head", ro, rd, z_c.expand(ro.shape[0], S_c),
                                           thresh, grid_res=grid_res, act=act)

    @torch.no_grad()
    def sigma(pw, ro, rd, occ_c):
        with span("render.sigma"):
            return fused_sigma_head(pw, ro, rd, z_c, occupancy=occ_c, act=act)

    @torch.no_grad()
    def resample(pw, ro, rd, sigma_c, sat_cache):
        with span("render.resample"):
            z_fine, _ = fine_depths(rd, sigma_c)
            occ_f = None
            if thresh > 0:
                occ_f, _ = occupancy_flags_and_sat(pw, "head", ro, rd, z_fine, thresh,
                                                   grid_res=grid_res, sat_cache=sat_cache,
                                                   act=act)
            return z_fine, occ_f

    @torch.no_grad()
    def fine(pw, ro, rd, z_fine, bc, occ_f):
        with span("render.fine"):
            return fused_render_head(pw, ro, rd, z_fine, bc, last_dist=rcfg.last_dist,
                                     ert_eps=rcfg.ert_eps, occupancy=occ_f, act=act)

    def finish(rgb_p):
        with span("render.finish"):
            return spatial_untile(rgb_p, H, W)

    def render(params, z_shape, z_app, pose, signal, bc_img):
        with span("render.frame"):
            pw, ro, rd, bc = prep(params, z_shape, z_app, pose, signal, bc_img)
            occ_c, sat_cache = coarse_flags(pw, ro, rd)
            sigma_c = sigma(pw, ro, rd, occ_c)
            z_fine, occ_f = resample(pw, ro, rd, sigma_c, sat_cache)
            return finish(fine(pw, ro, rd, z_fine, bc, occ_f))

    render.stages = {"prep": prep, "coarse_flags": coarse_flags, "sigma": sigma,
                     "resample": resample, "fine": fine, "finish": finish}
    return render


def _make_unfused_hier_renderer(rcfg: RenderConfig, hwfcxy, near: float, far: float, dev):
    """render_head_hierarchical (deterministic resample) over tiles of
    ``tile_rays`` rays in scanline order."""
    H, W, focal, cx, cy = hwfcxy
    H, W = int(H), int(W)
    tile = min(rcfg.tile_rays, H * W)
    z_vals = stratified_z_vals(near, far, tile, rcfg.n_samples, device=dev)

    def as_f32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

    @torch.no_grad()
    def render(params, z_shape, z_app, pose, signal, bc_img):
        ro, rd = (x.reshape(-1, 3) for x in get_rays(H, W, focal, as_f32(pose), cx, cy))
        bc = torch.as_tensor(bc_img).to(dev).reshape(-1, 3).float() / 255.0
        z_shape, z_app, signal = as_f32(z_shape), as_f32(z_app), as_f32(signal)
        rgb = [render_head_hierarchical(params.decoder, rcfg, ro[sl], rd[sl],
                                        z_vals[:sl.stop - sl.start], signal, z_shape[0],
                                        z_app[0], bc[sl])
               for sl in _tile_slices(H * W, tile)]
        return torch.cat(rgb).reshape(H, W, 3)

    return render


def fine_slab_mass(weights: torch.Tensor, z_fine: torch.Tensor, z_c: torch.Tensor) -> torch.Tensor:
    """The coarse compositing mass inside each fine slab's depth range, the
    tile's largest (reference renderer.py :2072-2082): coarse weights [n,
    S_c] (the catch-all's excluded) spread uniformly over their bins [z_c[k],
    z_c[k + 1]], the model sample_pdf inverts; z_fine [n, S_f] the sorted
    union, n a whole number of tiles. Returns [n_tiles, S_f / 8]."""
    z_lo, z_hi = z_fine[:, ::S_SLAB], z_fine[:, S_SLAB - 1::S_SLAB]
    zb0, zb1 = z_c[:-1], z_c[1:]
    ov = (torch.minimum(z_hi[:, :, None], zb1[None, None])
          - torch.maximum(z_lo[:, :, None], zb0[None, None]))
    frac = torch.clamp(ov / (zb1 - zb0)[None, None], 0.0, 1.0)
    mass = (weights[:, None, :-1] * frac).sum(dim=-1)  # [n, J_f]
    return mass.reshape(-1, R_T, mass.shape[1]).amax(dim=1)


# [hier:t]'s tags (the reference's marks) of the stage spans directly inside a
# hierarchical pair frame: a tag's time runs from the previous tag's last
# edge to the end of its own last span; "refresh" only on a refresh frame, the
# others 0.0ms where their spans did not run (the refresh frame's sigma and
# resample run inside its refresh).
HIER_T_TAGS = {"render.inputs": "prep", "occupancy.flags": "refresh",
               "occupancy.download": "refresh", "occupancy.lists": "refresh",
               "render.gather": "sigma_kernel", "render.sigma": "sigma_kernel",
               "render.resample": "resample", "render.fine": "fine_kernel",
               "render.finish": "finish"}


def hier_t_line(marks) -> str:
    """DFANERF_DEBUG_HIER_T's line from one frame's marks (``spans.timed``):
    each tag's milliseconds, as the reference prints them."""
    depth = next(d for name, d, _, _ in marks if name == "render.frame") + 1
    stages = [m for m in marks if m[1] == depth and m[0] in HIER_T_TAGS]
    ends = {HIER_T_TAGS[name]: end for name, _, _, end in stages}
    edge, parts = stages[0][2], []
    for tag in ("prep", "refresh", "sigma_kernel", "resample", "fine_kernel", "finish"):
        if tag == "refresh" and tag not in ends:
            continue
        end = ends.get(tag, edge)
        parts.append(f"{tag}={elapsed_ms(edge, end):.1f}ms")
        edge = end
    return " ".join(parts)


def _make_hier_pair_renderer(rcfg: RenderConfig, act: str, H: int, W: int, z_c: torch.Tensor,
                             tiled_rays, pack, bc_tiled, fine_depths):
    """The pair-compacted hierarchical serving path (port of the semantics
    of the reference's _make_hier_pair_renderer, renderer.py :1879).

    Both passes run on (tile, slab) pair lists of the head field:
    ``pair_sigma_eval`` at the coarse depths, then ``pair_field_eval_perz``
    at each ray's sorted coarse + fine union; ``deferred_composite_head``
    composites with per-ray dists and closes each ray with the background
    (with last_dist >= 1e8 the catch-all alpha is exactly 1). Tiles with no
    coarse flag output the background pixel.

    A refresh frame (the first, then every ``occ_refresh_every``-th) builds
    the coarse flags and their summed-area table, copies the flags to the
    host (~7 KB at 450x450) for the union tiles and the coarse pair list,
    runs the coarse pass and the resample, and copies the fine flags (~20
    KB) for the fine pair list. The resample builds the fine flags through
    the cached table, then drops fine slabs behind a saturated coarse
    transmittance (``occ_prune_trans``) and, per tile, the largest set of
    smallest coarse-mass slabs whose masses sum to at most
    ``occ_prune_contrib`` (a budget, not a threshold). The refresh frame
    renders from its own intermediates. A steady frame runs the same stages
    under the cached lists with no host sync: its fresh fine flags, ANDed
    with the cached fine list, mask the composite.

    The reference pads pair lists and tile sets to bucket sizes so that XLA
    compiles few programs; the port launches exactly K pairs over exactly
    the union tiles, which gives the same images. ``render.cache`` holds the
    refresh state (``tiles_u`` host int64 union tiles, ``ti_c``/``ji_c`` and
    ``ti_f``/``ji_f`` int32 device pair lists in union-tile positions,
    ``occ_sub``, ``list_mask``, ``sat``, ``age``, ``empty``, and ``served``,
    ``gen``, ``gen_src``); ``render.stages`` the stage functions;
    ``render.run_fast`` renders a frame under the current lists without
    advancing the cadence."""
    dev = z_c.device
    S_c, S_f = rcfg.n_samples, rcfg.n_samples + rcfg.n_importance
    J_c, J_f = S_c // S_SLAB, S_f // S_SLAB
    T = (-(-H // 16)) * (-(-W // 16))
    thresh, grid_res = rcfg.occ_sigma_thresh, rcfg.occ_grid_res
    hcache = {"age": 0, "served": 0, "gen": 0, "gen_src": -1}

    @torch.no_grad()
    def prep(params, z_shape, z_app, pose, signal, bc_img):
        with span("render.inputs"):
            ro, rd = tiled_rays(torch.as_tensor(pose).to(device=dev, dtype=torch.float32))
            return pack(params, z_shape, z_app, signal), ro, rd, bc_tiled(bc_img)

    @torch.no_grad()
    def coarse_flags(pw, ro, rd):
        with span("occupancy.flags"):
            return occupancy_flags_and_sat(pw, "head", ro, rd, z_c.expand(ro.shape[0], S_c),
                                           thresh, grid_res=grid_res, act=act)

    def gather(x, sel):
        return x.reshape(T, R_T, -1).index_select(0, sel).reshape(-1, x.shape[-1])

    @torch.no_grad()
    def sigma(pw, ro_g, rd_g):
        with span("render.sigma"):
            return pair_sigma_eval(pw, ro_g, rd_g, z_c, hcache["ti_c"], hcache["ji_c"], act)

    @torch.no_grad()
    def resample(pw, ro_g, rd_g, sig_buf):
        """Coarse buffer -> (z_buf [J_f, 8, n_u + 256], dists [S_f, n_u],
        fine flags [k_u, J_f] int32), reference :2007-2104."""
        with span("render.resample"):
            k_u = ro_g.shape[0] // R_T
            n_u = k_u * R_T
            flag = hcache["occ_sub"].bool().t()[:, None, :, None]
            x = sig_buf.reshape(J_c, S_SLAB, k_u + 1, R_T)[:, :, :k_u]
            sigma_c = torch.where(flag, x, 0.0).reshape(S_c, n_u).t()
            z_fine, weights = fine_depths(rd_g, sigma_c)
            occ_f, _ = occupancy_flags_and_sat(pw, "head", ro_g, rd_g, z_fine, thresh,
                                               grid_res=grid_res, sat_cache=hcache["sat"], act=act)
            if rcfg.occ_prune_trans > 0:
                # T at each fine slab's earliest depth, tile-max: everything
                # behind the saturated surface drops
                t_prev = 1.0 - torch.cat([weights.new_zeros((n_u, 1)),
                                          torch.cumsum(weights, dim=1)[:, :-1]], dim=1)
                t_tile = t_prev.reshape(k_u, R_T, S_c).amax(dim=1)
                z0_tile = z_fine[:, ::S_SLAB].reshape(k_u, R_T, J_f).amin(dim=1)
                t_at = torch.where(z_c[None, None, :] >= z0_tile[:, :, None], t_tile[:, None, :],
                                   0.0).amax(dim=-1)
                occ_f = occ_f * (t_at > rcfg.occ_prune_trans)
            if rcfg.occ_prune_contrib > 0:
                # per tile, drop the smallest-mass occupied slabs while their
                # masses sum to at most the budget (stable order: ties drop in
                # slab order, as jnp.argsort's)
                mass_tile = torch.where(occ_f > 0, fine_slab_mass(weights, z_fine, z_c), 0.0)
                order = torch.argsort(mass_tile, dim=1, stable=True)
                cum = torch.cumsum(mass_tile.gather(1, order), dim=1)
                drop = torch.zeros_like(occ_f, dtype=torch.bool).scatter_(
                    1, order, cum <= rcfg.occ_prune_contrib)
                occ_f = occ_f * ~drop
            zf = z_fine.float()
            z_buf = torch.cat([zf.reshape(k_u, R_T, J_f, S_SLAB).permute(2, 3, 0, 1).reshape(
                J_f, S_SLAB, n_u), zf.new_zeros((J_f, S_SLAB, R_T))], dim=2)
            diffs = torch.cat([zf[:, 1:] - zf[:, :-1], zf.new_zeros((n_u, 1))], dim=1)
            dists = (diffs * torch.linalg.norm(rd_g.float(), dim=-1, keepdim=True)).t()
            return z_buf, dists, occ_f

    @torch.no_grad()
    def fine(pw, ro_g, rd_g, z_buf):
        with span("render.fine"):
            return pair_field_eval_perz(pw, ro_g, rd_g, z_buf, hcache["ti_f"], hcache["ji_f"],
                                        act)

    @torch.no_grad()
    def finish(buf, occ_f, dists, bc_g, bc_p):
        # the fresh fine flags AND the fine list the kernel ran: unwritten
        # blocks stay masked, and pairs the carried list misses render as
        # pruned
        with span("render.finish"):
            head_u = deferred_composite_head(buf, occ_f * hcache["list_mask"], dists, bc_g)
            full = bc_p.reshape(T, R_T, 3).index_copy(0, hcache["tiles_sel"],
                                                      head_u.reshape(-1, R_T, 3))
            return spatial_untile(full.reshape(-1, 3), H, W)

    def pair_list(flags_np):
        t_i, j_i = np.nonzero(flags_np)  # tile-major, slabs ascending
        return (torch.from_numpy(t_i.astype(np.int32)).to(dev),
                torch.from_numpy(j_i.astype(np.int32)).to(dev))

    @torch.no_grad()
    def refresh(pw, ro, rd, bc_p):
        """The refresh state into the cache (clearing the last one's)."""
        occ_c, sat = coarse_flags(pw, ro, rd)
        with span("occupancy.download"):
            occ_c_np = occ_c.cpu().numpy()  # host sync, [T, J_c] int32
        with span("occupancy.lists"):
            tiles_u = np.nonzero(occ_c_np.max(axis=1))[0]
            hcache.clear()
            if len(tiles_u) == 0:
                hcache.update(age=0, empty=True)
                return
            occ_sub = np.ascontiguousarray(occ_c_np[tiles_u])
            ti_c, ji_c = pair_list(occ_sub)
            sel = torch.from_numpy(tiles_u).to(dev)
            hcache.update(age=0, empty=False, tiles_u=tiles_u, tiles_sel=sel, sat=sat,
                          occ_sub=torch.from_numpy(occ_sub).to(dev), ti_c=ti_c, ji_c=ji_c)
        with span("occupancy.flags"):
            ro_g, rd_g, bc_g = (gather(x, sel) for x in (ro, rd, bc_p))
            z_buf, dists, occ_f = resample(pw, ro_g, rd_g, sigma(pw, ro_g, rd_g))
        with span("occupancy.download"):
            occ_f_np = occ_f.cpu().numpy() > 0  # host sync, [k_u, J_f]
        with span("occupancy.lists"):
            ti_f, ji_f = pair_list(occ_f_np)
            hcache.update(ti_f=ti_f, ji_f=ji_f,
                          list_mask=torch.from_numpy(occ_f_np.astype(np.float32)).to(dev),
                          frame0=(ro_g, rd_g, bc_g, z_buf, dists, occ_f))
        if os.environ.get("DFANERF_DEBUG_HIER"):
            # k_u and the buckets are the reference's padded sizes; the port
            # pads nothing, so they are the counts themselves
            print(f"[hier] tiles_u={len(tiles_u)} k_u={len(tiles_u)} "
                  f"coarse_pairs={int(occ_sub.sum())} fine_pairs={int(occ_f_np.sum())} "
                  f"(buckets {ti_c.numel()}/{ti_f.numel()})", flush=True)

    def steady(pw, ro, rd, bc_p):
        """One frame under the cached lists: no host sync."""
        if hcache["empty"]:
            # nothing occupied anywhere: every ray is transmittance-1 background
            return spatial_untile(bc_p, H, W)
        if "frame0" in hcache:
            # the refresh frame renders from its own intermediates
            ro_g, rd_g, bc_g, z_buf, dists, occ_f = hcache.pop("frame0")
        else:
            sel = hcache["tiles_sel"]
            with span("render.gather"):
                ro_g, rd_g, bc_g = (gather(x, sel) for x in (ro, rd, bc_p))
            z_buf, dists, occ_f = resample(pw, ro_g, rd_g, sigma(pw, ro_g, rd_g))
        buf = fine(pw, ro_g, rd_g, z_buf)
        return finish(buf, occ_f, dists, bc_g, bc_p)

    def frame(params, z_shape, z_app, pose, signal, bc_img):
        with span("render.frame"):
            i, gen = hcache["served"], hcache["gen"]
            inputs = prep(params, z_shape, z_app, pose, signal, bc_img)
            if "empty" not in hcache or hcache["age"] >= max(int(rcfg.occ_refresh_every), 1):
                refresh(*inputs)  # clears the cache
                hcache.update(gen=gen + 1, gen_src=i)
            hcache["age"] += 1
            hcache["served"] = i + 1
            return steady(*inputs)

    def render(params, z_shape, z_app, pose, signal, bc_img):
        if not os.environ.get("DFANERF_DEBUG_HIER_T"):
            return frame(params, z_shape, z_app, pose, signal, bc_img)
        with timed(dev.type == "cuda") as marks:
            out = frame(params, z_shape, z_app, pose, signal, bc_img)
        if not hcache["empty"]:
            print(f"[hier:t] {hier_t_line(marks)}", flush=True)
        return out

    def run_fast(params, z_shape, z_app, pose, signal, bc_img):
        """A frame under the current lists, without advancing the cadence."""
        if "empty" not in hcache:
            raise RuntimeError("run_fast needs the lists of a refresh frame")
        return steady(*prep(params, z_shape, z_app, pose, signal, bc_img))

    render.cache = hcache
    render.run_fast = run_fast
    render.stages = {"prep": prep, "coarse_flags": coarse_flags, "refresh": refresh,
                     "gather": gather, "sigma": sigma, "resample": resample, "fine": fine,
                     "finish": finish}
    return render


@torch.no_grad()
def encode_frame_signals(params, auds, exps, poses, img_i: int, n_valid: int,
                         cfg: ExperimentConfig, use_smoothing: bool):
    """Conditioning signals of one frame: (signal [dim_signal],
    signal_torso [dim_et_embed]). auds/exps/poses are tensors on the
    params' device."""
    with span("render.signals"):
        sig = encode_signal(params, auds, exps, img_i, n_valid, cfg.signal.smo_size,
                            use_smoothing, cfg.signal.audio_net, cfg.signal.win_size)
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

