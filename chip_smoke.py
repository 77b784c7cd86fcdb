"""Smoke test of the PyTorch/CUDA port (dfanerf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
1. build every CUDA kernel of the port from the sources in this checkout
   (one nvcc per source, all at once); print each library's ptxas lines
   (registers, spills, stack), each kernel's HGMMA and HMMA count in its
   SASS (cuobjdump) and any ptxas wgmma serialisation warning; fail if a
   kernel of the wgmma core's libraries (all of them: render_rays,
   pair_field, render_head, pair_perz, sigma_head, pair_hier, far_eval)
   holds no HGMMA or ptxas serialised their wgmma, or render_rays does not
   hold its six instantiations;
2. hold each kernel against its plain PyTorch version on the card, on
   seeded full-width inputs, within the stated tolerances: render_rays,
   then pair_field (head and torso, relu and softplus, a pair list with
   gaps and an empty one) and far_head / far_torso (77 rays, under one
   128-ray chunk; 4096, an exact multiple; 4173, a ragged count);
3. drive the dense main path — the fused head+torso frame render at
   450x450, 64 samples, bf16 — through encode_frame_signals and
   make_frame_renderer for a few frames of the synthetic scene with seeded
   random weights; check the frames, compare one with the plain version,
   check that the kernel launched once per frame, and time it;
4. cross-check the two hand-written paths: the pair kernels with every
   (tile, slab) listed, the far kernels, deferred_composite and bg_blend
   against the dense kernel on that frame;
5. drive the pair-compacted serving path (BASELINE config 3's recipe, its
   serving levers switched off) for 16 frames across two flag
   refreshes; check the flags are mixed and equal to flags built with
   widened float32 products, the frames, a refresh frame and a steady frame
   against the plain versions, and the launches per steady frame
   (pair_field 2, far_head 1, far_torso 1); time the frames and each stage;
6. the pair path after a contribution prune that drops tiles from the union
   and every pair of one field: a steady frame against the plain versions;
7. hold pair_field at 4 samples per slab and pair2_field at 4 and 8 (two
   pairs per block; 4 is occ_pack2's half-slab) against their plain
   versions at a 450x450 frame's rays and 64 samples (head and torso, relu
   and softplus, a list with gaps and an odd K, K = 1, K = 0), and pair2's
   A and B outputs against pair_field's at the same slab size on the A and
   B lists bit for bit; then pair2_field at sp=8 through its entry point on
   5's sp=8 lists (launches counted from zero, against the plain version
   and pair_field bit for bit) and timed beside pair_field at sp=8 on those
   lists;
8. drive the pair path with occ_pack2 (the recipe, scene and weights of 5)
   for 16 frames across two refreshes: flags [2, 841, 16] against widened
   float32 ones, the A/B flag partitions, launches per frame (steady:
   pair2_field 2, far_head 1, far_torso 1; refresh: pair_field at sp=4 2),
   no host sync in a steady frame, a refresh and a steady frame against the
   plain versions; frame times beside 5's, listed samples, the error of
   both paths against the dense no-skip frames; each kernel's time;
9. refresh_union with occ_pack2 over a window of 4 frames: the pinned union,
   then per-frame slots (render(..., window_slot=i)), with prep seconds, ms
   per frame and every slot frame against the plain versions;
10. drive BASELINE config 3's offline serving config (cfg1 of
   benchmarks/serve_trained.py:246-259, verbatim: the colour-keyed budget
   refined over two rounds with verify-and-revert, far_skip_tol,
   far_subsample=8, occ_prune_carry) on the recipe of 5: refresh_union with
   per-frame slots over a window of 4 (prep seconds; each slot's pairs,
   refinement, reverted tiles, far_skip; the budget must drop pairs beyond
   the trans prune alone), 8 window_slot frames (pair_field 2 launches, the
   far kernels 1 + 1 on the 3,364-row subgrid or none under far_skip, no
   host sync), a renderer with far_skip_tol 0 whose frames run the far
   kernels at 3,364 rows, and the live path refreshing every 4 frames
   (full, carried x3, full); slot, forced-far, carried-refresh and steady
   frames against the plain versions; errors against the dense no-skip
   frames printed;
11. drive BASELINE config 3's live serving config (cfg2 of
   benchmarks/serve_trained.py:313-321, verbatim: cfg1 with the async
   refresh worker every 4 frames, carry off, the decayed prune history and
   the served frames' own prune keys) on the recipe, scene and weights of
   10: 17 warm frames, unpaced frames timed as bench_fps times them (ms per
   frame, spread, swaps), the paced protocol at 25 fps with a ring of 4
   frames in flight (32 settle + 60 measured frames: misses, swaps, each
   frame's error against the dense no-skip frames), every served frame
   under sync debug mode "error" and launching pair_field twice (and the
   far kernels once each where its state keeps the far plane), a frame
   just after a swap against the plain versions; a renderer at budget 2e-2
   whose worker is joined after each frame prints the pairs each derive
   drops, and a keys derive must drop some; the worker must never raise
   and a swap must land in the paced window;
12. drive BASELINE config 4, audio to video (benchmarks/serve_trained.py:
   490-640 over cfg2): the audio nets at full width on the card and on the
   CPU, same module and same synthesized 3.6 s wav (mel within 1e-4; the
   wav2exp features and the DeepSpeech logits and features, n_hidden 2048,
   within rtol 1e-4 / atol 1e-4; each stage's ms); e2e_audio_video over
   cfg2 on the recipe, scene and weights of 11 at 40 frames (stage
   seconds, fps_e2e, render_fps, swaps), every driven frame under sync debug
   mode "error" and launching pair_field twice (the far kernels once each
   where its state keeps the far plane), the .y4m read back (header, 40
   frames of 450x450, Y' within 1 of the frames' luma), a frame after a
   swap against the plain versions; then 2 dense frames (render_rays
   <1,1,1>) driven by the card's DeepSpeech features through AudioNet, their
   signals within 1e-5 of the CPU's;
13. hold the hierarchical head render's kernels (sigma_head, render_head,
   pair_sigma, pair_field_perz) against their plain versions at a 450x450
   frame's rays and 64 + 128 samples, with ERT slab counts, exact zeros in
   clear slabs, pair lists with gaps and empty ones; cross-check the pair
   kernels with every pair listed against the dense kernels (pair_sigma
   against sigma_head bit for bit);
14. drive the hierarchical render (BASELINE config 2) through
   encode_frame_signals and make_head_hierarchical_renderer: no-skip for 5
   frames (sigma_head and render_head once per frame), then the
   pair-compacted serving recipe for 12 frames across three refreshes
   (pair_sigma and pair_field_perz once per steady frame, no host sync);
   check the frames, the flags and lists, a frame of each kind against the
   plain versions; time the frames, each stage and each kernel;
15. hold the six render_rays instantiations (both fields, the head only and
   the torso only with the background in the kernel; the epilogue mode
   with both fields, the head only, the torso only) and far_joint against
   their plain versions at a 450x450 frame's rays and 64 samples (flags
   with gaps, tiles without a flag, a saturating field for ERT but with
   the torso only and the background) and far_joint (77, 4096, 4173 rays and
   the frame's, relu and softplus), far_joint also against far_head +
   far_torso bit for bit;
16. drive the shipped serving config (configs/obama_serve_tpu.json) through
   encode_frame_signals and make_frame_renderer: its tile-class branch for
   12 frames across three refreshes (one render_rays per non-empty class
   segment in a steady frame, no host sync), then its plain occupancy branch
   (tile compaction off) for 6 frames (one render_rays per steady frame);
   check the classes, the flags, a refresh and a steady frame of each branch
   against the plain versions; print each branch's error against the dense
   no-skip frames; time the frames, each stage and each segment's kernel;
17. the tile-class branch with its epilogue in its kernel form
   (bg_epilogue_fused, one far_joint per epilogue) against the shipped
   epilogue; far_joint's times;
18. train, the second half of the main path, at benchmarks/serve_trained.py
   run()'s shape (softplus, 64 samples, bf16, 2048 rays, distortion 3e-3 from
   step 2000): the synthetic scene's ground truth (8 frames, 450x450) built
   on the card and one frame held against the CPU (1 LSB); one float32 step
   (TF32 off) on the card against the same step on the CPU (rtol 1e-4);
   60 steps through train_loop from the seed's weights (loss falling below
   0.6x, the checkpoint read back bit for bit); warm ms per step with the
   distortion term off and on under sync debug mode "error", the peak
   memory and the recipe's projected time; a held-out frame of the trained
   weights from render_rays against the unfused float32 renderer, with the
   val PSNR of both (render_rays' launches join its entry below);
19. 18's trained state written as a reference {:06d}.tar and read back
   onto the card with load_reference_checkpoint (every tensor bit for bit);
   8 frames over driving_manifest's poses (param_scale 0.5) and 8 over
   multi_window_manifest's (window 3) through render_video_frames, the dense
   render_rays once a frame, timed; frame 0's kernel against the plain
   version; the same frame through fused_render_rays with the head only and
   the torso only with the background in the kernel, one launch each,
   against the plain version and timed (phase_reference_ckpt);
20. BASELINE config 5 and the rest of training, on 18's scene: through
   initialize (an NCCL process group of one rank) and make_mesh, one
   sharded step bit for bit against TrainStep.step_on_batch on the same
   batch (distortion and clip off; the signal nets, which the reference's
   sharded step never trains, left as they were), a float32 sharded step
   against the same step on the CPU (gloo, rtol 1e-4), warm ms per step
   beside TrainStep's and the all-reduce's own ms; multi-identity training
   of 2 objects (a second scene, seed 1, 4 frames), static and dynamic
   speaker (speaking frames mixing both branches), each MULTI_STEPS steps
   with the loss falling below 0.6x and warm ms per step, then a held-out
   frame of object 0 from render_rays against the unfused float32 field;
   the sparsity prior's three modes, a float32 step each against the CPU
   (same draws, rtol 1e-4) and warm bf16 ms per step beside the step
   without it; an 8-frame identity directory written with OpenCV (JPEG,
   manifests, features) and loaded (every frame equal to cv2.imread's),
   cli train --datadir and cli render --test-file on it (450x450 frames,
   render_rays once a frame). Every timed step runs under sync debug mode
   "error";
21. the preprocessing DAG (pipeline/driver.py), steps 2-11 of the BA
   variant on the card over a seeded identity (PROCESS_FRAMES frames of
   the synthetic scene at 512x512, a 16 kHz wav), seeded assets with two
   last-layer biases raised in the saved checkpoints (write_process_assets
   says which and why) and a seeded 3DMM at the basis's full size, at the
   shipped widths, ref_id, crops, score threshold and iteration counts;
   each step's seconds beside the card's name and power limit; fails
   unless every step did work (detections, landmarks and eyes, head and
   background pixels, mined keypoints, a fit, a bundle adjustment that
   lowers its loss); the directory through load_audface_dataset; the
   nets' outputs, decoded landmarks, parsing classes (near-ties excepted),
   flow and a 50-step fit on the card against the port's CPU path;
22. the preprocessing tools outside the DAG (phase_tracking_tools): photometric
   refinement (4 frames at 512x512, 50 steps) on the seeded full-size 3DMM
   laid out as a sheet, card against CPU, ms a step; the masked NMS on the
   card and the host C++ NMS on 300 boxes with tied scores, both equal to a
   numpy oracle; 10 heatmap train steps on the eye net (the first against
   the CPU) and a temporal sequence over two videos; 10 distangler train
   steps (the first against the CPU) and the mouth-keypoint net in both
   modes; a legacy FaceNeRF forward; a float32 gauss-PE train step against
   the CPU;
23. the landmark model zoo (phase_zoo): every family of
   models/perception/{mobilenet,shufflenet,u2net,ghostnet_face,
   zoo_extra}.py at the reference's default widths and input sizes,
   RAFT-basic on a 320x240 crop pair and ImportanceWeights, seeded: 2
   images on the card against the port's CPU path (TF32 off), a batch of
   16 timed; three architectures of the landmark export (eye,
   face_ghostnet, U^2-Net small) written from seeded checkpoints and read
   back onto the card with load_exported bit for bit;
24. print the script's total time, the card's name and power limit, then
   one JSON line listing every ported kernel with its launches, error and
   times, and last a JSON status line.

Imports torch, numpy and dfanerf_torch only. Exits non-zero, printing no
result, when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import contextlib
import glob
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import warnings

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()  # the script's start, for its total time
H = W = 450
N_SAMPLES = 64
N_FRAMES = 5
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
# Kernel vs plain version, both on the card. They round activations to
# bf16 at the same points and run the same fp32 recurrences; what differs is
# the order of the fp32 sums inside the products and ulp-level sinf/expf
# differences, which can flip one bf16 rounding. One flipped rounding moves
# a colour by ~1e-4 where a single sample carries the whole ray (measured
# 1.06e-4 on the saturating-field case below, on an H100), so the head stack
# is bounded at 5e-4 in max and tightly in mean. The composite stack's
# last-sample background blend c_mix = (sh*bc + 1e-6*ct) / (sh + 1e-6), with
# alpha 1, moves by 1e-6 * |bc - ct| / (sh + 1e-6)**2 per unit change of the
# head's far-plane density sh. Where sh >= BLEND_SH_MIN that gain is below 1,
# so the composite is held to the head's max bound there. Below it the blend
# swings between background and torso colour (random weights give sh ~1e-6),
# so a flipped rounding moves a pixel by up to its remaining transmittance;
# those pixels are bounded in the mean, as in tests/test_ops.py:81-100, and
# their count and the worst one's sh and error are printed.
BLEND_SH_MIN = 1e-3
# Torso only with the background in the kernel: the composite's final sample
# is the torso colour at the far plane, and it carries the transmittance left
# before it (t_far). On trained weights that colour is where kernel and plain
# version part: perf/probe_torso_bg.py (on an H100) found the kernel's
# final-sample colour equal to far_torso's on the same rays (1.5e-7, the
# probe's division) and the plain version's to far_torso_reference's, the
# two pairs 2.6e-3 apart at most (3.3e-4 on the serving path's random
# weights) while bf16 itself is 9.2e-3 from float32 activations there (5.8e-4
# on random weights). So pixels with t_far >= FAR_CARRIED are held to
# FAR_MAX, set between the largest sound reading (4.05e-3) and a
# lower-precision control (every product rounded to bf16 before its bias:
# 9.9e-3), with at most FAR_OVER_SHARE of them above TOL["com_max"] (0.28%
# sound, 65% in that control); and every pixel's difference less t_far x
# (far_torso - far_torso_reference) is held to TOL["com_max"].
FAR_CARRIED, FAR_MAX, FAR_OVER_SHARE = 0.05, 6e-3, 1e-2
TOL = {"head_max": 5e-4, "head_mean": 1e-6, "com_max": 5e-4, "com_mean": 5e-5}
# Pair and far kernels vs their plain versions, both on the card. As above,
# sum order and ulp-level sin/exp differences flip an occasional bf16
# activation, which moves a density by a few 1e-4 (measured up to 3.9e-4 on
# the CPU, port vs reference, tests/test_torch_pair_field.py). Densities are
# held relatively, |d sigma| <= SIG_RTOL * (|sigma| + SIG_FLOOR), since they
# range from ~1e-2 (relu, random init) to ~1 (softplus); the pair kernels
# store colours in bf16, so those may differ by at most RGB_ULPS bf16 ulp
# (2**-8 relative: a flipped rounding of the stored value); the far-plane
# torso colour is float32 and held to the head's max bound.
SIG_RTOL, SIG_FLOOR, RGB_ULPS = 2e-2, 5e-2, 1.0
# Ray counts the far kernels are held at beside a frame's: fewer than one of
# their 128-ray chunks, whole chunks, a ragged last chunk, and a 450x450
# frame's far_subsample=8 subgrid (841 tiles x 4 cells: 26 chunks and a
# ragged one).
FAR_COUNTS = (77, 4096, 4096 + 77, 3364)
# The occupancy flags decide which pairs are rendered at all, and on the card
# their node densities come from the node-grid kernel (csrc/node_grid.cu:
# bf16 products on the tensor cores). Each refresh's flags are rebuilt from
# the same inputs through the plain version of the grid
# (occupancy.node_density_reference) with the products widened to float32
# (the branch the CPU tests hold against the reference) and compared node by
# node. The two differ in float32 sum order and the kernel's PE rounding,
# which can flip a bf16 activation and move a node density by a few 1e-4
# (4.2e-4 measured, port vs reference on the CPU, and 5.6e-4, the kernel's
# semantics vs the plain grid, tests/test_torch_occupancy.py), so a node may take the other
# side of the threshold sigma_thresh / 4 only where it lies within NODE_TOL
# of it.
NODE_TOL = 1e-3


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _errors(a, b):
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


def _pair_bytes(k_u, K, sp, weights):
    """Bytes a pair kernel must move over K listed pairs of k_u gathered
    tiles (256 rays each) at sp samples per slab: the rays and view bias,
    the depths, the pair list, the weight and bias blobs, and the listed
    blocks of the four output buffers."""
    w, b = weights
    return (2 * k_u * 256 * 3 * 4 + k_u * 256 * 256 * 2 + N_SAMPLES * 4 + 2 * K * 4
            + w.numel() * 2 + b.numel() * 4 + K * sp * 256 * (4 + 3 * 2))


def _check_pair(tag, head, com, head_ref, com_ref, sh_last, far=None):
    """Kernel vs plain version; sh_last is the plain version's head density
    at the final sample, one per pixel: where it is below BLEND_SH_MIN the
    composite's last-sample blend is ill-conditioned, and those pixels are
    held in the mean. Without the head field, ``far`` is (t_far, the
    transmittance before the final sample; d_far, far_torso's colour less
    its plain version's on the same rays, _far_torso_delta): the blend is
    exact, pixels with t_far >= FAR_CARRIED are held to FAR_MAX and
    FAR_OVER_SHARE, and every pixel's difference less t_far x d_far to
    TOL["com_max"]. Returns the largest error of the values held to a max
    bound."""
    hm, ha = _errors(head, head_ref)
    _, ca = _errors(com, com_ref)
    com_err = (com - com_ref).abs().amax(dim=-1)
    if far is None:
        cond, good, name, what = sh_last, sh_last >= BLEND_SH_MIN, "sh", f">= {BLEND_SH_MIN:.0e}"
        rest = 0.0
    else:
        t_far, d_far = far
        cond, good, name, what = t_far, t_far < FAR_CARRIED, "t_far", f"< {FAR_CARRIED}"
        rest = float((com - com_ref - t_far[:, None] * d_far).abs().max())
    cm = float(com_err[good].max()) if good.any() else 0.0
    n_ill = int((~good).sum())
    n_over = int((com_err[~good] > TOL["com_max"]).sum())
    ill = ""
    if n_ill:
        worst = torch.where(good, torch.full_like(com_err, -1.0), com_err).argmax()
        ill = (f"; {n_ill} pixels without {name} {what}, {n_over} of them above "
               f"{TOL['com_max']:.0e}: worst com err {float(com_err.flatten()[worst]):.3e} at "
               f"{name} {float(cond.flatten()[worst]):.3e}"
               + (f" (tol {FAR_MAX:.0e}, {FAR_OVER_SHARE:.0%} above)" if far is not None else ""))
    if far is not None:
        ill += (f"; less t_far x (far_torso - its plain version) max {rest:.3e} on all (tol "
                f"{TOL['com_max']:.0e})")
    print(f"[{tag}] head max {hm:.3e} mean {ha:.3e} (tol {TOL['head_max']:.0e}/"
          f"{TOL['head_mean']:.0e}); com max {cm:.3e} on {int(good.sum())} pixels with {name} "
          f"{what} (tol {TOL['com_max']:.0e}), mean {ca:.3e} on all (tol "
          f"{TOL['com_mean']:.0e}){ill}", flush=True)
    if not (torch.isfinite(head).all() and torch.isfinite(com).all()):
        _fail(f"{tag}: non-finite output")
    far_max = float(com_err[~good].max()) if far is not None and n_ill else 0.0
    far_bad = far_max > FAR_MAX or n_over > FAR_OVER_SHARE * n_ill or not rest <= TOL["com_max"]
    if (hm > TOL["head_max"] or ha > TOL["head_mean"] or cm > TOL["com_max"]
            or ca > TOL["com_mean"] or (far is not None and far_bad)):
        _fail(f"{tag}: kernel disagrees with its plain version")
    return max(hm, cm, far_max)


def _far_torso_delta(ops, n):
    """far_torso less its plain version at the final depth of ``ops``, on
    its first n rays with its torso weights and view bias: [n, 3]."""
    from dfanerf_torch.ops.far_eval import far_torso_kernel, far_torso_reference

    args = (ops.packed_t, ops.rays_o_t[:n], ops.rays_d_t[:n], float(ops.z_vals[-1]),
            ops.vr_t[:n])
    return far_torso_kernel(*args, act=ops.act) - far_torso_reference(*args, ops.act)


def _check_image(tag, img):
    if img.shape != (H, W, 3) or not torch.isfinite(img).all():
        _fail(f"{tag}: shape {tuple(img.shape)} or non-finite values")
    lo, hi = float(img.min()), float(img.max())
    if lo < -1e-6 or hi > 1.0 + 1e-5:
        _fail(f"{tag}: values in [{lo}, {hi}], outside [0, 1]")


def _check_frame(tag, head, com):
    for name, img in (("head", head), ("com", com)):
        _check_image(f"{tag} {name}", img)


def _l2_rate(fields, chunks, ms, color=True) -> float:
    """The L2 weight rate (TB/s) of a kernel of the wgmma core: the staged
    weight bytes of its fields that its 128-row chunks stream (the trunk's
    and the sigma rows only for a density-only kernel, color=False), over
    its time."""
    from dfanerf_torch.ops._build import staged_weight_bytes

    return (sum(staged_weight_bytes(f, color) for f in fields) * chunks / (ms * 1e-3)
            / 1e12)


def _far_l2_rate(kernel, n, ms) -> float:
    """_l2_rate of a far kernel over n rays (128-ray chunks): far_head
    streams the head's density-only chunk, far_torso the torso's staged blob
    (its unread sigma rows, 4 KB of 1.38 MB, counted), far_joint both."""
    chunks = -(-n // 128)
    head = _l2_rate(("head",), chunks, ms, color=False)
    torso = _l2_rate(("torso",), chunks, ms)
    return {"far_head": head, "far_torso": torso, "far_joint": head + torso}[kernel]


def _cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cuda_call(fn):
    """(fn(), its time in ms by CUDA events): one call, for the slow plain
    versions, whose output is kept for the comparison."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# The libraries whose kernels run the wgmma core (csrc/field_wgmma.cuh):
# each of their kernels must hold HGMMA instructions, and ptxas must not
# have serialised their wgmma.
WGMMA_LIBRARIES = ("render_rays", "pair_field", "render_head", "pair_perz", "sigma_head",
                   "pair_hier", "far_eval", "node_grid")
RENDER_INSTANTIATIONS = 6  # render_rays_kernel<EVAL_H, EVAL_T, BG_IN_KERNEL>: every combination
WGMMA_KERNELS = ("render_rays_kernel", "pair_field_kernel", "pair2_field_kernel",
                 "render_head_kernel", "pair_field_perz_kernel", "sigma_head_kernel",
                 "pair_sigma_kernel", "far_head_kernel", "far_torso_kernel", "far_joint_kernel",
                 "node_grid_kernel")


def _cuobjdump():
    """cuobjdump of the CUDA toolkit, or the copy Triton's package carries."""
    import shutil

    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    if shutil.which("cuobjdump"):
        return shutil.which("cuobjdump")
    try:
        import triton
    except ImportError:
        return None
    path = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")
    return path if os.path.exists(path) else None


def _sass_counts(tool, path):
    """{kernel function (demangled where c++filt is found): [HGMMA, HMMA]}
    counted in the library's SASS."""
    import re
    import shutil

    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = re.match(r"\s*Function : (\S+)", line).group(1)
            counts[current] = [0, 0]
        elif current is not None and "MMA" in line:
            counts[current][0] += "HGMMA" in line
            counts[current][1] += "HMMA" in line
    if shutil.which("c++filt") and counts:
        names = subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


def phase_build():
    from dfanerf_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    seconds = time.perf_counter() - t0
    print(f"[build] {len(_build.SOURCES)} kernel(s) built in {seconds:.1f} s", flush=True)
    tool = _cuobjdump()
    if tool is None:
        _fail("no cuobjdump (CUDA toolkit or Triton's copy) to read the kernels' SASS")
    import concurrent.futures

    # every library's SASS read at once (one cuobjdump process each)
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        sass = dict(zip(_build.SOURCES, pool.map(
            lambda name: _sass_counts(tool, _build.library_path(name)), _build.SOURCES)))
    for name in _build.SOURCES:
        path = _build.library_path(name)
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        for line in lines:
            if any(w in line for w in ("registers", "spill", "stack", "Function properties")):
                print(f"[build] {name}: {line.strip()}", flush=True)
        serialised = [line.strip() for line in lines
                      if "wgmma" in line.lower() and "serializ" in line.lower()]
        for line in serialised:
            print(f"[build] {name}: wgmma serialisation: {line}", flush=True)
        for fn, (hgmma, hmma) in sass[name].items():
            print(f"[build] {name}: {fn}: {hgmma} HGMMA, {hmma} HMMA", flush=True)
            if name in WGMMA_LIBRARIES and any(k in fn for k in WGMMA_KERNELS) and hgmma == 0:
                _fail(f"{name}: {fn} holds no HGMMA: it does not run the wgmma core")
        if name in WGMMA_LIBRARIES and serialised:
            _fail(f"{name}: ptxas serialised its wgmma")
    n_render = sum("render_rays_kernel" in fn for fn in sass["render_rays"])
    print(f"[build] render_rays: {n_render} instantiations of render_rays_kernel", flush=True)
    if n_render != RENDER_INSTANTIATIONS:
        _fail(f"render_rays holds {n_render} instantiations, not {RENDER_INSTANTIATIONS}")


def phase_kernel_vs_plain():
    """Full width, seeded bf16 packed weights, 4 tiles x 64 samples."""
    from dfanerf_torch.models import Decoder, DecoderConfig
    from dfanerf_torch.models.layers import init_uniform_
    from dfanerf_torch.ops.fused_render import (
        fused_render_rays_reference, prepare_render_operands, render_rays_kernel,
    )
    from dfanerf_torch.ops.pack import pack_field_weights

    g = torch.Generator().manual_seed(1)
    dec = init_uniform_(Decoder(DecoderConfig()), g).cuda()

    def rn(*shape):
        return torch.randn(*shape, generator=g).cuda()

    vecs = [rn(96), rn(42), rn(256), rn(256)]
    n = 4 * 256
    rays = [rn(n, 3) * 0.05, rn(n, 3) * 0.2 + torch.tensor([0.0, 0.0, -1.0]).cuda(),
            rn(n, 3) * 0.05, rn(n, 3) * 0.2 + torch.tensor([0.0, 0.0, -1.0]).cuda()]
    bc = torch.rand(n, 3, generator=g).cuda()
    z = torch.linspace(0.3, 0.9, N_SAMPLES).cuda()
    flags = torch.ones((4, N_SAMPLES // 8), dtype=torch.int32)
    flags[0, 1:4] = 0
    flags[2, ::2] = 0

    def packs(decoder):
        return (pack_field_weights(decoder, vecs[0], vecs[2], vecs[3], "head"),
                pack_field_weights(decoder, vecs[1], vecs[2], vecs[3], "torso"))

    saturating = init_uniform_(Decoder(DecoderConfig()), torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        saturating.sigma_out.bias.fill_(200.0)
    cases = [("ert_eps=0", packs(dec), 0.0, None, "relu"),
             ("ert_eps=1e-4 saturating field", packs(saturating), 1e-4, None, "relu"),
             ("occupancy flags with zeros", packs(dec), 0.0, flags, "relu"),
             ("softplus density", packs(dec), 0.0, None, "softplus")]
    worst = 0.0
    for tag, (pw_h, pw_t), eps, occ, act in cases:
        ops = prepare_render_operands(pw_h, pw_t, *rays, z, bc, 1e10, eps, occ, act)
        head, com, slabs = render_rays_kernel(ops)
        torch.cuda.synchronize()
        head_r, com_r, slabs_r, sh_last, _ = fused_render_rays_reference(ops)
        torch.cuda.synchronize()
        worst = max(worst, _check_pair(f"kernel vs plain, {tag}", head, com, head_r, com_r,
                                       sh_last))
        if not torch.equal(slabs, slabs_r):
            _fail(f"{tag}: slabs run {slabs.tolist()} != plain {slabs_r.tolist()}")
        print(f"[kernel vs plain, {tag}] slabs run per tile {slabs.tolist()}", flush=True)
    return worst


def phase_main_path():
    """The dense fused frame render at full width through the entry points."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.data.synthetic import make_synthetic_scene
    from dfanerf_torch.ops.fused_render import (
        R_T, fused_render_rays_reference, prepare_render_operands, render_flops_per_sample,
        render_rays_kernel, spatial_untile,
    )
    from dfanerf_torch.train.state import init_train_state

    cfg = ExperimentConfig(render=RenderConfig(
        n_samples=N_SAMPLES, concate_bg=True, compute_dtype="bfloat16", use_fused_kernel=True,
        spatial_tiles=True))
    scene = make_synthetic_scene(n_frames=8, H=H, W=W, seed=0)
    state = init_train_state(cfg, seed=0, device="cuda")
    params = state["params"]
    auds, exps, poses = (torch.from_numpy(x).cuda() for x in (scene.auds, scene.exps, scene.poses))
    bc_img = torch.from_numpy(scene.bc_img).cuda()
    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)

    def frame(i):
        sig, sig_t = renderer.encode_frame_signals(params, auds, exps, poses, i, scene.n_frames,
                                                   cfg, True)
        return render(params, state["z_shape"], state["z_app"], poses[i], poses[0], sig, sig_t,
                      bc_img)

    frame(0)  # warm-up
    torch.cuda.synchronize()
    render_rays_kernel.launches = 0
    frames = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(N_FRAMES):
        frames.append(frame(i))
    end.record()
    torch.cuda.synchronize()
    launches = render_rays_kernel.launches
    ms_frame = start.elapsed_time(end) / N_FRAMES
    print(f"[main path] {N_FRAMES} frames {H}x{W}, {N_SAMPLES} samples, head+torso: "
          f"{ms_frame:.2f} ms per frame (CUDA events, warm); render_rays launches {launches}",
          flush=True)
    if launches != N_FRAMES:
        _fail(f"render_rays launched {launches} times for {N_FRAMES} frames")
    for i, (head, com) in enumerate(frames):
        _check_frame(f"frame {i}", head, com)
    print(f"[main path] frames finite, in [0, 1]; frame 0 com mean "
          f"{float(frames[0][1].mean()):.4f}", flush=True)

    # frame 0 again through the plain version on the card, same inputs
    captured = {}
    real = renderer.fused_render_rays

    def plain_fused(*args, **kw):
        ops = prepare_render_operands(*args, **kw)
        captured["ops"] = ops
        (head, com, _, sh_last, _), captured["plain_ms"] = _cuda_call(
            lambda: fused_render_rays_reference(ops))
        n = args[2].shape[0]
        captured["sh_last"] = spatial_untile(sh_last[:n, None], H, W)[..., 0]
        return head[:n], com[:n]

    renderer.fused_render_rays = plain_fused
    try:
        head_r, com_r = frame(0)
    finally:
        renderer.fused_render_rays = real
    torch.cuda.synchronize()
    err = _check_pair("main path frame 0, kernel vs plain", frames[0][0], frames[0][1],
                      head_r, com_r, captured["sh_last"])

    # the kernel and its plain version at the main path's shapes
    ops = captured["ops"]
    _, _, slabs = render_rays_kernel(ops)
    ms = _cuda_ms(lambda: render_rays_kernel(ops), 5)
    plain_ms = captured["plain_ms"]
    n_pad = ops.n_tiles * R_T
    S = ops.z_vals.numel()
    flops = float(slabs.sum()) * 8 * R_T * render_flops_per_sample()
    weights = sum(t.numel() * t.element_size() for pw in (ops.packed_h, ops.packed_t)
                  for k, t in pw.items() if k not in ("w_view", "b_view"))
    n_bytes = (4 * n_pad * 3 * 4 + S * 4 + 2 * S * n_pad * 4 + 2 * n_pad * 256 * 2
               + n_pad * 3 * 4 + ops.occ.numel() * 4 + weights + 2 * n_pad * 3 * 4
               + ops.n_tiles * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    print(f"[main path] render_rays {ms:.3f} ms per launch; plain version {plain_ms:.1f} ms; "
          f"slabs run {int(slabs.sum())} of {ops.n_tiles * ops.n_slabs}; {flops / 1e12:.2f} "
          f"TFLOP at live widths -> {t_ops:.3f} ms at bf16 peak ({flops / ms / 1e9:.1f} "
          f"TFLOP/s achieved); {n_bytes / 1e6:.1f} MB -> {t_bytes:.3f} ms at HBM peak; L2 "
          f"weight rate {_l2_rate(('head', 'torso'), float(slabs.sum()) * 16, ms):.3f} TB/s",
          flush=True)
    return {
        "name": "render_rays", "route": "cuda",
        "source": "dfanerf_torch/ops/csrc/render_rays.cu",
        "replaces": "dfanerf_tpu/ops/fused_render.py:167",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }, ops


def _sigma_rel(got, ref):
    """Largest |d sigma| / (|sigma| + SIG_FLOOR)."""
    return float(((got - ref).abs() / (ref.abs() + SIG_FLOOR)).max()) if ref.numel() else 0.0


def _bf16_ulps(got, ref):
    """|got - ref| in bf16 ulps of ref (bf16 keeps 8 significant bits)."""
    step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    return (got.float() - ref.float()).abs() / step


def _listed_mask(J, n_tiles, t_idx, j_idx, device, sp=8):
    """[J, sp, (n_tiles + 1) * 256] bool: the buffer blocks the pairs list."""
    m = torch.zeros((J, sp, n_tiles + 1, 256), dtype=torch.bool, device=device)
    m[j_idx.long(), :, t_idx.long(), :] = True
    return m.reshape(J, sp, -1)


def _check_buffers(tag, got, ref, listed):
    """pair_field kernel vs plain on the listed blocks. Returns the largest
    absolute difference of the four channels."""
    sg, sr = got[0][listed], ref[0][listed]
    rel = _sigma_rel(sg, sr)
    ulps = [_bf16_ulps(g[listed], r[listed]) for g, r in zip(got[1:], ref[1:])]
    n_off = sum(int((u > 0).sum()) for u in ulps)
    worst_ulps = max(float(u.max()) for u in ulps)
    abs_err = max([float((sg - sr).abs().max())]
                  + [float((g[listed].float() - r[listed].float()).abs().max())
                     for g, r in zip(got[1:], ref[1:])])
    print(f"[{tag}] sigma max rel err {rel:.3e} (tol {SIG_RTOL:.0e} of |sigma| + {SIG_FLOOR:.0e}),"
          f" abs {float((sg - sr).abs().max()):.3e}; rgb max {worst_ulps:.0f} bf16 ulp (tol "
          f"{RGB_ULPS:.0f}), {n_off} of {3 * sg.numel()} entries differ", flush=True)
    if not all(torch.isfinite(g[listed].float()).all() for g in got):
        _fail(f"{tag}: non-finite values in listed blocks")
    if rel > SIG_RTOL or worst_ulps > RGB_ULPS:
        _fail(f"{tag}: kernel disagrees with its plain version")
    return abs_err


def _check_far(tag, sh, ct, sh_ref, ct_ref):
    rel = _sigma_rel(sh, sh_ref)
    ct_err = float((ct - ct_ref).abs().max())
    print(f"[{tag}] sh max rel err {rel:.3e} (tol {SIG_RTOL:.0e} of |sh| + {SIG_FLOOR:.0e}), abs "
          f"{float((sh - sh_ref).abs().max()):.3e}; ct max {ct_err:.3e} mean "
          f"{float((ct - ct_ref).abs().mean()):.3e} (tol {TOL['head_max']:.0e})", flush=True)
    if not (torch.isfinite(sh).all() and torch.isfinite(ct).all()):
        _fail(f"{tag}: non-finite output")
    if rel > SIG_RTOL or ct_err > TOL["head_max"]:
        _fail(f"{tag}: kernel disagrees with its plain version")
    return float((sh - sh_ref).abs().max()), ct_err


def phase_pair_kernels_vs_plain():
    """pair_field (head, torso; relu, softplus; a pair list with gaps and an
    empty one) and far_head / far_torso (under one chunk, whole chunks, a
    ragged last chunk), full width, seeded bf16 packed weights."""
    from dfanerf_torch.models import Decoder, DecoderConfig
    from dfanerf_torch.models.layers import init_uniform_
    from dfanerf_torch.ops.far_eval import (
        far_eval_reference, far_head_kernel, far_torso_kernel,
    )
    from dfanerf_torch.ops.fused_render import view_bias
    from dfanerf_torch.ops.pack import pack_field_weights
    from dfanerf_torch.ops.pair_field import (
        pair_field_eval_prepped, pair_field_eval_reference, pair_field_kernel,
    )

    g = torch.Generator().manual_seed(2)
    dec = init_uniform_(Decoder(DecoderConfig()), g).cuda()

    def rn(*shape):
        return torch.randn(*shape, generator=g).cuda()

    def rays(n):
        return (rn(n, 3) * 0.05).contiguous(), (rn(n, 3) * 0.2 + torch.tensor(
            [0.0, 0.0, -1.0]).cuda()).contiguous()

    vecs = [rn(96), rn(42), rn(256), rn(256)]
    z = torch.linspace(0.3, 0.9, N_SAMPLES).cuda()
    T, J = 4, N_SAMPLES // 8
    flags = torch.rand((T, J), generator=g) < 0.5
    t_idx, j_idx = (x.to(torch.int32).cuda() for x in flags.nonzero(as_tuple=True))
    listed = _listed_mask(J, T, t_idx, j_idx, "cuda")
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    print(f"[pair_field vs plain] {t_idx.numel()} of {T * J} (tile, slab) pairs listed",
          flush=True)
    packs = {}
    for branch, sig in (("head", vecs[0]), ("torso", vecs[1])):
        pw = packs[branch] = pack_field_weights(dec, sig, vecs[2], vecs[3], branch)
        o, d = rays(T * 256)
        vr = view_bias(pw, d).to(torch.bfloat16).contiguous()
        for act in ("relu", "softplus"):
            got = pair_field_kernel(pw, branch, o, d, vr, z, t_idx, j_idx, act)
            torch.cuda.synchronize()
            ref = pair_field_eval_reference(pw, branch, o, d, vr, z, t_idx, j_idx, act)
            _check_buffers(f"pair_field vs plain, {branch}, {act}", got, ref, listed)
        before = pair_field_kernel.launches
        bufs = pair_field_eval_prepped(pw, branch, o, d, vr, z, empty, empty)
        if pair_field_kernel.launches != before or any(bool(b.float().any()) for b in bufs):
            _fail(f"pair_field with no pairs: a launch or non-zero buffers")
        print(f"[pair_field vs plain, {branch}, no pairs] zero buffers, no launch", flush=True)
    far = float(z[-1])
    # the far kernels' 128-ray chunks: fewer rays than one, whole chunks, a
    # ragged last chunk
    for n in FAR_COUNTS:
        o, d = rays(n)
        o_t, d_t = rays(n)
        vr_t = view_bias(packs["torso"], d_t).to(torch.bfloat16).contiguous()
        for act in ("relu", "softplus"):
            sh = far_head_kernel(packs["head"], o, d, far, act=act)
            ct = far_torso_kernel(packs["torso"], o_t, d_t, far, vr_t, act=act)
            torch.cuda.synchronize()
            sh_r, ct_r = far_eval_reference(packs["head"], packs["torso"], o, d, o_t, d_t, far,
                                            vr_t, act)
            _check_far(f"far kernels vs plain, {n} rays, {act}", sh, ct, sh_r, ct_r)


def phase_pair_vs_dense(ops):
    """Every (tile, slab) listed through the pair and far kernels, composited
    by deferred_composite + bg_blend, against the dense render_rays kernel
    with ert_eps = 0 on the same frame (the dense main path's frame 0): the
    background epilogue and the in-kernel background concat are the same
    math (the reference holds them to 3e-4, tests/test_ops.py:371-386)."""
    from dfanerf_torch.ops.composite import bg_blend, deferred_composite
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.fused_render import render_rays_kernel
    from dfanerf_torch.ops.pair_field import pair_field_kernel

    T, J = ops.n_tiles, ops.n_slabs
    head_d, com_d, _ = render_rays_kernel(dataclasses.replace(ops, ert_eps=0.0))
    t_idx = torch.arange(T, device="cuda").repeat_interleave(J).to(torch.int32)
    j_idx = torch.arange(J, device="cuda").repeat(T).to(torch.int32)
    buf_h = pair_field_kernel(ops.packed_h, "head", ops.rays_o, ops.rays_d, ops.vr_h, ops.z_vals,
                              t_idx, j_idx, ops.act)
    buf_t = pair_field_kernel(ops.packed_t, "torso", ops.rays_o_t, ops.rays_d_t, ops.vr_t,
                              ops.z_vals, t_idx, j_idx, ops.act)
    far = float(ops.z_vals[-1])
    sh = far_head_kernel(ops.packed_h, ops.rays_o, ops.rays_d, far, act=ops.act)
    ct = far_torso_kernel(ops.packed_t, ops.rays_o_t, ops.rays_d_t, far, ops.vr_t, act=ops.act)
    occ = torch.ones((2, T, J), dtype=torch.int32, device="cuda")
    acc = deferred_composite(buf_h, buf_t, occ, ops.rays_d, ops.rays_d_t, ops.z_vals,
                             with_diagnostics=False)
    head, com = bg_blend(sh, ct, ops.rays_d, ops.rays_d_t, ops.bc, 1e10, *acc)
    torch.cuda.synchronize()
    _check_pair(f"pair path (all {T * J} pairs) vs dense kernel, ert_eps=0", head, com, head_d,
                com_d, sh[:, 0])


# Pair-compacted serving path: BASELINE config 3's recipe
# (benchmarks/serve_trained.py:246-257) with its serving levers (budget,
# carry, far_skip, far_subsample) switched off; phase_cfg1 drives them.
PAIR_FRAMES = 16
PAIR_RENDER = dict(n_samples=N_SAMPLES, concate_bg=True, compute_dtype="bfloat16",
                   use_fused_kernel=True, spatial_tiles=True, ert_eps=1e-4, occ_sigma_thresh=2.0,
                   occ_grid_res=96, occ_refresh_every=8, occ_pair_compaction=True,
                   occ_prune_trans=0.1)
# Added to the seeded sigma_out bias. With seed 0's random weights the raw
# head and torso densities vary by only a few 1e-2 around the bias, and
# softplus of the unshifted bias is ~0.69, above the grid's node threshold
# occ_sigma_thresh / 4 = 0.5 everywhere, so every pair would be occupied.
# The shift, -0.4593, puts the node threshold into the upper tail of the
# raw densities (the occupied nodes cluster there), so the flags are mixed:
# measured on an H100 before the prune, frame 0 lists 25% of the head's and
# 75% of the torso's pairs, frame 8 20% and 87% (a search over the shift on
# frame 0's flags; the printed refresh lines show the lists in force).
SIGMA_SHIFT = -0.4593
PAIR_FRACTION = (0.05, 0.95)  # each field's listed share of its T * J pairs


def _pair_state(cfg, shift=SIGMA_SHIFT, head_latent_scale=1.0):
    """The seeded state on the card with the sigma_out bias shifted by
    ``shift`` and the head's shape latent scaled by ``head_latent_scale``."""
    from dfanerf_torch.train.state import init_train_state

    state = init_train_state(cfg, seed=0, device="cuda")
    with torch.no_grad():
        state["params"].decoder.sigma_out.bias += shift
    state["z_shape"][0] *= head_latent_scale
    return state


def _pair_scene(cfg, shift=SIGMA_SHIFT, n_frames=PAIR_FRAMES, head_latent_scale=1.0):
    """(scene, args): the synthetic scene and args(i), frame i's arguments
    to a frame renderer, with the seeded weights' sigma_out bias shifted by
    ``shift`` and the head's shape latent scaled by ``head_latent_scale``."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.data.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(n_frames=n_frames, H=H, W=W, seed=0)
    state = _pair_state(cfg, shift, head_latent_scale)
    params = state["params"]
    auds, exps, poses = (torch.from_numpy(x).cuda() for x in (scene.auds, scene.exps, scene.poses))
    bc_img = torch.from_numpy(scene.bc_img).cuda()

    def args(i):
        sig, sig_t = renderer.encode_frame_signals(params, auds, exps, poses, i, scene.n_frames,
                                                   cfg, True)
        return (params, state["z_shape"], state["z_app"], poses[i], poses[0], sig, sig_t, bc_img)

    return scene, args


@contextlib.contextmanager
def _spy(name, runs):
    """Appends (args, kwargs, result) of every call the renderer makes to
    its function ``name`` (conservative_occupancy: each refresh's unpruned
    flags; deferred_composite: its prune diagnostics)."""
    import dfanerf_torch.render.renderer as renderer

    real = getattr(renderer, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        runs.append((args, kw, out))
        return out

    setattr(renderer, name, spy)
    try:
        yield
    finally:
        setattr(renderer, name, real)


def _far_full(x):
    """Far-plane values of every ray in tile order: as given, or upsampled
    as the renderer does from a far_subsample subgrid."""
    import math

    from dfanerf_torch.render.renderer import far_upsample, far_upsample_matrix

    n_tiles = (-(-H // 16)) * (-(-W // 16))
    if x.shape[0] == n_tiles * 256:
        return x
    ss = 16 // math.isqrt(x.shape[0] // n_tiles)
    return far_upsample(x, torch.from_numpy(far_upsample_matrix(ss)).to(x.device))


@contextlib.contextmanager
def _plain_pair_path(captured):
    """The pair renderer with its kernel calls swapped for their plain
    versions on the card; captured["sh"] takes the plain far-plane head
    density, untiled, for _check_pair."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.ops.far_eval import far_head_reference, far_torso_reference
    from dfanerf_torch.ops.fused_render import view_bias
    from dfanerf_torch.ops.pair_field import (
        pair2_field_eval_prepped, pair2_field_eval_reference, pair_field_eval_prepped,
        pair_field_eval_reference,
    )

    def plain_pair(pw, branch, o, d, z, t_idx, j_idx, act, s_slab=None):
        vr = view_bias(pw, d).to(torch.bfloat16).contiguous()
        if t_idx.numel() == 0:
            return pair_field_eval_prepped(pw, branch, o, d, vr, z, t_idx, j_idx, act, s_slab)
        return pair_field_eval_reference(pw, branch, o, d, vr, z, t_idx, j_idx, act, s_slab)

    def plain_pair2(pw, branch, o, d, z, ta, ja, tb, jb, act, s_slab=4):
        vr = view_bias(pw, d).to(torch.bfloat16).contiguous()
        if ta.numel() == 0:
            return pair2_field_eval_prepped(pw, branch, o, d, vr, z, ta, ja, tb, jb, act, s_slab)
        return pair2_field_eval_reference(pw, branch, o, d, vr, z, ta, ja, tb, jb, act, s_slab)

    def plain_far(pw_h, pw_t, o, d, o_t, d_t, far, act):
        vr_t = view_bias(pw_t, d_t).to(torch.bfloat16).contiguous()
        sh = far_head_reference(pw_h, o, d, far, act)
        captured["sh"] = renderer.spatial_untile(_far_full(sh), H, W)[..., 0]
        return sh, far_torso_reference(pw_t, o_t, d_t, far, vr_t, act)

    names = ("pair_field_eval", "pair2_field_eval", "fused_far_eval_split")
    real = {name: getattr(renderer, name) for name in names}
    for name, fn in zip(names, (plain_pair, plain_pair2, plain_far)):
        setattr(renderer, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(renderer, name, fn)


def _check_flags(tag, occ_args, occ_kw, flags):
    """One refresh's shipped flags [2, T, J] (the node-grid kernel's nodes)
    against the flags of the same inputs through the plain grid with widened
    float32 products (see NODE_TOL)."""
    from unittest import mock

    from dfanerf_torch.ops import fused_render, occupancy

    if torch.backends.cuda.matmul.allow_tf32:
        _fail("TF32 float32 products are on: the widened flags need exact float32 products")
    pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals, sigma_thresh = occ_args
    grid_res, act = occ_kw["grid_res"], occ_kw["act"]
    lo, span, boxes = occupancy.occupancy_boxes(ro, rd, ro_t, rd_t, z_vals, grid_res,
                                                occ_kw.get("s_slab") or 8)
    thr = sigma_thresh * 0.25
    for f, (pw, branch) in enumerate(((pw_h, "head"), (pw_t, "torso"))):
        sig = occupancy.node_density(pw, branch, lo, span, grid_res, act)
        with mock.patch.object(occupancy, "_mm_cast", fused_render._mm_widened):
            sig_w = occupancy.node_density_reference(pw, branch, lo, span, grid_res, act)
        on, on_w = sig > thr, sig_w > thr
        flipped = on != on_w
        n_far = int((flipped & ((sig_w - thr).abs() > NODE_TOL)).sum())
        ship = flags[f].bool()
        wide = occupancy.flags_from_nodes(on_w, *boxes[f])
        print(f"[{tag}] {branch}: {int((ship != wide).sum())} of {ship.numel()} flags differ "
              f"({int((ship & ~wide).sum())} on only in the shipped, {int((wide & ~ship).sum())} "
              f"only in the widened); {int(flipped.sum())} of {on.numel()} nodes on the other "
              f"side of {thr}, {n_far} of them farther than {NODE_TOL:.0e} from it; node "
              f"density max diff {float((sig - sig_w).abs().max()):.3e}", flush=True)
        if not torch.equal(ship, occupancy.flags_from_nodes(on, *boxes[f])):
            _fail(f"{tag}: the shipped {branch} flags are not those of its nodes")
        if n_far:
            _fail(f"{tag}: {n_far} {branch} nodes flip farther than {NODE_TOL:.0e} from the "
                  f"threshold")


def phase_pair_main_path():
    """The pair-compacted serving path at full width through the entry
    points, 16 frames across two refreshes."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.composite import deferred_composite
    from dfanerf_torch.ops.far_eval import (
        far_head_kernel, far_head_reference, far_torso_kernel, far_torso_reference,
    )
    from dfanerf_torch.ops._build import weight_blobs
    from dfanerf_torch.ops.fused_render import R_T, field_flops_per_sample, view_bias
    from dfanerf_torch.ops.occupancy import (
        SUPERSAMPLE, conservative_occupancy, node_grid_kernel, occupancy_boxes,
    )
    from dfanerf_torch.ops.pair_field import pair_field_eval_reference, pair_field_kernel

    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**PAIR_RENDER))
    rcfg = cfg.render
    scene, args = _pair_scene(cfg)
    warm = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    warm(*args(0))
    warm(*args(1))
    torch.cuda.synchronize()

    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    kernels = {"pair_field": pair_field_kernel, "far_head": far_head_kernel,
               "far_torso": far_torso_kernel}
    for k in kernels.values():
        k.launches = 0
    frames, marks, refreshes, flag_runs, syncs = [], [], [], [], 0
    with _spy("conservative_occupancy", flag_runs):
        for i in range(PAIR_FRAMES):
            a = args(i)
            steady = (render.cache["lists"] is not None
                      and render.cache["age"] < rcfg.occ_refresh_every)
            before = {name: k.launches for name, k in kernels.items()}
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if steady:
                    torch.cuda.set_sync_debug_mode("warn")
                e0.record()
                frames.append(render(*a))
                e1.record()
                torch.cuda.set_sync_debug_mode("default")
            syncs += sum("synchroniz" in str(w.message) for w in caught) if steady else 0
            marks.append((steady, e0, e1, {n: k.launches - before[n] for n, k in kernels.items()}))
            if not steady:
                c = render.cache
                refreshes.append((i, c["lists"][0][0].numel(), c["lists"][1][0].numel(),
                                  len(c["tiles_u"]), c["occ"].shape[1], c["occ"].shape[2]))
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    steady_ms = [e0.elapsed_time(e1) for st, e0, e1, _ in marks if st]
    refresh_ms = [e0.elapsed_time(e1) for st, e0, e1, _ in marks if not st]
    for i, k_h, k_t, k_u, T, J in refreshes:
        print(f"[pair path] refresh at frame {i}: K_h {k_h} ({k_h / (T * J):.1%}), K_t {k_t} "
              f"({k_t / (T * J):.1%}) of {T * J} pairs per field; {k_u} of {T} tiles in the "
              f"union", flush=True)
        for name, k in (("head", k_h), ("torso", k_t)):
            if not PAIR_FRACTION[0] <= k / (T * J) <= PAIR_FRACTION[1]:
                _fail(f"{name} lists {k} of {T * J} pairs at frame {i}, outside "
                      f"{PAIR_FRACTION[0]:.0%}-{PAIR_FRACTION[1]:.0%}")
    s_ms, r_ms = sum(steady_ms) / len(steady_ms), sum(refresh_ms) / len(refresh_ms)
    every = rcfg.occ_refresh_every
    window = (r_ms + (every - 1) * s_ms) / every
    print(f"[pair path] {PAIR_FRAMES} frames {H}x{W}, {N_SAMPLES} samples: "
          f"{s_ms:.2f} ms per steady frame ({len(steady_ms)} frames), "
          f"{r_ms:.2f} ms per refresh frame ({len(refresh_ms)} "
          f"frames), {window:.2f} ms per frame over a refresh window of {every} (CUDA events, "
          f"warm); launches {launches}; host syncs in steady frames {syncs}", flush=True)
    if len(refresh_ms) != 2:
        _fail(f"{len(refresh_ms)} refresh frames in {PAIR_FRAMES}, expected 2")
    for i, (st, _, _, got) in enumerate(marks):
        if st and got != {"pair_field": 2, "far_head": 1, "far_torso": 1}:
            _fail(f"steady frame {i} launched {got}")
    if syncs:
        _fail(f"{syncs} host synchronizations in the steady frames")
    for i, (head, com) in enumerate(frames):
        _check_frame(f"pair frame {i}", head, com)
    print(f"[pair path] frames finite, in [0, 1]; frame 0 com mean "
          f"{float(frames[0][1].mean()):.4f}", flush=True)
    for (i, *_), (occ_args, occ_kw, flags) in zip(refreshes, flag_runs, strict=True):
        _check_flags(f"pair path refresh frame {i}, flags vs widened float32", occ_args, occ_kw,
                     flags)

    # a refresh frame (0) and a steady frame (the last) through the plain
    # versions on the card: the same renderer code with the kernel calls
    # swapped for their plain versions
    captured = {}
    with _plain_pair_path(captured):
        plain_render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
        head_r, com_r = plain_render(*args(0))
        torch.cuda.synchronize()
        err = _check_pair("pair path refresh frame 0, kernels vs plain", frames[0][0],
                          frames[0][1], head_r, com_r, captured["sh"])
        last = args(PAIR_FRAMES - 1)
        head_r, com_r = render.run_fast(*last)
        torch.cuda.synchronize()
        err = max(err, _check_pair(f"pair path steady frame {PAIR_FRAMES - 1}, kernels vs plain",
                                   frames[-1][0], frames[-1][1], head_r, com_r, captured["sh"]))

    # each stage and kernel on the last steady frame's operands
    pw_h, pw_t, ro, rd, ro_t, rd_t, _ = render.inputs_fn(*last)
    c = render.cache
    T, J = c["occ"].shape[1:]
    sel = c["tiles_sel"]

    def gather(x):
        return x.reshape(T, R_T, -1).index_select(0, sel).reshape(-1, x.shape[-1])

    ro_g, rd_g, ro_t_g, rd_t_g = (gather(x) for x in (ro, rd, ro_t, rd_t))
    z_vals = linspace(scene.near, scene.far, N_SAMPLES, device="cuda")
    far = float(z_vals[-1])
    act = cfg.decoder.density_activation
    vh = view_bias(pw_h, rd_g).to(torch.bfloat16).contiguous()
    vt = view_bias(pw_t, rd_t_g).to(torch.bfloat16).contiguous()
    vrtf = view_bias(pw_t, rd_t).to(torch.bfloat16).contiguous()
    (ti_h, ji_h), (ti_t, ji_t) = c["lists"]
    k_u, n = len(c["tiles_u"]), ro.shape[0]
    pair_ops = {"head": (pw_h, ro_g, rd_g, vh, ti_h, ji_h), "torso": (pw_t, ro_t_g, rd_t_g, vt,
                                                                     ti_t, ji_t)}

    occ_ms = _cuda_ms(lambda: conservative_occupancy(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals,
                                                     rcfg.occ_sigma_thresh, rcfg.occ_grid_res,
                                                     act), 2)
    # of it, the node grid: one node-grid kernel launch a field
    lo, span, _ = occupancy_boxes(ro, rd, ro_t, rd_t, z_vals, rcfg.occ_grid_res)
    grid_ms, grid_bound = {}, {}
    for branch, pw in (("head", pw_h), ("torso", pw_t)):
        grid_ms[branch] = _cuda_ms(lambda: node_grid_kernel(pw, branch, lo, span,
                                                            rcfg.occ_grid_res, act), 3)
        grid_bound[branch] = ((rcfg.occ_grid_res * SUPERSAMPLE) ** 3
                              * field_flops_per_sample(branch, color=False)
                              / PEAK_BF16_FLOPS * 1e3)
    bufs, pair_ms, pair_plain_ms, pair_err, pair_flops, pair_bytes = {}, 0.0, 0.0, 0.0, 0.0, 0.0
    for branch, (pw, o, d, vr, ti, ji) in pair_ops.items():
        bufs[branch] = pair_field_kernel(pw, branch, o, d, vr, z_vals, ti, ji, act)
        ms = _cuda_ms(lambda: pair_field_kernel(pw, branch, o, d, vr, z_vals, ti, ji, act), 3)
        ref, plain_ms = _cuda_call(lambda: pair_field_eval_reference(pw, branch, o, d, vr, z_vals,
                                                                     ti, ji, act))
        pair_err = max(pair_err, _check_buffers(
            f"pair path, pair_field {branch} vs plain", bufs[branch], ref,
            _listed_mask(J, k_u, ti, ji, "cuda")))
        K = ti.numel()
        flops = K * 8 * R_T * field_flops_per_sample(branch)
        n_bytes = _pair_bytes(k_u, K, 8, weight_blobs(pw, branch))
        print(f"[pair path] pair_field {branch}: {K} pairs, {ms:.3f} ms per launch; plain "
              f"{plain_ms:.1f} ms; {flops / 1e12:.3f} TFLOP at live widths -> "
              f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak "
              f"({flops / ms / 1e9:.1f} TFLOP/s achieved); {n_bytes / 1e6:.1f} MB; L2 weight "
              f"rate {_l2_rate((branch,), K * 16, ms):.3f} TB/s", flush=True)
        pair_ms, pair_plain_ms = pair_ms + ms, pair_plain_ms + plain_ms
        pair_flops, pair_bytes = pair_flops + flops, pair_bytes + n_bytes
    comp_ms = _cuda_ms(lambda: deferred_composite(bufs["head"], bufs["torso"], c["occ_sub"],
                                                  rd_g, rd_t_g, z_vals, with_diagnostics=False), 5)

    far_runs = {
        "far_head": (lambda: far_head_kernel(pw_h, ro, rd, far, act=act),
                     lambda: far_head_reference(pw_h, ro, rd, far, act),
                     n * field_flops_per_sample("head", color=False),
                     n * 2 * 3 * 4 + sum(x.numel() * x.element_size()
                                         for x in weight_blobs(pw_h, "head")) + n * 4),
        "far_torso": (lambda: far_torso_kernel(pw_t, ro_t, rd_t, far, vrtf, act=act),
                      lambda: far_torso_reference(pw_t, ro_t, rd_t, far, vrtf, act),
                      n * field_flops_per_sample("torso", sigma=False),
                      n * 2 * 3 * 4 + n * 256 * 2 + sum(x.numel() * x.element_size()
                                                        for x in weight_blobs(pw_t, "torso"))
                      + n * 3 * 4),
    }
    far_res = {}
    for name, (kernel, plain, flops, n_bytes) in far_runs.items():
        out = kernel()
        ms = _cuda_ms(kernel, 5)
        out_ref, plain_ms = _cuda_call(plain)
        print(f"[pair path] {name}: {n} rays, {ms:.3f} ms per launch; plain {plain_ms:.1f} ms; "
              f"{flops / 1e12:.3f} TFLOP at live widths -> {flops / PEAK_BF16_FLOPS * 1e3:.3f} "
              f"ms at bf16 peak ({flops / ms / 1e9:.1f} TFLOP/s achieved); {n_bytes / 1e6:.1f} "
              f"MB; L2 weight rate {_far_l2_rate(name, n, ms):.3f} TB/s", flush=True)
        far_res[name] = (out, out_ref, ms, plain_ms, flops, n_bytes)
    errs = _check_far("pair path, far kernels vs plain", far_res["far_head"][0],
                      far_res["far_torso"][0], far_res["far_head"][1], far_res["far_torso"][1])
    entries = [_entry("pair_field", "pair_field.cu", "dfanerf_tpu/ops/fused_render.py:974",
                      launches["pair_field"], pair_err, pair_ms, pair_plain_ms, pair_flops,
                      pair_bytes)]
    for (name, line), err_k in zip((("far_head", 1508), ("far_torso", 1529)), errs):
        entries.append(_entry(name, "far_eval.cu", f"dfanerf_tpu/ops/fused_render.py:{line}",
                              launches[name], err_k, *far_res[name][2:]))
    print(f"[pair path] stages on frame {PAIR_FRAMES - 1}'s operands: occupancy {occ_ms:.2f} ms "
          f"(refresh frames only; of it node_grid at grid {rcfg.occ_grid_res}: head "
          f"{grid_ms['head']:.3f} ms, torso {grid_ms['torso']:.3f} ms a launch against "
          f"{grid_bound['head']:.3f} / {grid_bound['torso']:.3f} ms at bf16 peak, "
          f"{grid_bound['head'] / grid_ms['head']:.1%} / "
          f"{grid_bound['torso'] / grid_ms['torso']:.1%}), pair_field head+torso "
          f"{pair_ms:.2f} ms, far_head + far_torso "
          f"{entries[1]['ms'] + entries[2]['ms']:.2f} ms, deferred_composite {comp_ms:.2f} ms; "
          f"frame-level error vs plain {err:.3e}", flush=True)
    print("[pair path] library_ms is null for pair_field, far_head and far_torso: no single "
          "PyTorch call computes a packed NeRF field on listed (tile, slab) pairs or at the far "
          "plane", flush=True)
    return entries, {"frames": frames, "times": (s_ms, r_ms, window),
                     "lists": [(i, k_h, k_t) for i, k_h, k_t, *_ in refreshes],
                     "ops": (pair_ops, z_vals, act, k_u)}


# A contribution prune that drops pairs on the card (the main path's
# transmittance prune keeps every pair of these unsaturated random fields).
# On frame 0's refresh the torso's per-(tile, slab) contributions reach at
# most 0.0435 and the head's start at 0.0530 (the phase prints both; H100),
# so 0.05 drops every torso pair (K_t = 0) and keeps every head pair, and the
# union falls from 841 tiles to the head's 724.
PRUNE_CONTRIB = 0.05


def phase_pair_prune():
    """The pair path after a prune that drops pairs: a refresh frame, then a
    steady frame under the pruned lists, in which the union has shrunk and a
    field has no pair; the steady frame is held against the plain versions."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.pair_field import pair_field_kernel

    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**PAIR_RENDER, occ_prune_contrib=PRUNE_CONTRIB))
    scene, args = _pair_scene(cfg)
    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    flag_runs, comp_runs = [], []
    with _spy("conservative_occupancy", flag_runs), _spy("deferred_composite", comp_runs):
        render(*args(0))
    occ = flag_runs[0][2]
    (_, _, occ_sub, *_), _, diag = comp_runs[0]
    cb_h, cb_t = diag[6][occ_sub[0].bool()], diag[7][occ_sub[1].bool()]
    c = render.cache
    k_h, k_t, k_u = c["lists"][0][0].numel(), c["lists"][1][0].numel(), len(c["tiles_u"])
    u_before = int(occ.amax(dim=(0, 2)).sum())
    print(f"[pair prune] occ_prune_contrib {PRUNE_CONTRIB}: K_h {int(occ[0].sum())} -> {k_h}, "
          f"K_t {int(occ[1].sum())} -> {k_t}, union {u_before} -> {k_u} tiles; listed "
          f"contributions head {float(cb_h.min()):.4f}-{float(cb_h.max()):.4f}, torso "
          f"{float(cb_t.min()):.4f}-{float(cb_t.max()):.4f}", flush=True)
    if not (k_u < u_before and min(k_h, k_t) == 0 < max(k_h, k_t)):
        _fail("the prune should drop tiles from the union and every pair of one field")

    kernels = {"pair_field": pair_field_kernel, "far_head": far_head_kernel,
               "far_torso": far_torso_kernel}
    before = {name: k.launches for name, k in kernels.items()}
    head, com = render(*args(1))
    torch.cuda.synchronize()
    got = {name: k.launches - before[name] for name, k in kernels.items()}
    if got != {"pair_field": 1, "far_head": 1, "far_torso": 1}:
        _fail(f"the pruned steady frame launched {got}")
    _check_frame("pair prune steady frame 1", head, com)
    captured = {}
    with _plain_pair_path(captured):
        head_r, com_r = render.run_fast(*args(1))
    torch.cuda.synchronize()
    _check_pair("pair prune steady frame 1, kernels vs plain", head, com, head_r, com_r,
                captured["sh"])


# The half-slab pair path (occ_pack2): 4-sample slabs, two pairs per block.
PAIR2_FRACTION = 0.2  # share of a frame's (tile, half-slab) pairs listed in the kernel checks
PACK2_RENDER = dict(PAIR_RENDER, occ_pack2=True)
UNION_WINDOW = 4


def _split(t_idx, j_idx):
    """The packed-2 split of a tile-major pair list: A the even pairs, B the
    odd ones (the renderer's lists2)."""
    return tuple(x.contiguous() for x in (t_idx[0::2], j_idx[0::2], t_idx[1::2], j_idx[1::2]))


def _quartets_equal(got, want, listed):
    return all(torch.equal(g[listed], w[listed]) for g, w in zip(got, want))


def phase_pair2_kernels_vs_plain(sp8):
    """pair_field at 4 samples per slab and pair2_field at 4 and 8 against
    their plain versions at a 450x450 frame's rays and 64 samples (16
    half-slabs, 8 slabs): head and torso, relu and softplus, a list with
    gaps and an odd K, and K = 1; pair2's A and B quartets against
    pair_field's at the same slab size on the A and B lists, bit for bit;
    K = 0 returns zeros without a launch. Then pair2_field at sp=8 through
    its entry point, pair2_field_eval_prepped, on the pair path's sp=8 lists
    (sp8["ops"], its last steady frame): launches counted from zero, the
    quartets against the plain version and against pair_field's on the A
    and B lists, and both kernels timed on those lists (ABBA). Returns the
    largest absolute difference from the plain version of each kernel and
    the kernels-line entry of pair2_field at sp=8."""
    from dfanerf_torch.models import Decoder, DecoderConfig
    from dfanerf_torch.models.layers import init_uniform_
    from dfanerf_torch.ops._build import weight_blobs
    from dfanerf_torch.ops.fused_render import R_T, field_flops_per_sample, view_bias
    from dfanerf_torch.ops.pack import pack_field_weights
    from dfanerf_torch.ops.pair_field import (
        pair2_field_eval_prepped, pair2_field_eval_reference, pair2_field_kernel,
        pair_field_eval_reference, pair_field_kernel,
    )

    g = torch.Generator().manual_seed(5)
    dec = init_uniform_(Decoder(DecoderConfig()), g).cuda()

    def rn(*shape):
        return torch.randn(*shape, generator=g).cuda()

    vecs = [rn(96), rn(42), rn(256), rn(256)]
    T = (-(-H // 16)) ** 2
    z = torch.linspace(0.3, 0.9, N_SAMPLES).cuda()
    worst = {"pair_field_sp4": 0.0, "pair2_field": 0.0, "pair2_field_sp8": 0.0}
    packs = {}
    for branch, sig in (("head", vecs[0]), ("torso", vecs[1])):
        pw = packs[branch] = pack_field_weights(dec, sig, vecs[2], vecs[3], branch)
        o = (rn(T * 256, 3) * 0.05).contiguous()
        d = (rn(T * 256, 3) * 0.2 + torch.tensor([0.0, 0.0, -1.0]).cuda()).contiguous()
        vr = view_bias(pw, d).to(torch.bfloat16).contiguous()
        for sp in (4, 8):
            J = N_SAMPLES // sp
            flags = torch.rand((T, J), generator=g) < PAIR2_FRACTION
            t_all, j_all = (x.to(torch.int32).cuda() for x in flags.nonzero(as_tuple=True))
            if t_all.numel() % 2 == 0:  # an odd K: the last block has no B pair
                t_all, j_all = t_all[:-1].contiguous(), j_all[:-1].contiguous()
            cases = {f"K = {t_all.numel()} with gaps": (t_all, j_all),
                     "K = 1": (t_all[:1].contiguous(), j_all[:1].contiguous())}
            key2 = "pair2_field" if sp == 4 else "pair2_field_sp8"
            for act in ("relu", "softplus"):
                for tag, (t_i, j_i) in cases.items():
                    ta, ja, tb, jb = _split(t_i, j_i)
                    one = (pair_field_kernel(pw, branch, o, d, vr, z, t_i, j_i, act, sp)
                           if sp == 4 else None)
                    two = pair2_field_kernel(pw, branch, o, d, vr, z, ta, ja, tb, jb, act, sp)
                    one_a = pair_field_kernel(pw, branch, o, d, vr, z, ta, ja, act, sp)
                    one_b = (pair_field_kernel(pw, branch, o, d, vr, z, tb, jb, act, sp)
                             if tb.numel() else None)
                    torch.cuda.synchronize()
                    ref2 = pair2_field_eval_reference(pw, branch, o, d, vr, z, ta, ja, tb, jb,
                                                      act, sp)
                    lists = {"": (t_i, j_i), " A": (ta, ja), " B": (tb, jb)}
                    masks = {k: _listed_mask(J, T, t, j, "cuda", sp)
                             for k, (t, j) in lists.items()}
                    label = f"{branch}, {act}, {tag}"
                    if one is not None:
                        ref = pair_field_eval_reference(pw, branch, o, d, vr, z, t_i, j_i, act,
                                                        sp)
                        worst["pair_field_sp4"] = max(worst["pair_field_sp4"], _check_buffers(
                            f"pair_field sp=4 vs plain, {label}", one, ref, masks[""]))
                    for q, quartet, key in ((0, two[0], " A"), (1, two[1], " B")):
                        if lists[key][0].numel():
                            worst[key2] = max(worst[key2], _check_buffers(
                                f"pair2_field sp={sp} vs plain, {label},{key}", quartet, ref2[q],
                                masks[key]))
                    same_a = _quartets_equal(two[0], one_a, masks[" A"])
                    same_b = one_b is None or _quartets_equal(two[1], one_b, masks[" B"])
                    print(f"[pair2_field vs pair_field sp={sp}, {label}] A ({ta.numel()} pairs) "
                          f"bit-equal {same_a}, B ({tb.numel()} pairs) bit-equal {same_b}",
                          flush=True)
                    if not (same_a and same_b):
                        _fail(f"pair2_field's quartets differ from pair_field's at sp={sp}, "
                              f"{label}")
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    before = pair2_field_kernel.launches
    o = torch.zeros((T * 256, 3), device="cuda")
    vr = torch.zeros((T * 256, 256), dtype=torch.bfloat16, device="cuda")
    for sp in (4, 8):
        quartets = pair2_field_eval_prepped(packs["head"], "head", o, o, vr, z, empty, empty,
                                            empty, empty, s_slab=sp)
        if pair2_field_kernel.launches != before or any(bool(b.float().any())
                                                        for q in quartets for b in q):
            _fail(f"pair2_field sp={sp} with no pairs: a launch or non-zero buffers")
    print("[pair2_field vs plain, no pairs] zero quartets at sp=4 and 8, no launch", flush=True)

    # sp=8 through the entry point, on the pair path's lists of its last steady frame
    pair_ops, z_vals, act, k_u = sp8["ops"]
    splits = {b: _split(ti, ji) for b, (_, _, _, _, ti, ji) in pair_ops.items()}
    pair2_field_kernel.launches, pair2_field_kernel.variant_launches = 0, {}
    got = {b: pair2_field_eval_prepped(pw, b, o, d, vr, z_vals, *splits[b], act, 8)
           for b, (pw, o, d, vr, _, _) in pair_ops.items()}
    torch.cuda.synchronize()
    launches = pair2_field_kernel.variant_launches.get("sp8", 0)
    if launches != len(pair_ops) or pair2_field_kernel.launches != launches:
        _fail(f"pair2_field sp=8 on the pair path's lists: launches "
              f"{pair2_field_kernel.variant_launches}, expected one sp8 launch a field")
    plain_ms, flops, n_bytes = 0.0, 0.0, 0.0
    runs = {"pair2_field": [], "pair_field": []}
    for branch, (pw, o, d, vr, ti, ji) in pair_ops.items():
        ta, ja, tb, jb = splits[branch]
        J = N_SAMPLES // 8
        ref, ms = _cuda_call(lambda: pair2_field_eval_reference(pw, branch, o, d, vr, z_vals, ta,
                                                                ja, tb, jb, act, 8))
        plain_ms += ms
        masks = [_listed_mask(J, k_u, t, j, "cuda", 8) for t, j in ((ta, ja), (tb, jb))]
        for q, key in ((0, "A"), (1, "B")):
            worst["pair2_field_sp8"] = max(worst["pair2_field_sp8"], _check_buffers(
                f"pair path sp=8 lists, pair2_field {branch} {key} vs plain", got[branch][q],
                ref[q], masks[q]))
        same = [_quartets_equal(got[branch][q], pair_field_kernel(pw, branch, o, d, vr, z_vals,
                                                                  t, j, act, 8), masks[q])
                for q, (t, j) in enumerate(((ta, ja), (tb, jb)))]
        if not all(same):
            _fail(f"pair path sp=8 lists, {branch}: pair2_field's quartets differ from "
                  f"pair_field's (A, B bit-equal {same})")
        K = ti.numel()
        flops += K * 8 * R_T * field_flops_per_sample(branch)
        n_bytes += _pair_bytes(k_u, K, 8, weight_blobs(pw, branch))
        calls = {"pair_field": (pair_field_kernel, (ti, ji)),
                 "pair2_field": (pair2_field_kernel, (ta, ja, tb, jb))}
        for name in ("pair2_field", "pair_field", "pair_field", "pair2_field"):
            kern, lists = calls[name]
            runs[name].append(_cuda_ms(lambda: kern(pw, branch, o, d, vr, z_vals, *lists, act, 8),
                                       3))
        print(f"[pair2_field sp=8, pair path lists] {branch}: K = {K} ({ta.numel()} A, "
              f"{tb.numel()} B); A and B bit-equal to pair_field's; plain {ms:.1f} ms",
              flush=True)
    ms2, ms1 = (sum(runs[k]) / 2 for k in ("pair2_field", "pair_field"))
    print(f"[pair2_field sp=8, pair path lists] head+torso {ms2:.3f} ms against pair_field sp=8's "
          f"{ms1:.3f} ms on the same lists ({ms2 / ms1:.3f}x; ABBA, 3 launches each); "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak", flush=True)
    entry = _entry("pair2_field_sp8", "pair_field.cu", "dfanerf_tpu/ops/fused_render.py:1195",
                   launches, worst["pair2_field_sp8"], ms2, plain_ms, flops, n_bytes)
    return worst, entry


def phase_pack2_main_path(sp8):
    """The pair-compacted serving path with occ_pack2 at full width through
    the entry points: phase_pair_main_path's recipe, scene and weights, 16
    frames across two refreshes. sp8 holds that phase's frames, frame times
    and list sizes, printed beside this path's."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops._build import weight_blobs
    from dfanerf_torch.ops.composite import deferred_composite
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.fused_render import R_T, field_flops_per_sample, view_bias
    from dfanerf_torch.ops.occupancy import conservative_occupancy
    from dfanerf_torch.ops.pair_field import (
        pair2_field_eval_reference, pair2_field_kernel, pair_field_eval_reference,
        pair_field_kernel,
    )

    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**PACK2_RENDER))
    rcfg = cfg.render
    sp, every = 4, rcfg.occ_refresh_every
    scene, args = _pair_scene(cfg)
    warm = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    warm(*args(0))
    warm(*args(1))
    torch.cuda.synchronize()

    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    kernels = {"pair2_field": (pair2_field_kernel, None), "pair_field": (pair_field_kernel, None),
               "far_head": (far_head_kernel, None), "far_torso": (far_torso_kernel, None)}
    for k, _ in kernels.values():
        k.launches, k.variant_launches = 0, {}
    refreshes, flag_runs = [], []

    def on_refresh(i):
        c = render.cache
        refreshes.append((i, [t.numel() for t, _ in c["lists"]],
                          [(l2[0].numel(), l2[2].numel()) for l2 in c["lists2"]],
                          len(c["tiles_u"]), c["occ_sub"], c["occ_sub_a"], c["occ_sub_b"]))

    with _spy("conservative_occupancy", flag_runs):
        frames, marks, syncs = _run_frames(
            render, args, PAIR_FRAMES, kernels,
            lambda c: c["lists"] is not None and c["age"] < every, on_refresh)
    launches = {"pair2_field": pair2_field_kernel.launches,
                "pair_field_sp4": pair_field_kernel.variant_launches.get("sp4", 0),
                "pair_field_sp8": pair_field_kernel.variant_launches.get("sp8", 0)}
    s_ms, r_ms, window = _frame_times("pack2 path", marks, every)
    s8, r8, w8 = sp8["times"]
    print(f"[pack2 path] against the sp=8 pair path on the same weights and frames (this run): "
          f"steady {s_ms:.2f} vs {s8:.2f} ms, refresh {r_ms:.2f} vs {r8:.2f} ms, per frame over "
          f"a window of {every} {window:.2f} vs {w8:.2f} ms; launches {launches}; host syncs in "
          f"steady frames {syncs}", flush=True)
    if len(refreshes) != 2:
        _fail(f"{len(refreshes)} refresh frames in {PAIR_FRAMES}, expected 2")
    T = (-(-H // 16)) ** 2
    J = N_SAMPLES // sp
    for (i, ks, ks2, k_u, occ_sub, occ_a, occ_b), (i8, k8_h, k8_t) in zip(refreshes,
                                                                           sp8["lists"]):
        for name, k, k8 in (("head", ks[0], k8_h), ("torso", ks[1], k8_t)):
            print(f"[pack2 path] refresh at frame {i}: {name} lists {k} of {T * J} half-slabs "
                  f"({k / (T * J):.1%}), {k * sp * R_T} samples, against {k8} of {T * J // 2} "
                  f"slabs, {k8 * 8 * R_T} samples, at sp=8 (frame {i8}); {k_u} of {T} tiles in "
                  f"the union", flush=True)
            if not PAIR_FRACTION[0] <= k / (T * J) <= PAIR_FRACTION[1]:
                _fail(f"{name} lists {k} of {T * J} half-slabs at frame {i}")
        a, b, u = occ_a.bool(), occ_b.bool(), occ_sub.bool()
        if (a & b).any() or not torch.equal(a | b, u):
            _fail(f"refresh {i}: the A and B flag partitions are not a partition of the flags")
        if ks2 != [((k + 1) // 2, k // 2) for k in ks]:
            _fail(f"refresh {i}: packed-2 list lengths {ks2} for lists of {ks}")
        print(f"[pack2 path] refresh at frame {i}: packed-2 lists (A, B) {ks2}; the A and B "
              f"flag partitions are disjoint and cover the flags in force", flush=True)
    for i, (st, _, got) in enumerate(marks):
        want = ({"pair2_field": 2, "far_head": 1, "far_torso": 1} if st
                else {"pair_field": 2, "far_head": 1, "far_torso": 1})
        if got != want:
            _fail(f"pack2 {'steady' if st else 'refresh'} frame {i} launched {got}, expected "
                  f"{want}")
    if launches["pair_field_sp8"] or launches["pair_field_sp4"] != 4:
        _fail(f"pack2 path: pair_field launches by slab size {pair_field_kernel.variant_launches}")
    if syncs:
        _fail(f"{syncs} host synchronizations in the pack2 steady frames")
    for i, (head, com) in enumerate(frames):
        _check_frame(f"pack2 frame {i}", head, com)
    for (i, *_), (occ_args, occ_kw, flags) in zip(refreshes, flag_runs, strict=True):
        if tuple(flags.shape) != (2, T, J):
            _fail(f"pack2 flags of shape {tuple(flags.shape)}, expected {(2, T, J)}")
        _check_flags(f"pack2 path refresh frame {i}, flags vs widened float32", occ_args, occ_kw,
                     flags)

    captured = {}
    last = args(PAIR_FRAMES - 1)
    with _plain_pair_path(captured):
        plain_render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
        head_r, com_r = plain_render(*args(0))
        torch.cuda.synchronize()
        err = _check_pair("pack2 path refresh frame 0, kernels vs plain", frames[0][0],
                          frames[0][1], head_r, com_r, captured["sh"])
        head_r, com_r = render.run_fast(*last)
        torch.cuda.synchronize()
        err = max(err, _check_pair(f"pack2 path steady frame {PAIR_FRAMES - 1}, kernels vs "
                                   f"plain", frames[-1][0], frames[-1][1], head_r, com_r,
                                   captured["sh"]))
    noskip = _serve_noskip_frames(cfg, args, PAIR_FRAMES)
    _noskip_errors("pair path, sp=8", sp8["frames"], noskip)
    _noskip_errors("pack2 path", frames, noskip)
    del noskip

    # each kernel and the composite on the last steady frame's operands
    pw_h, pw_t, ro, rd, ro_t, rd_t, _ = render.inputs_fn(*last)
    c = render.cache
    sel = c["tiles_sel"]

    def gather(x):
        return x.reshape(T, R_T, -1).index_select(0, sel).reshape(-1, x.shape[-1])

    ro_g, rd_g, ro_t_g, rd_t_g = (gather(x) for x in (ro, rd, ro_t, rd_t))
    z_vals = linspace(scene.near, scene.far, N_SAMPLES, device="cuda")
    act = cfg.decoder.density_activation
    k_u = len(c["tiles_u"])
    fields = {"head": (pw_h, ro_g, rd_g, c["lists"][0], c["lists2"][0]),
              "torso": (pw_t, ro_t_g, rd_t_g, c["lists"][1], c["lists2"][1])}
    occ_ms = _cuda_ms(lambda: conservative_occupancy(pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals,
                                                     rcfg.occ_sigma_thresh, rcfg.occ_grid_res,
                                                     act, s_slab=sp), 2)
    res = {name: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "flops": 0.0, "bytes": 0.0}
           for name in ("pair2_field", "pair_field_sp4")}
    bufs = {}
    for branch, (pw, o, d, (ti, ji), l2) in fields.items():
        vr = view_bias(pw, d).to(torch.bfloat16).contiguous()
        K = ti.numel()
        flops = K * sp * R_T * field_flops_per_sample(branch)
        n_bytes = _pair_bytes(k_u, K, sp, weight_blobs(pw, branch))
        runs = {
            "pair2_field": (lambda: pair2_field_kernel(pw, branch, o, d, vr, z_vals, *l2, act),
                            lambda: pair2_field_eval_reference(pw, branch, o, d, vr, z_vals, *l2,
                                                               act)),
            "pair_field_sp4": (lambda: pair_field_kernel(pw, branch, o, d, vr, z_vals, ti, ji,
                                                         act, sp),
                               lambda: pair_field_eval_reference(pw, branch, o, d, vr, z_vals,
                                                                 ti, ji, act, sp)),
        }
        for name, (kernel, plain) in runs.items():
            got = kernel()
            ms = _cuda_ms(kernel, 3)
            ref, plain_ms = _cuda_call(plain)
            if name == "pair2_field":
                bufs[branch] = got
                err_k = max(_check_buffers(f"pack2 path, {name} {branch} {half} vs plain", q, r,
                                           _listed_mask(J, k_u, t, j, "cuda", sp))
                            for half, q, r, t, j in (("A", got[0], ref[0], l2[0], l2[1]),
                                                     ("B", got[1], ref[1], l2[2], l2[3])))
            else:
                err_k = _check_buffers(f"pack2 path, {name} {branch} vs plain", got, ref,
                                       _listed_mask(J, k_u, ti, ji, "cuda", sp))
            blocks = l2[0].numel() if name == "pair2_field" else K
            print(f"[pack2 path] {name} {branch}: {K} half-slab pairs in {blocks} blocks, "
                  f"{ms:.3f} ms per launch; plain {plain_ms:.1f} ms; "
                  f"{flops / 1e12:.3f} TFLOP at live widths -> "
                  f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak "
                  f"({flops / ms / 1e9:.1f} TFLOP/s achieved); {n_bytes / 1e6:.1f} MB; L2 "
                  f"weight rate {_l2_rate((branch,), K * 2 * sp, ms):.3f} TB/s", flush=True)
            r = res[name]
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["err"] = max(r["err"], err_k)
            r["flops"] += flops
            r["bytes"] += n_bytes
    comp_ms = _cuda_ms(lambda: deferred_composite(
        bufs["head"][0], bufs["torso"][0], c["occ_sub_a"], rd_g, rd_t_g, z_vals,
        with_diagnostics=False, buf_h2=bufs["head"][1], buf_t2=bufs["torso"][1],
        occ2=c["occ_sub_b"], s_slab=sp), 5)
    print(f"[pack2 path] stages on frame {PAIR_FRAMES - 1}'s operands: occupancy at sp=4 "
          f"{occ_ms:.2f} ms (refresh frames only), pair2_field head+torso "
          f"{res['pair2_field']['ms']:.2f} ms, pair_field sp=4 head+torso (refresh frames) "
          f"{res['pair_field_sp4']['ms']:.2f} ms, deferred_composite A+B {comp_ms:.2f} ms; "
          f"frame-level error vs plain {err:.3e}; library_ms is null for both kernels (no single "
          f"PyTorch call computes a packed NeRF field on listed pairs)", flush=True)
    entries = [
        _entry("pair2_field", "pair_field.cu", "dfanerf_tpu/ops/fused_render.py:1195",
               launches["pair2_field"], *(res["pair2_field"][k]
                                          for k in ("err", "ms", "plain_ms", "flops", "bytes"))),
        _entry("pair_field_sp4", "pair_field.cu", "dfanerf_tpu/ops/fused_render.py:974",
               launches["pair_field_sp4"], *(res["pair_field_sp4"][k]
                                             for k in ("err", "ms", "plain_ms", "flops",
                                                       "bytes"))),
    ]
    return entries, (s_ms, r_ms, window)


def phase_refresh_union():
    """render.refresh_union with occ_pack2 over a window of 4 prepped frames
    of the pack2 recipe: the pinned union (frames render under it without a
    refresh), then per-frame slots (render(..., window_slot=i)); prep
    seconds and ms per frame; a union frame and every slot frame against
    the plain versions."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.pair_field import pair2_field_kernel, pair_field_kernel

    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**PACK2_RENDER))
    scene, args = _pair_scene(cfg)
    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    window = [render.inputs_fn(*args(i)) for i in range(UNION_WINDOW)]
    c = render.cache
    kernels = {"pair2_field": (pair2_field_kernel, None), "pair_field": (pair_field_kernel, None),
               "far_head": (far_head_kernel, None), "far_torso": (far_torso_kernel, None)}

    def prep(per_slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render.refresh_union(window, per_slot=per_slot)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def counts(st):
        return [t.numel() for t, _ in st["lists"]]

    union_s = prep(False)
    if not c["pinned"] or c["slots"]:
        _fail("refresh_union did not pin the union state")
    union = counts(c)
    frames, marks, syncs = _run_frames(render, args, UNION_WINDOW, kernels, lambda _: True)
    if any(got != {"pair2_field": 2, "far_head": 1, "far_torso": 1} for _, _, got in marks):
        _fail(f"frames under the pinned union launched {[got for _, _, got in marks]}")
    if syncs or counts(c) != union:
        _fail(f"frames under the pinned union: {syncs} host syncs, lists {counts(c)} vs {union}")
    for i, (head, com) in enumerate(frames):
        _check_frame(f"union frame {i}", head, com)
    union_ms = sum(ms for _, ms, _ in marks) / len(marks)

    slot_s = prep(True)
    slots = [counts(st) for st in c["slots"]]
    if len(slots) != UNION_WINDOW or counts(c) != union:
        _fail(f"refresh_union(per_slot=True): {len(slots)} slots, union lists {counts(c)}")
    slot_frames, slot_ms = [], []
    for i in range(UNION_WINDOW):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        slot_frames.append(render(*args(i), window_slot=i))
        e1.record()
        torch.cuda.synchronize()
        slot_ms.append(e0.elapsed_time(e1))
    print(f"[refresh_union] pack2, window of {UNION_WINDOW} frames: union prep {union_s:.3f} s, "
          f"lists (head, torso) {union}; {union_ms:.2f} ms per frame under the pinned union "
          f"(CUDA events); per-slot prep {slot_s:.3f} s, slot lists {slots}; "
          f"{sum(slot_ms) / len(slot_ms):.2f} ms per slot frame "
          f"({', '.join(f'{m:.2f}' for m in slot_ms)})", flush=True)
    for f in range(2):
        if union[f] < max(s[f] for s in slots):
            _fail("the union lists fewer pairs than a slot")
    captured = {}
    with _plain_pair_path(captured):
        head_r, com_r = render(*args(0))
        torch.cuda.synchronize()
        err = _check_pair("refresh_union frame 0 under the union, kernels vs plain",
                          frames[0][0], frames[0][1], head_r, com_r, captured["sh"])
        for i, (head, com) in enumerate(slot_frames):
            _check_frame(f"slot frame {i}", head, com)
            head_r, com_r = render(*args(i), window_slot=i)
            torch.cuda.synchronize()
            err = max(err, _check_pair(f"refresh_union frame {i} under slot {i}, kernels vs plain",
                                       head, com, head_r, com_r, captured["sh"]))
    print(f"[refresh_union] frame-level error vs plain {err:.3e}", flush=True)


# BASELINE config 3's offline serving config, cfg1 of
# benchmarks/serve_trained.py:246-259 with the defaults of run() (:129-132),
# verbatim: the colour-keyed budgeted prune refined over two rounds,
# far_skip_tol, the far plane on an 8x8-pixel subgrid, carried keep-masks.
CFG1_RENDER = dict(n_samples=N_SAMPLES, use_fused_kernel=True, compute_dtype="bfloat16",
                   ert_eps=1e-4, spatial_tiles=True, occ_sigma_thresh=2.0, occ_grid_res=96,
                   occ_refresh_every=8, occ_pair_compaction=True, occ_prune_contrib=0.0,
                   occ_prune_budget=2e-3, occ_budget_color=True, occ_budget_iters=2,
                   occ_prune_trans=0.1, far_skip_tol=2e-3, far_subsample=8, occ_prune_carry=3)
CFG1_WINDOW = 4
CFG1_SLOT_FRAMES = 8   # window_slot frames served, cycling the window twice
CFG1_LIVE_EVERY = 4    # live part: refresh every 4 frames, so 20 frames hold
CFG1_LIVE_FRAMES = 20  # full, carried x3, full refreshes
CFG1_FAR_ROWS = 841 * 4  # a 450x450 frame's far_subsample=8 subgrid
# A second budget, served where cfg1's drops no pair on these random weights
# (the colour keys of random fields can all exceed 2e-3).
CFG1_DROP_BUDGET = 2e-2


def phase_cfg1():
    """BASELINE config 3's offline serving config (cfg1) at full width:
    refresh_union(per_slot=True) over a window of 4 prepped frames, then
    window_slot frames; a renderer with far_skip_tol 0, whose fast frames run
    the far kernels on the 3,364-row subgrid; the live path with refreshes
    every 4 frames (full, carried x3, full). Frames against the plain
    versions in the same flag state, launches per frame, no host sync in a
    served frame; errors against the dense no-skip frames printed. Returns
    the launches of the phase's driving."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.pair_field import pair_field_kernel

    t_phase = time.perf_counter()

    def config(**kw):
        return ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                                render=RenderConfig(**dict(CFG1_RENDER, **kw)))

    cfg = config()
    scene, args = _pair_scene(cfg, n_frames=CFG1_LIVE_FRAMES)

    def make(c):
        return renderer.make_frame_renderer(c, scene.hwfcxy, scene.near, scene.far)

    kernels = {"pair_field": pair_field_kernel, "far_head": far_head_kernel,
               "far_torso": far_torso_kernel}
    no_far = torch.full((H, W), float("inf"), device="cuda")

    def plain_check(tag, frame, render_plain):
        """frame against the same renderer call with the plain versions; under
        far_skip the composite has no far-plane term and is held everywhere."""
        captured = {}
        with _plain_pair_path(captured):
            head_r, com_r = render_plain()
            torch.cuda.synchronize()
        return _check_pair(f"cfg1 {tag}, kernels vs plain", frame[0], frame[1], head_r, com_r,
                           captured.get("sh", no_far))

    def served(render, frame_args, n_frames, slot):
        """n_frames frames, frame i under slot(i), through _run_frames (each
        a steady frame: launches counted, host syncs too): (frames, [(True,
        ms, launches)], host syncs, the far-plane rows of each far call)."""
        runs, calls = [], iter(range(n_frames))

        def slot_frame(*a):
            return render(*a, window_slot=slot(next(calls)))

        slot_frame.cache = render.cache
        with _spy("fused_far_eval_split", runs):
            out = _run_frames(slot_frame, frame_args, n_frames,
                              {k: (v, None) for k, v in kernels.items()}, lambda _: True)
        return (*out, [a[2].shape[0] for a, _, _ in runs])

    def launches_ok(marks, rows, far_skips):
        """Each frame launched pair_field twice and, where its state does
        not skip the far plane, far_head and far_torso once on the
        3,364-row subgrid."""
        want = [{"pair_field": 2} if fs else {"pair_field": 2, "far_head": 1, "far_torso": 1}
                for fs in far_skips]
        return [got for _, _, got in marks] == want and rows == [CFG1_FAR_ROWS] * far_skips.count(
            False)

    def prep(render, window):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render.refresh_union(window, per_slot=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    noskip = _serve_noskip_frames(cfg, args, CFG1_LIVE_FRAMES)
    with warnings.catch_warnings():
        # the sync debug mode's one-time notice that it is a prototype
        # mentions synchronizing operations: let it fire outside a frame
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    for k in kernels.values():
        k.launches = 0

    # offline: per-slot prep, then window_slot frames
    window = [make(cfg).inputs_fn(*args(i)) for i in range(CFG1_WINDOW)]
    trans_only = make(config(occ_prune_budget=0.0))
    trans_s = prep(trans_only, window)
    trans_pairs = [tuple(int(t.numel()) for t, _ in st["lists"]) for st in trans_only.cache["slots"]]
    print(f"[cfg1] window of {CFG1_WINDOW}, the trans prune alone: per-slot prep {trans_s:.3f} s, "
          f"slot pairs (head, torso) {trans_pairs}", flush=True)

    def budget_prep(budget):
        """A renderer of cfg1 with this budget, prepped over the window:
        (renderer, pairs it drops beyond the trans prune alone)."""
        r = make(config(occ_prune_budget=budget))
        keys = []
        real = renderer.deferred_composite

        def spy(*a, **kw):
            out = real(*a, **kw)
            if kw.get("with_ray_diag") and not keys:
                # slot 0's unpruned keys: each listed pair's largest ray cost
                occ = a[2].bool()
                keys.extend(float(x) for x in torch.quantile(torch.cat(
                    [out[8 + f].amax(dim=2).t()[occ[f]] for f in range(2)]),
                    torch.tensor([0.0, 0.1, 0.5, 0.9], device=occ.device)))
            return out

        renderer.deferred_composite = spy
        try:
            prep_s = prep(r, window)
        finally:
            renderer.deferred_composite = real
        for i, (st, sp) in enumerate(zip(r.cache["slots"], r.cache["slot_prep"])):
            print(f"[cfg1] budget {budget:g}, slot {i}: pairs (head, torso) unpruned "
                  f"{sp['pairs'][0]}, after the trans prune and the budget {sp['pairs'][1]}, after "
                  f"the refinement {sp['pairs'][-1]} ({sp['refined']} pairs dropped by the "
                  f"refinement, {sp['reverted']} tiles reverted); {len(st['tiles_u'])} union "
                  f"tiles; far_skip {st['far_skip']}, far_cmix_err {st['far_cmix_err']:.3e}",
                  flush=True)
        pairs = [sp["pairs"][-1] for sp in r.cache["slot_prep"]]
        dropped = sum(sum(a) - sum(b) for a, b in zip(trans_pairs, pairs))
        print(f"[cfg1] budget {budget:g}: per-slot prep {prep_s:.3f} s; slot 0's unpruned pairs' "
              f"largest ray cost min / 10% / 50% / 90% {' / '.join(f'{k:.3e}' for k in keys)}; "
              f"the budget drops {dropped} pairs beyond the trans prune", flush=True)
        if any(a[f] < b[f] for a, b in zip(trans_pairs, pairs) for f in range(2)):
            _fail("the budget kept a pair the trans prune alone drops")
        return r, dropped

    render, dropped = budget_prep(CFG1_RENDER["occ_prune_budget"])
    c = render.cache
    if not dropped:
        # random weights: cfg1's budget may drop nothing, so a second
        # renderer whose budget does drop pairs is served and held too
        dropper, dropped = budget_prep(CFG1_DROP_BUDGET)
        if not dropped:
            _fail(f"neither cfg1's budget nor {CFG1_DROP_BUDGET} dropped a pair beyond the trans "
                  f"prune")
    else:
        dropper = None

    frames, marks, syncs, rows = served(render, lambda i: args(i % CFG1_WINDOW),
                                        CFG1_SLOT_FRAMES, lambda i: i)
    ms = [m for _, m, _ in marks]
    print(f"[cfg1] {CFG1_SLOT_FRAMES} window_slot frames {H}x{W}: "
          f"{sum(ms) / len(ms):.2f} ms per frame ({', '.join(f'{m:.2f}' for m in ms)}; CUDA "
          f"events); launches per frame {[got for _, _, got in marks]}; far-plane rows {rows}; "
          f"host syncs {syncs}", flush=True)
    far_skips = [c["slots"][i % CFG1_WINDOW]["far_skip"] for i in range(CFG1_SLOT_FRAMES)]
    if not launches_ok(marks, rows, far_skips) or syncs:
        _fail(f"window_slot frames launched {[got for _, _, got in marks]} on far-plane rows "
              f"{rows} with far_skip {far_skips}; {syncs} host syncs")
    err = 0.0
    for i in range(CFG1_WINDOW):
        _check_frame(f"cfg1 slot frame {i}", *frames[i])
        err = max(err, plain_check(f"slot frame {i}", frames[i],
                                   lambda: render(*args(i), window_slot=i)))
    _noskip_errors("cfg1 window_slot frames", frames[:CFG1_WINDOW], noskip)
    if dropper is not None:
        d_frames, d_marks, d_syncs, d_rows = served(dropper, args, CFG1_WINDOW, lambda i: i)
        print(f"[cfg1] budget {CFG1_DROP_BUDGET:g}, window_slot frames "
              f"{', '.join(f'{m:.2f}' for _, m, _ in d_marks)} ms; launches "
              f"{[got for _, _, got in d_marks]}; host syncs {d_syncs}", flush=True)
        if d_syncs or not launches_ok(d_marks, d_rows, [st["far_skip"] for st in
                                                        dropper.cache["slots"]]):
            _fail(f"the budget {CFG1_DROP_BUDGET:g} frames launched "
                  f"{[got for _, _, got in d_marks]}, {d_syncs} host syncs")
        for i in (0, CFG1_WINDOW - 1):
            _check_frame(f"cfg1 budget {CFG1_DROP_BUDGET:g} slot frame {i}", *d_frames[i])
            err = max(err, plain_check(f"budget {CFG1_DROP_BUDGET:g} slot frame {i}", d_frames[i],
                                       lambda: dropper(*args(i), window_slot=i)))
        _noskip_errors(f"cfg1 budget {CFG1_DROP_BUDGET:g} window_slot frames", d_frames, noskip)

    # the far plane forced on: far_skip_tol 0, a window of one frame
    forced = make(config(far_skip_tol=0.0))
    forced_s = prep(forced, window[:1])
    f_frames, f_marks, f_syncs, f_rows = served(forced, args, 2, lambda i: 0)
    print(f"[cfg1] far_skip_tol 0: prep of one slot {forced_s:.3f} s; window_slot frames "
          f"{', '.join(f'{m:.2f}' for _, m, _ in f_marks)} ms; launches "
          f"{[got for _, _, got in f_marks]}; far-plane rows {f_rows}; host syncs {f_syncs}",
          flush=True)
    if f_syncs or not launches_ok(f_marks, f_rows, [False, False]):
        _fail(f"the forced far-plane frames launched {[got for _, _, got in f_marks]} on rows "
              f"{f_rows}, {f_syncs} host syncs")
    _check_frame("cfg1 forced far-plane frame 0", *f_frames[0])
    err = max(err, plain_check("forced far-plane frame 0", f_frames[0],
                               lambda: forced(*args(0), window_slot=0)))
    _noskip_errors("cfg1 forced far-plane frame", f_frames[:1], noskip)

    # live: refresh every 4 frames; the first 8 frames, then a carried
    # refresh frame (4) and a steady one (5) against the plain versions in
    # their flag state, which holds through frame 7; then frames 8 .. 19
    live = make(config(occ_refresh_every=CFG1_LIVE_EVERY))
    lc = live.cache

    def is_steady(cache):
        return cache["lists"] is not None and cache["age"] < CFG1_LIVE_EVERY

    kinds = []

    def live_frames(first, n):
        def on_refresh(i):
            kinds.append((first + i, lc["keep_age"],
                          tuple(int(t.numel()) for t, _ in lc["lists"]), lc["far_skip"],
                          lc["far_cmix_err"]))

        out = _run_frames(live, lambda i: args(first + i), n,
                          {k: (v, None) for k, v in kernels.items()}, is_steady, on_refresh)
        # each frame's far_skip: that of the refresh before it
        far_skips = [next(k[3] for k in reversed(kinds) if k[0] <= i)
                     for i in range(first, first + n)]
        return (*out, far_skips)

    l_frames, l_marks, l_syncs, l_skips = live_frames(0, 8)
    err = max(err, plain_check("live carried refresh frame 4", l_frames[4],
                               lambda: live.run_fast(*args(4))))
    err = max(err, plain_check("live steady frame 5", l_frames[5],
                               lambda: live.run_fast(*args(5))))
    more = live_frames(8, CFG1_LIVE_FRAMES - 8)
    l_frames, l_marks, l_syncs, l_skips = (l_frames + more[0], l_marks + more[1],
                                           l_syncs + more[2], l_skips + more[3])
    for i, keep_age, pairs, fs, cmix in kinds:
        print(f"[cfg1 live] refresh at frame {i}: keep_age {keep_age} "
              f"({'full' if keep_age == 0 else 'carried'}), lists {pairs}, far_skip {fs}, "
              f"far_cmix_err {cmix:.3e}", flush=True)
    if [k[:2] for k in kinds] != [(0, 0), (4, 1), (8, 2), (12, 3), (16, 0)]:
        _fail(f"live refreshes {[k[:2] for k in kinds]}, expected full, carried x3, full")
    steady = [(m, fs) for m, fs in zip(l_marks, l_skips) if m[0]]
    if not launches_ok([m for m, _ in steady], [CFG1_FAR_ROWS] * [fs for _, fs in steady].count(
            False), [fs for _, fs in steady]) or l_syncs:
        _fail(f"live steady frames launched {[m[2] for m, _ in steady]}, {l_syncs} host syncs")
    for i, (head, com) in enumerate(l_frames):
        _check_frame(f"cfg1 live frame {i}", head, com)
    _frame_times("cfg1 live", l_marks, CFG1_LIVE_EVERY)
    _noskip_errors("cfg1 live", l_frames, noskip)

    got = {name: k.launches for name, k in kernels.items()}
    _cfg1_far_times(make(cfg), args(0), float(torch.tensor(scene.far, dtype=torch.float32)))
    print(f"[cfg1] launches over the phase's driving {got}; frame-level error vs plain "
          f"{err:.3e}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if min(got.values()) == 0:
        _fail(f"a kernel of the cfg1 path never launched: {got}")
    return got


def _cfg1_far_times(render, a, far):
    """The fast frame's far stage at far_subsample=8 on frame a: the far
    kernels at 3,364 rows through their wrappers (which re-lay the weight
    blobs at every call) and as bare launches of blobs staged once, and the
    whole stage (subgrid, view bias, both kernels, the two upsamples)."""
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.fused_render import _slot_tables, view_bias
    from dfanerf_torch.render.renderer import far_subgrid, far_upsample, far_upsample_matrix

    pw_h, pw_t, ro, rd, ro_t, rd_t, _ = render.inputs_fn(*a)
    A = torch.from_numpy(far_upsample_matrix(8)).cuda()
    o, d, o_t, d_t = (far_subgrid(x, 8) for x in (ro, rd, ro_t, rd_t))
    n, dev = o.shape[0], o.device
    vr = view_bias(pw_t, d_t).to(torch.bfloat16).contiguous()
    freq, phase = _slot_tables(dev)
    (w_h, b_h), (w_t, b_t) = far_head_kernel.blobs(pw_h, "head", dev), far_torso_kernel.blobs(
        pw_t, "torso", dev)
    sh, ct = torch.empty((n, 1), device=dev), torch.empty((n, 3), device=dev)
    wrapped = {"far_head": lambda: far_head_kernel(pw_h, o, d, far, act="softplus"),
               "far_torso": lambda: far_torso_kernel(pw_t, o_t, d_t, far, vr, act="softplus")}
    bare = {"far_head": lambda: far_head_kernel.launch("far_eval_launch", dev, 0, o, d, far, None,
                                                       freq, phase, w_h, b_h, sh, n, 1),
            "far_torso": lambda: far_torso_kernel.launch("far_eval_launch", dev, 1, o_t, d_t, far,
                                                         vr, freq, phase, w_t, b_t, ct, n, 1)}

    def stage():
        s_o, s_d, s_ot, s_dt = (far_subgrid(x, 8) for x in (ro, rd, ro_t, rd_t))
        v = view_bias(pw_t, s_dt).to(torch.bfloat16).contiguous()
        return (far_upsample(far_head_kernel(pw_h, s_o, s_d, far, act="softplus"), A),
                far_upsample(far_torso_kernel(pw_t, s_ot, s_dt, far, v, act="softplus"), A))

    for fn in list(wrapped.values()) + list(bare.values()) + [stage]:
        fn()
    times = {f"{k} {kind}": _cuda_ms(fns[k], 20) for kind, fns in (("wrapped", wrapped),
                                                                      ("bare", bare))
             for k in fns}
    print(f"[cfg1] far stage at far_subsample=8, {n} rows: "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in times.items())
          + f"; whole stage (subgrid, view bias, both wrapped kernels, upsample) "
          f"{_cuda_ms(stage, 20):.3f} ms", flush=True)


# BASELINE config 3's live serving config, cfg2 of
# benchmarks/serve_trained.py:313-321, verbatim: cfg1 with the async refresh
# worker every 4 frames, carry off, the decayed prune history and the served
# frames' own prune keys.
CFG2_RENDER = dict(CFG1_RENDER, occ_async_refresh=True, occ_refresh_every=4, occ_prune_carry=0,
                   occ_prune_hist_decay=0.8, occ_live_keys=True)
CFG2_WINDOW = 8      # the frames served, cycled (serve_trained's 8-frame window)
CFG2_WARM = 17       # two refresh cycles before timing (serve_trained.py:325)
CFG2_TIMED, CFG2_PASSES = 20, 3  # bench_fps (serve_trained.py:78)
# paced_live_protocol (serve_trained.py:430-487): 25 fps arrivals, a ring of
# 4 frames in flight, 32 settle frames, 60 measured
CFG2_FPS, CFG2_DEPTH, CFG2_SETTLE, CFG2_PACED = 25.0, 4, 32, 60
CFG2_DROP_FRAMES = 16  # the budget-2e-2 renderer's frames, its worker joined


def _sync_error(fn):
    """fn() with torch's sync debug mode at "error" (a host sync raises its
    "called a synchronizing CUDA operation"; any other error passes on)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        if "synchronizing CUDA operation" not in str(e):
            raise
        _fail(f"a served frame synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _worker_ok(wk):
    """render() takes a worker's error in, counts it in "fails" and serves
    the frame stale: either way the worker raised."""
    if wk["error"] is not None or wk["fails"]:
        _fail(f"the refresh worker raised: {wk['error']!r}, fails {wk['fails']}")


def _join_worker(wk):
    th = wk["thread"]
    if th is not None:
        th.join(timeout=120.0)
        if th.is_alive():
            _fail("the refresh worker did not finish in 120 s")
    _worker_ok(wk)


def _after_swap_vs_plain(tag, render, a, serve):
    """A frame just after a swap against the plain versions in its state:
    ``serve(i)`` serves frames until the live renderer's worker runs, the
    worker is joined, the frame of args ``a`` must swap its state in (under
    sync debug "error"), and is held against the plain versions under the
    swapped lists. Returns the frame-level error."""
    c, wk = render.cache, render.worker
    for i in range(2 * CFG2_WINDOW):
        if wk["thread"] is not None:
            break
        serve(i)
    _join_worker(wk)
    torch.cuda.synchronize()
    swaps0 = c.get("swaps", 0)
    head, com = _sync_error(lambda: render(*a))
    if c.get("swaps", 0) != swaps0 + 1 or wk["thread"] is not None:
        _fail(f"the frame after the worker ended: swaps {swaps0} -> {c.get('swaps', 0)}, a "
              f"worker running {wk['thread'] is not None}")
    _check_frame(tag, head, com)
    kf = c["key_frames"]
    kept = list(kf)
    captured = {}
    with _plain_pair_path(captured):
        head_r, com_r = render.run_fast(*a)
        torch.cuda.synchronize()
    kf.clear()
    kf.extend(kept)  # the plain frame's keys are not a served frame's
    err = _check_pair(f"{tag}, kernels vs plain", head, com, head_r, com_r,
                      captured.get("sh", torch.full((H, W), float("inf"), device="cuda")))
    _join_worker(wk)
    return err


def phase_cfg2(card):
    """BASELINE config 3's live serving config (cfg2) at full width, on phase
    10's recipe, scene and weights: 17 warm frames, then unpaced frames timed
    as bench_fps times them (ms per frame, spread, swaps), then the paced
    protocol at 25 fps (misses, swaps, the error of every frame against the
    dense no-skip frames); every served frame under sync debug mode "error";
    the launches of each served frame; a frame just after a swap against the
    plain versions in the swapped state; a second renderer at budget 2e-2
    whose worker is joined, with the pairs each derive drops. Returns the
    launches of the phase, the worker's included."""
    from collections import deque

    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.pair_field import pair_field_kernel

    t_phase = time.perf_counter()

    def config(**kw):
        return ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                                render=RenderConfig(**dict(CFG2_RENDER, **kw)))

    cfg = config()
    scene, args = _pair_scene(cfg, n_frames=CFG2_WINDOW)
    kernels = {"pair_field": pair_field_kernel, "far_head": far_head_kernel,
               "far_torso": far_torso_kernel}
    noskip = _serve_noskip_frames(cfg, args, CFG2_WINDOW)
    ref_com = [com for _, com in noskip]
    del noskip
    for k in kernels.values():
        k.launches, k.worker_launches = 0, 0
    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    c, wk = render.cache, render.worker
    launches = []  # (served frame's launches, far_skip of its state)

    def frame(i):
        a = args(i % CFG2_WINDOW)
        _worker_ok(wk)
        before = {n: k.launches for n, k in kernels.items()}
        out = render(*a) if c["lists"] is None else _sync_error(lambda: render(*a))
        launches.append(({n: k.launches - before[n] for n, k in kernels.items()},
                         c["far_skip"]))
        _worker_ok(wk)
        return out

    # warm-up: the first frame refreshes in the serving thread, the rest are
    # served while the worker refreshes
    t0 = time.perf_counter()
    for i in range(CFG2_WARM):
        frame(i)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _join_worker(wk)
    print(f"[cfg2] {CFG2_WARM} warm frames {warm_s:.2f} s: swaps {c.get('swaps', 0)}, derives "
          f"{c.get('derive_ct', 0)}, key frames {len(c.get('key_frames', ()))}, lists "
          f"{tuple(int(t.numel()) for t, _ in c['lists'])}, far_skip {c['far_skip']}", flush=True)

    # unpaced: bench_fps's passes, each frame between CUDA events
    rates, frame_ms, swaps0 = [], [], c.get("swaps", 0)
    for p in range(CFG2_PASSES):
        marks = []
        t0 = time.perf_counter()
        for i in range(CFG2_TIMED):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            frame(i)
            e1.record()
            marks.append((e0, e1))
        torch.cuda.synchronize()
        rates.append(CFG2_TIMED / (time.perf_counter() - t0))
        frame_ms += [e0.elapsed_time(e1) for e0, e1 in marks]
    unpaced_swaps = c.get("swaps", 0) - swaps0
    per = sorted(1e3 / r for r in rates)
    print(f"[cfg2] unpaced ({card}): {CFG2_PASSES} passes of {CFG2_TIMED} frames {H}x{W}, "
          f"{N_SAMPLES} samples: median {per[len(per) // 2]:.2f} ms per frame "
          f"({', '.join(f'{m:.2f}' for m in per)} ms per frame by pass, wall clock; "
          f"{', '.join(f'{r:.2f}' for r in rates)} fps); each frame's span on the serving "
          f"stream (CUDA events) min {min(frame_ms):.2f} / median "
          f"{sorted(frame_ms)[len(frame_ms) // 2]:.2f} / max {max(frame_ms):.2f} ms; "
          f"{unpaced_swaps} swaps landed", flush=True)

    # paced: serve_trained.py's paced_live_protocol; a frame misses when its
    # bytes land on the host after its arrival + CFG2_DEPTH frame times
    frame_dt, n_total = 1.0 / CFG2_FPS, CFG2_SETTLE + CFG2_PACED
    ring, errs_dev, misses = deque(), [], [0, 0]  # misses: settle, measured
    swaps0 = None
    t_start = time.perf_counter()
    t_measure = None

    def present():
        j, deadline, done, _ = ring.popleft()
        done.synchronize()
        if time.perf_counter() > deadline:
            misses[j >= CFG2_SETTLE] += 1

    for i in range(n_total):
        lag = t_start + i * frame_dt - time.perf_counter()
        if lag > 0:
            time.sleep(lag)  # the frame's signal has not arrived yet
        if i == CFG2_SETTLE:
            swaps0, t_measure = c.get("swaps", 0), time.perf_counter()
        _, com = frame(i)
        if i >= CFG2_SETTLE:
            errs_dev.append((com - ref_com[i % CFG2_WINDOW]).abs().amax())
        u8 = (com.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(u8, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        ring.append((i, t_start + (i + CFG2_DEPTH) * frame_dt, done, host))
        while len(ring) > CFG2_DEPTH:
            present()
    while ring:
        present()
    paced_s = time.perf_counter() - t_measure
    paced_swaps = c.get("swaps", 0) - swaps0
    errs = torch.stack(errs_dev).cpu().tolist()
    print(f"[cfg2] paced at {CFG2_FPS:g} fps ({card}), depth {CFG2_DEPTH}, {CFG2_SETTLE} settle + "
          f"{CFG2_PACED} measured frames: {misses[1]} misses ({misses[0]} in the settle "
          f"frames), {paced_swaps} swaps landed, measured "
          f"rate {CFG2_PACED / paced_s:.2f} fps; error vs the dense no-skip frames (random "
          f"weights set no bar) max {max(errs):.4e}, max of the last 24 {max(errs[-24:]):.4e}; "
          f"per frame {', '.join(f'{e:.2e}' for e in errs)}", flush=True)
    if not paced_swaps:
        _fail("no swap landed in the paced window")

    # every served frame launched pair_field twice and, where its state
    # keeps the far plane, far_head and far_torso once each
    bad = [(n, fs) for n, fs in launches[1:]
           if n != {"pair_field": 2, "far_head": 1 - fs, "far_torso": 1 - fs}]
    print(f"[cfg2] {len(launches) - 1} served frames' launches: pair_field 2 each, far "
          f"{sum(n['far_head'] for n, _ in launches[1:])} (far_skip in "
          f"{sum(fs for _, fs in launches[1:])} frames); {len(bad)} frames otherwise", flush=True)
    if bad:
        _fail(f"served frames launched {bad[:4]}")

    # a frame just after a swap against the plain versions in its state
    err = _after_swap_vs_plain("cfg2 frame after a swap", render, args(0), frame)
    print(f"[cfg2] budget {CFG2_RENDER['occ_prune_budget']:g}: swaps {c['swaps']}, derives "
          f"{c['derive_ct']}, lists {tuple(int(t.numel()) for t, _ in c['lists'])}; launches "
          f"served {({n: k.launches for n, k in kernels.items()})}, worker "
          f"{({n: k.worker_launches for n, k in kernels.items()})}", flush=True)
    del render, c, wk, ref_com

    # the keys-derived prune at work: budget 2e-2, the worker joined after
    # each frame so that each derive's drops can be read
    dropper = renderer.make_frame_renderer(config(occ_prune_budget=CFG1_DROP_BUDGET),
                                           scene.hwfcxy, scene.near, scene.far)
    dc, dw = dropper.cache, dropper.worker
    runs, derives = [], []
    with _spy("conservative_occupancy", runs):
        for i in range(CFG2_DROP_FRAMES):
            n_derive = dc.get("derive_ct", 0)
            dropper(*args(i % CFG2_WINDOW))
            th = dw["thread"]
            if th is not None:
                th.join(timeout=120.0)
            if dw["error"] is not None or dw["fails"]:
                _fail(f"the refresh worker raised: {dw['error']!r}, fails {dw['fails']}")
            if dc.get("derive_ct", 0) > n_derive:
                flags = runs[-1][2]
                st = dw["result"][0]
                kind = "full" if n_derive % cfg.render.occ_live_remeasure == 0 else "keys"
                pairs = tuple(int(t.numel()) for t, _ in st["lists"])
                derives.append((kind, int(flags.sum()) - sum(pairs)))
                print(f"[cfg2] budget {CFG1_DROP_BUDGET:g}, derive {n_derive} ({kind}) at frame "
                      f"{i}: {int(flags[0].sum())} + {int(flags[1].sum())} flagged pairs, "
                      f"{pairs[0]} + {pairs[1]} kept, {derives[-1][1]} dropped", flush=True)
    if dw["error"] is not None or dw["fails"]:
        _fail(f"the refresh worker raised: {dw['error']!r}, fails {dw['fails']}")
    got = {n: k.launches + k.worker_launches for n, k in kernels.items()}
    print(f"[cfg2] launches over the phase's driving {got}; frame-level error vs plain "
          f"{err:.3e}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not any(d > 0 for kind, d in derives if kind == "keys"):
        _fail(f"no keys derive dropped a pair at budget {CFG1_DROP_BUDGET:g}: {derives}")
    if min(got.values()) == 0:
        _fail(f"a kernel of the cfg2 path never launched: {got}")
    return got


# BASELINE config 4, audio to video (benchmarks/serve_trained.py:490-640,
# called at :358 on cfg2): e2e_audio_video drives cfg2 with the features of
# a synthesized utterance. The audio nets (plain PyTorch: torch.fft, cuDNN's
# convolutions, the LSTM) run at full width on the card and on the CPU,
# whose path the CPU tests hold against the reference, within the tests'
# bars: mel to 1e-4; features and logits to rtol 1e-4 / atol 1e-4; the
# signals of the DeepSpeech-driven frames to 1e-5.
AV_FRAMES = 40                  # e2e_audio_video's default is 80
AV_DS_FRAMES = (10, 11)         # the DeepSpeech-driven dense frames
AV_TOL = {"mel": 1e-4, "rtol": 1e-4, "atol": 1e-4, "signal": 1e-5}


def _read_y4m(path):
    """(tags, planes [N, 3, H, W] uint8) of a 4:4:4 YUV4MPEG2 file."""
    import numpy as np

    with open(path, "rb") as f:
        head, _, body = f.read().partition(b"\n")
    fields = head.split(b" ")
    if fields[0] != b"YUV4MPEG2":
        _fail(f"{path}: no YUV4MPEG2 header")
    tags = {t[:1].decode(): t[1:].decode() for t in fields[1:]}
    w, h = int(tags["W"]), int(tags["H"])
    size = len(b"FRAME\n") + 3 * h * w
    if len(body) % size or any(body[i:i + 6] != b"FRAME\n" for i in range(0, len(body), size)):
        _fail(f"{path}: frames of another size or without their FRAME marker")
    return tags, np.frombuffer(body, np.uint8).reshape(-1, size)[:, 6:].reshape(-1, 3, h, w)


def _audio_nets_vs_cpu(wav):
    """The audio nets at full width on the card and on the CPU, the same
    module and the same wav: the mel spectrogram, the wav2exp features, the
    DeepSpeech (n_hidden 2048, seeded weights) logits and features. Each
    stage's time on the card by CUDA events, after a warm-up. Returns the
    card's DeepSpeech features [N, 16, 29]."""
    import copy

    from dfanerf_torch.pipeline.audio import deepspeech, frontend, wav2exp

    def held(tag, got, ref, rtol, atol, ms):
        got, ref = torch.as_tensor(got).cpu(), torch.as_tensor(ref)
        err = float((got - ref).abs().max())
        print(f"[audio] {tag} {tuple(got.shape)}: card vs CPU max {err:.3e} (rtol {rtol:g}, atol "
              f"{atol:g}); card {ms:.2f} ms", flush=True)
        if got.shape != ref.shape or not torch.allclose(got, ref, rtol=rtol, atol=atol):
            _fail(f"{tag}: the card's output disagrees with the CPU's")

    wav_t = torch.from_numpy(wav)
    enc = wav2exp.init_audio_encoder(3, device="cuda")
    enc_cpu = copy.deepcopy(enc).cpu()
    wav2exp.wav2exp_features(enc, wav)  # warm-up: cuFFT's plans, cuDNN's algorithms
    mel, mel_ms = _cuda_call(lambda: frontend.melspectrogram(wav_t.cuda()))
    held("mel", mel, frontend.melspectrogram(wav_t), 0.0, AV_TOL["mel"], mel_ms)
    feats, feat_ms = _cuda_call(lambda: wav2exp.wav2exp_features(enc, wav))
    held("wav2exp features", feats, wav2exp.wav2exp_features(enc_cpu, wav), AV_TOL["rtol"],
         AV_TOL["atol"], feat_ms)
    net = deepspeech.init_deepspeech(0, device="cuda")
    net_cpu = copy.deepcopy(net).cpu()
    wav16 = wav * 32767.0  # the MFCC takes int16-scale samples
    deepspeech.deepspeech_logits(net, wav16)  # warm-up
    logits, logit_ms = _cuda_call(lambda: deepspeech.deepspeech_logits(net, wav16))
    held("DeepSpeech logits", logits, deepspeech.deepspeech_logits(net_cpu, wav16),
         AV_TOL["rtol"], AV_TOL["atol"], logit_ms)
    feats_ds, ds_ms = _cuda_call(lambda: deepspeech.deepspeech_features_from_wav(net, wav16))
    held("DeepSpeech features", feats_ds, deepspeech.deepspeech_features_from_wav(net_cpu, wav16),
         AV_TOL["rtol"], AV_TOL["atol"], ds_ms)
    return feats_ds


def phase_audio_video(card):
    """BASELINE config 4 at full width: the audio nets on the card against
    the CPU; e2e_audio_video over cfg2 (phase 11's recipe, scene and
    weights) at AV_FRAMES frames, every driven frame under sync debug "error" with
    its launches counted, the .y4m read back, a frame after a swap against
    the plain versions; then 2 dense frames (render_rays <1,1,1>) driven by
    DeepSpeech features, their signals against the CPU's. Returns the
    launches of the phase, the refresh worker's included."""
    import copy

    import numpy as np

    import dfanerf_torch.render.audio_video as audio_video
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig
    from dfanerf_torch.data.synthetic import make_synthetic_scene
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel
    from dfanerf_torch.ops.fused_render import render_rays_kernel
    from dfanerf_torch.ops.pair_field import pair_field_kernel
    from dfanerf_torch.train.state import init_train_state

    t_phase = time.perf_counter()
    wav = audio_video.synth_wav(AV_FRAMES)
    feats_ds = _audio_nets_vs_cpu(wav)

    # e2e_audio_video over cfg2, each driven frame through a counting wrapper
    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**CFG2_RENDER))
    scene = make_synthetic_scene(n_frames=CFG2_WINDOW, H=H, W=W, seed=0)
    state = _pair_state(cfg)
    data = {"poses": torch.from_numpy(scene.poses).cuda(),
            "bc_img": torch.from_numpy(scene.bc_img).cuda()}
    kernels = {"pair_field": pair_field_kernel, "far_head": far_head_kernel,
               "far_torso": far_torso_kernel}
    driven = {"launches": [], "com": [], "swaps": []}  # swaps: the count after each frame
    real_make = audio_video.make_frame_renderer

    def make_driven(*a, **kw):
        render = real_make(*a, **kw)
        c, wk = render.cache, render.worker

        def frame(*fa):
            _worker_ok(wk)
            before = {name: k.launches for name, k in kernels.items()}
            out = render(*fa)
            driven["launches"].append((
                {name: k.launches - before[name] for name, k in kernels.items()}, c["far_skip"]))
            driven["com"].append(out[1])
            driven["swaps"].append(c.get("swaps", 0))
            driven["args"] = fa
            _worker_ok(wk)
            return out

        frame.cache, frame.worker = c, wk
        driven.update(render=render, frame=frame)
        return frame

    def checked(fn):
        """A driven frame's work on the device (its signals and render; in
        the timed render also the uint8 conversion and the ring copy's
        dispatch) under sync debug "error", but for the first frame, which
        refreshes in the serving thread."""
        return fn() if driven["render"].cache["lists"] is None else _sync_error(fn)

    for k in kernels.values():
        k.launches, k.worker_launches = 0, 0
    audio_video.make_frame_renderer = make_driven
    try:
        out = audio_video.e2e_audio_video(cfg, scene, state, data, n_frames=AV_FRAMES, card=card,
                                          frame_hook=checked)
    finally:
        audio_video.make_frame_renderer = real_make
    render, launches = driven["render"], driven["launches"]
    n = out["n_frames"]
    print(f"[audio_video] e2e_audio_video over cfg2, {n} frames {H}x{W} ({out['card']}): "
          f"feature_warm_s {out['feature_warm_s']:.4f}, feature_s {out['feature_s']:.4f}, "
          f"render_s {out['render_s']:.4f}, encode_s {out['encode_s']:.4f}, headroom_s "
          f"{out['headroom_s']}; fps_e2e {out['fps_e2e']:.3f}, render_fps "
          f"{out['render_fps']:.3f}; {out['swaps']} swaps landed in the timed render",
          flush=True)
    if n != AV_FRAMES or len(launches) != AV_FRAMES + 2 * CFG2_RENDER["occ_refresh_every"] + 1:
        _fail(f"{n} timed frames, {len(launches)} driven")
    # the swaps the timed frames saw, and the worker joined at the return
    seen = driven["swaps"][-1] - driven["swaps"][-n - 1]
    th = render.worker["thread"]
    print(f"[audio_video] swaps after each timed frame {driven['swaps'][-n - 1:]}: {seen} in the "
          f"timed render; the refresh worker {'running' if th and th.is_alive() else 'joined'} "
          f"at the return", flush=True)
    if out["swaps"] != seen or (th is not None and th.is_alive()):
        _fail(f"e2e_audio_video reported {out['swaps']} swaps, the frames saw {seen}; or it "
              "returned with its worker running")

    # every driven frame but the first (a refresh in the serving thread):
    # pair_field twice, the far kernels once each where the state keeps the
    # far plane
    bad = [(m, fs) for m, fs in launches[1:]
           if m != {"pair_field": 2, "far_head": 1 - fs, "far_torso": 1 - fs}]
    print(f"[audio_video] {len(launches) - 1} driven frames' launches: pair_field 2 each, far "
          f"{sum(m['far_head'] for m, _ in launches[1:])} (far_skip in "
          f"{sum(fs for _, fs in launches[1:])} frames); {len(bad)} frames otherwise", flush=True)
    if bad:
        _fail(f"driven frames launched {bad[:4]}")

    # the video: its header, its frames, the timed frames' luma
    tags, planes = _read_y4m(out["video"])
    u8 = torch.stack(driven["com"][-n:]).clamp(0.0, 1.0).mul(255.0).to(torch.uint8).float()
    luma = (16.0 + 219.0 / 255.0 * (0.299 * u8[..., 0] + 0.587 * u8[..., 1]
                                     + 0.114 * u8[..., 2])).cpu().numpy()
    y_err = float(np.abs(planes[:, 0].astype(np.float32) - luma).max()) if len(planes) == n \
        else float("inf")
    print(f"[audio_video] {out['video']}: {tags}, {planes.shape[0]} frames of "
          f"{planes.shape[3]}x{planes.shape[2]}, Y' vs the frames' luma max {y_err:.3f} (tol 1)",
          flush=True)
    if (tags["W"], tags["H"], tags["C"]) != (str(W), str(H), "444") or y_err > 1.0:
        _fail("the video does not hold the driven frames")
    os.remove(out["video"])
    os.rmdir(os.path.dirname(out["video"]))
    del u8, luma, planes
    driven["com"].clear()

    # a driven frame just after a swap against the plain versions
    err = _after_swap_vs_plain("audio_video frame after a swap", render, driven["args"],
                               lambda i: checked(lambda: driven["frame"](*driven["args"])))
    got = {name: k.launches + k.worker_launches for name, k in kernels.items()}
    del render, driven

    # the DeepSpeech path: dense frames (render_rays <1,1,1>) driven by the
    # card's DeepSpeech features through AudioNet
    ds_cfg = ExperimentConfig(
        render=RenderConfig(n_samples=N_SAMPLES, concate_bg=True, compute_dtype="bfloat16",
                            use_fused_kernel=True, spatial_tiles=True),
        signal=SignalConfig(audio_net="deepspeech"))
    n_ds = feats_ds.shape[0]
    ds_scene = make_synthetic_scene(n_frames=n_ds, H=H, W=W, seed=0)
    ds_state = init_train_state(ds_cfg, seed=0, device="cuda")
    params_cpu = copy.deepcopy(ds_state["params"]).cpu()
    host = [torch.from_numpy(x) for x in (feats_ds, ds_scene.exps, ds_scene.poses)]
    auds, exps, poses = (x.cuda() for x in host)
    bc_img = torch.from_numpy(ds_scene.bc_img).cuda()
    dense = renderer.make_frame_renderer(ds_cfg, ds_scene.hwfcxy, ds_scene.near, ds_scene.far)
    render_rays_kernel.launches = 0
    sig_err = 0.0
    for i in AV_DS_FRAMES:
        sig, sig_t = renderer.encode_frame_signals(ds_state["params"], auds, exps, poses, i, n_ds,
                                                   ds_cfg, True)
        ref = renderer.encode_frame_signals(params_cpu, *host, i, n_ds, ds_cfg, True)
        sig_err = max(sig_err, float((sig.cpu() - ref[0]).abs().max()),
                      float((sig_t.cpu() - ref[1]).abs().max()))
        head, com = dense(ds_state["params"], ds_state["z_shape"], ds_state["z_app"], poses[i],
                          poses[0], sig, sig_t, bc_img)
        _check_frame(f"DeepSpeech-driven frame {i}", head, com)
    torch.cuda.synchronize()
    got["render_rays"] = render_rays_kernel.launches
    print(f"[audio_video] DeepSpeech-driven frames {AV_DS_FRAMES} ({n_ds} windows of "
          f"{tuple(feats_ds.shape[1:])}): signals card vs CPU max {sig_err:.3e} (tol "
          f"{AV_TOL['signal']:g}); frames finite, in [0, 1]; render_rays launches "
          f"{got['render_rays']}", flush=True)
    if sig_err > AV_TOL["signal"] or got["render_rays"] != len(AV_DS_FRAMES):
        _fail("the DeepSpeech-driven frames")
    print(f"[audio_video] launches over the phase's driving {got}; frame-level error vs plain "
          f"{err:.3e}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if min(got.values()) == 0:
        _fail(f"a kernel of the audio to video path never launched: {got}")
    return got


# Hierarchical head render, BASELINE config 2 (benchmarks/serve_trained.py:
# 654-662): 64 coarse + 128 fine samples, bf16, softplus density; no-skip
# (dense, occ_sigma_thresh 0, ert_eps 0) and the pair-compacted serving
# recipe (occupancy grid 48, refresh every 4 frames, budgeted contribution
# prune 3e-3, the default transmittance prune).
HIER_NOSKIP = dict(n_samples=N_SAMPLES, n_importance=128, compute_dtype="bfloat16",
                   use_fused_kernel=True, ert_eps=0.0, occ_sigma_thresh=0.0, occ_grid_res=48)
HIER_PAIRS = dict(HIER_NOSKIP, ert_eps=1e-4, occ_sigma_thresh=2.0, occ_pair_compaction=True,
                  occ_refresh_every=4, occ_prune_contrib=3e-3)
HIER_FRAMES = 12  # refreshes at frames 0, 4 and 8
# Added to the seeded sigma_out bias for both hierarchical paths (the same
# weights, so the pair frames can be held against the no-skip frames). As
# for the head+torso pair path above, softplus of the unshifted random-init
# density is above the node threshold everywhere; this shift puts the node
# threshold into the upper tail of the head's raw densities on the head-only
# grid, so the coarse flags and the fine pairs are mixed (a search over the
# shift on frame 0's refresh, on an H100; the pair phase prints the lists).
HIER_SHIFT = -0.455


def _hier_rays(scene):
    """Frame 0's head rays in spatial-tile order, as the dense hierarchical
    renderer builds them."""
    from dfanerf_torch.core.rays import get_rays
    from dfanerf_torch.ops.fused_render import spatial_tile_permutation

    perm = spatial_tile_permutation(H, W).cuda()
    _, _, focal, cx, cy = scene.hwfcxy
    ro, rd = get_rays(H, W, focal, torch.from_numpy(scene.poses[0]).cuda(), cx, cy)
    return ro.reshape(-1, 3)[perm].contiguous(), rd.reshape(-1, 3)[perm].contiguous()


def _check_sigma_buf(tag, got, ref, clear=None):
    """Densities, kernel vs plain: relative bar, and exact zeros in `clear`."""
    rel = _sigma_rel(got, ref)
    n_zero = 0 if clear is None else int((got[clear] != 0).sum())
    print(f"[{tag}] sigma max rel err {rel:.3e} (tol {SIG_RTOL:.0e} of |sigma| + "
          f"{SIG_FLOOR:.0e}), abs {float((got - ref).abs().max()):.3e}"
          + ("" if clear is None else f"; {n_zero} non-zero of {int(clear.sum())} in clear slabs"),
          flush=True)
    if not torch.isfinite(got).all():
        _fail(f"{tag}: non-finite densities")
    if rel > SIG_RTOL or n_zero:
        _fail(f"{tag}: kernel disagrees with its plain version")
    return float((got - ref).abs().max())


def _check_head(tag, got, ref, max_tol=None, mean_tol=None):
    """Head colours, kernel vs plain (TOL's head bars unless given)."""
    hm, ha = _errors(got, ref)
    max_tol = TOL["head_max"] if max_tol is None else max_tol
    mean_tol = TOL["head_mean"] if mean_tol is None else mean_tol
    print(f"[{tag}] head max {hm:.3e} mean {ha:.3e} (tol {max_tol:.2e}/{mean_tol:.2e})",
          flush=True)
    if not torch.isfinite(got).all():
        _fail(f"{tag}: non-finite output")
    if hm > max_tol or ha > mean_tol:
        _fail(f"{tag}: kernel disagrees with its plain version")
    return hm


def phase_hier_kernels_vs_plain():
    """sigma_head, render_head, pair_sigma and pair_field_perz against their
    plain versions on the card, at a 450x450 frame's rays and the config's
    64 + 128 samples, seeded bf16 packed weights; then the cross-check of
    the two hand-written paths (pair kernels with every pair listed against
    the dense kernels, pair_sigma against sigma_head bit for bit)."""
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.data.synthetic import make_synthetic_scene
    from dfanerf_torch.models import Decoder, DecoderConfig
    from dfanerf_torch.models.layers import init_uniform_
    from dfanerf_torch.ops.composite import deferred_composite_head
    from dfanerf_torch.ops.fused_render import view_bias
    from dfanerf_torch.ops.pack import pack_field_weights
    from dfanerf_torch.ops.pair_hier import (
        pair_field_eval_perz, pair_field_eval_perz_reference, pair_field_perz_kernel,
        pair_sigma_eval, pair_sigma_eval_reference, pair_sigma_kernel,
    )
    from dfanerf_torch.ops.render_head import (
        fused_render_head_reference, prepare_head_operands, render_head_kernel,
    )
    from dfanerf_torch.ops.sigma_head import fused_sigma_head_reference, sigma_head_kernel

    g = torch.Generator().manual_seed(3)
    scene = make_synthetic_scene(n_frames=1, H=H, W=W, seed=0)
    ro, rd = _hier_rays(scene)
    n = ro.shape[0]
    T, J_c, J_f = n // 256, N_SAMPLES // 8, (N_SAMPLES + 128) // 8
    z_c = linspace(scene.near, scene.far, N_SAMPLES, device="cuda")
    z_f = torch.sort(torch.cat([z_c.expand(n, -1), scene.near + (scene.far - scene.near) * torch.rand(
        (n, 128), generator=g).cuda()], dim=1), dim=1).values.contiguous()
    bc = torch.rand((n, 3), generator=g).cuda()
    vecs = [torch.randn(k, generator=g).cuda() for k in (96, 256, 256)]

    def head_pack(bias=None):
        dec = init_uniform_(Decoder(DecoderConfig()), torch.Generator().manual_seed(3)).cuda()
        if bias is not None:
            with torch.no_grad():
                dec.sigma_out.bias.fill_(bias)
        return pack_field_weights(dec, *vecs, "head")

    pw = head_pack()
    flags_c = (torch.rand((T, J_c), generator=g) < 0.5).to(torch.int32).cuda()
    flags_f = (torch.rand((T, J_f), generator=g) < 0.5).to(torch.int32).cuda()
    all_c = torch.ones_like(flags_c)
    print(f"[hier kernels vs plain] {T} tiles, {N_SAMPLES} + {z_f.shape[1] - N_SAMPLES} samples; flags "
          f"{int(flags_c.sum())} of {T * J_c} coarse, {int(flags_f.sum())} of {T * J_f} fine",
          flush=True)

    # A: sigma_head, flags with gaps (softplus) and every flag set (relu)
    sig_all = {}
    for act, occ in (("softplus", flags_c), ("relu", all_c)):
        got = sigma_head_kernel(pw, ro, rd, z_c, occ, act)
        torch.cuda.synchronize()
        ref = fused_sigma_head_reference(pw, ro, rd, z_c, occ, act)
        clear = (occ == 0).repeat_interleave(256, 0).repeat_interleave(8, 1)
        _check_sigma_buf(f"sigma_head vs plain, {act}, {int(occ.sum())} of {T * J_c} slabs", got,
                         ref, clear)
        sig_all[act] = got

    # B: render_head on per-ray depths: flags with gaps and ERT (softplus),
    # no flags and no ERT (relu), and a saturating field (ERT slab counts)
    for tag, pack, eps, occ, act in (("flags, ert_eps=1e-4, softplus", pw, 1e-4, flags_f, "softplus"),
                                     ("ert_eps=0, relu", pw, 0.0, None, "relu"),
                                     ("ert_eps=1e-4 saturating field", head_pack(200.0), 1e-4, None,
                                      "relu")):
        ops = prepare_head_operands(pack, ro, rd, z_f, bc, 1e10, eps, occ, act)
        got, slabs = render_head_kernel(ops)
        torch.cuda.synchronize()
        ref, slabs_r = fused_render_head_reference(ops)
        _check_head(f"render_head vs plain, {tag}", got, ref)
        if not torch.equal(slabs, slabs_r):
            _fail(f"render_head {tag}: slabs run differ from the plain version's")
        print(f"[render_head vs plain, {tag}] slabs run {int(slabs.sum())} of {T * J_f}, equal",
              flush=True)

    # C and D: lists with gaps, relu and softplus; empty lists
    t_c, j_c = (x.to(torch.int32).contiguous() for x in flags_c.nonzero(as_tuple=True))
    t_f, j_f = (x.to(torch.int32).contiguous() for x in flags_f.nonzero(as_tuple=True))
    z_buf = torch.cat([z_f.reshape(T, 256, J_f, 8).permute(2, 3, 0, 1).reshape(J_f, 8, n),
                       z_f.new_zeros((J_f, 8, 256))], dim=2).contiguous()
    vr = view_bias(pw, rd).to(torch.bfloat16).contiguous()
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    for act in ("relu", "softplus"):
        got = pair_sigma_kernel(pw, ro, rd, z_c, t_c, j_c, act)
        torch.cuda.synchronize()
        ref = pair_sigma_eval_reference(pw, ro, rd, z_c, t_c, j_c, act)
        listed = _listed_mask(J_c, T, t_c, j_c, "cuda")
        _check_sigma_buf(f"pair_sigma vs plain, {act}, {t_c.numel()} pairs", got[listed],
                         ref[listed])
        got = pair_field_perz_kernel(pw, ro, rd, vr, z_buf, t_f, j_f, act)
        torch.cuda.synchronize()
        ref = pair_field_eval_perz_reference(pw, ro, rd, vr, z_buf, t_f, j_f, act)
        _check_buffers(f"pair_field_perz vs plain, {act}, {t_f.numel()} pairs", got, ref,
                       _listed_mask(J_f, T, t_f, j_f, "cuda"))
    before = (pair_sigma_kernel.launches, pair_field_perz_kernel.launches)
    zero_c = pair_sigma_eval(pw, ro, rd, z_c, empty, empty)
    zero_f = pair_field_eval_perz(pw, ro, rd, z_buf, empty, empty)
    if ((pair_sigma_kernel.launches, pair_field_perz_kernel.launches) != before
            or bool(zero_c.any()) or any(bool(b.float().any()) for b in zero_f)):
        _fail("pair_sigma / pair_field_perz with no pairs: a launch or non-zero buffers")
    print("[hier pair kernels, no pairs] zero buffers, no launch", flush=True)

    # cross-check: pair_sigma with every pair listed = sigma_head with every
    # flag set, bit for bit (the same walk, wg_sigma_walk, on the same rows)
    t_all = torch.arange(T, device="cuda").repeat_interleave(J_c).to(torch.int32)
    j_all = torch.arange(J_c, device="cuda").repeat(T).to(torch.int32)
    buf = pair_sigma_kernel(pw, ro, rd, z_c, t_all, j_all, "relu")
    dense = sig_all["relu"].t().reshape(J_c, 8, n)
    same = torch.equal(buf[:, :, :n], dense)
    print(f"[hier cross-check] pair_sigma (all {T * J_c} pairs) vs sigma_head: "
          f"{'equal bit for bit' if same else 'DIFFERENT'}, max abs diff "
          f"{float((buf[:, :, :n] - dense).abs().max()):.3e}", flush=True)
    if not same:
        _fail("pair_sigma with every pair listed is not sigma_head's values bit for bit")

    # cross-check: pair_field_perz with every pair listed, composited by
    # deferred_composite_head, against render_head (ert_eps 0) on the same
    # per-ray depths. The pair path stores colours in bf16; its effect on
    # the composite is measured here with the plain versions of both paths
    # and added to the head bar.
    t_all = torch.arange(T, device="cuda").repeat_interleave(J_f).to(torch.int32)
    j_all = torch.arange(J_f, device="cuda").repeat(T).to(torch.int32)
    ops = prepare_head_operands(pw, ro, rd, z_f, bc, 1e10, 0.0, None, "softplus")
    head_d, _ = render_head_kernel(ops)
    dists = ops.dists.clone()
    dists[-1] = 0.0  # the catch-all: deferred_composite_head closes with the background
    occ_all = torch.ones((T, J_f), dtype=torch.int32, device="cuda")
    bufs = pair_field_perz_kernel(pw, ro, rd, vr, z_buf, t_all, j_all, "softplus")
    head_p = deferred_composite_head(bufs, occ_all, dists, bc)
    bufs_r = pair_field_eval_perz_reference(pw, ro, rd, vr, z_buf, t_all, j_all, "softplus")
    head_dr, _ = fused_render_head_reference(ops)
    effect = _errors(deferred_composite_head(bufs_r, occ_all, dists, bc), head_dr)
    torch.cuda.synchronize()
    print(f"[hier cross-check] bf16-colour effect, plain pair path vs plain dense path: max "
          f"{effect[0]:.3e} mean {effect[1]:.3e}", flush=True)
    _check_head(f"hier cross-check, pair_field_perz (all {T * J_f} pairs) + "
                f"deferred_composite_head vs render_head, ert_eps=0", head_p, head_d,
                TOL["head_max"] + effect[0], TOL["head_mean"] + effect[1])


def _hier_state(cfg):
    from dfanerf_torch.train.state import init_train_state

    state = init_train_state(cfg, seed=0, device="cuda")
    with torch.no_grad():
        state["params"].decoder.sigma_out.bias += HIER_SHIFT
    return state


def _hier_scene(cfg):
    """(scene, args): the synthetic scene and args(i), frame i's arguments to
    a hierarchical renderer, with the shifted seeded weights."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.data.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(n_frames=HIER_FRAMES, H=H, W=W, seed=0)
    state = _hier_state(cfg)
    params = state["params"]
    auds, exps, poses = (torch.from_numpy(x).cuda() for x in (scene.auds, scene.exps, scene.poses))
    bc_img = torch.from_numpy(scene.bc_img).cuda()

    def args(i):
        sig, _ = renderer.encode_frame_signals(params, auds, exps, poses, i, scene.n_frames, cfg,
                                               True)
        return params, state["z_shape"], state["z_app"], poses[i], sig, bc_img

    return scene, args


@contextlib.contextmanager
def _patched(**fns):
    """The renderer module's functions ``fns`` swapped in for the block."""
    import dfanerf_torch.render.renderer as renderer

    real = {name: getattr(renderer, name) for name in fns}
    for name, fn in fns.items():
        setattr(renderer, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(renderer, name, fn)


def _plain_hier_dense():
    """The dense hierarchical renderer's kernel calls as their plain versions."""
    from dfanerf_torch.ops.render_head import fused_render_head_reference, prepare_head_operands
    from dfanerf_torch.ops.sigma_head import fused_sigma_head_reference

    def sigma(pw, ro, rd, z, occupancy=None, act="relu"):
        occ = occupancy if occupancy is not None else torch.ones(
            (ro.shape[0] // 256, z.shape[0] // 8), dtype=torch.int32, device=ro.device)
        return fused_sigma_head_reference(pw, ro, rd, z, occ, act)

    def fine(pw, ro, rd, z, bc, last_dist=1e10, ert_eps=0.0, occupancy=None, act="relu"):
        ops = prepare_head_operands(pw, ro, rd, z, bc, last_dist, ert_eps, occupancy, act)
        return fused_render_head_reference(ops)[0][:ro.shape[0]]

    return _patched(fused_sigma_head=sigma, fused_render_head=fine)


def _plain_hier_pairs():
    """The pair hierarchical renderer's kernel calls as their plain versions."""
    from dfanerf_torch.ops.fused_render import view_bias
    from dfanerf_torch.ops.pair_hier import (
        pair_field_eval_perz, pair_field_eval_perz_reference, pair_sigma_eval,
        pair_sigma_eval_reference,
    )

    def sigma(pw, ro, rd, z, t_idx, j_idx, act="relu"):
        if t_idx.numel() == 0:
            return pair_sigma_eval(pw, ro, rd, z, t_idx, j_idx, act)
        return pair_sigma_eval_reference(pw, ro, rd, z, t_idx, j_idx, act)

    def fine(pw, ro, rd, z_buf, t_idx, j_idx, act="relu"):
        if t_idx.numel() == 0:
            return pair_field_eval_perz(pw, ro, rd, z_buf, t_idx, j_idx, act)
        vr = view_bias(pw, rd).to(torch.bfloat16).contiguous()
        return pair_field_eval_perz_reference(pw, ro, rd, vr, z_buf, t_idx, j_idx, act)

    return _patched(pair_sigma_eval=sigma, pair_field_eval_perz=fine)


def _timed(fn, *a):
    """(fn(*a), its time in ms by CUDA events)."""
    return _cuda_call(lambda: fn(*a))


def _stage_line(tag, times):
    return f"[{tag}] stages: " + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())


def phase_hier_dense_main_path():
    """Config 2 no-skip at full width through the entry points: 5 frames;
    one frame against the plain versions; launches, times and stages."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.fused_render import field_flops_per_sample
    from dfanerf_torch.ops.render_head import (
        fused_render_head_reference, prepare_head_operands, render_head_kernel,
    )
    from dfanerf_torch.ops.sigma_head import fused_sigma_head_reference, sigma_head_kernel

    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**HIER_NOSKIP))
    rcfg = cfg.render
    scene, args = _hier_scene(cfg)
    render = renderer.make_head_hierarchical_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    render(*args(0))  # warm-up
    torch.cuda.synchronize()
    kernels = {"sigma_head": sigma_head_kernel, "render_head": render_head_kernel}
    for k in kernels.values():
        k.launches = 0
    frames = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(N_FRAMES):
        frames.append(render(*args(i)))
    end.record()
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    ms_frame = start.elapsed_time(end) / N_FRAMES
    print(f"[hier dense] {N_FRAMES} frames {H}x{W}, {rcfg.n_samples} + {rcfg.n_importance} "
          f"samples, no-skip: {ms_frame:.2f} ms per frame (CUDA events, warm); launches "
          f"{launches}", flush=True)
    if launches != {"sigma_head": N_FRAMES, "render_head": N_FRAMES}:
        _fail(f"hier dense: launches {launches} for {N_FRAMES} frames, expected one each per frame")
    for i, img in enumerate(frames):
        _check_image(f"hier dense frame {i}", img)
    print(f"[hier dense] frames finite, in [0, 1]; frame 0 mean {float(frames[0].mean()):.4f}",
          flush=True)
    with _plain_hier_dense():
        ref = render(*args(0))
    torch.cuda.synchronize()
    frame_err = _check_head("hier dense frame 0, kernels vs plain", frames[0], ref)

    # the stages and both kernels on frame 0's operands
    st = render.stages
    times = {}
    (pw, ro, rd, bc), times["prep"] = _timed(st["prep"], *args(0))
    (occ_c, sat), times["coarse flags"] = _timed(st["coarse_flags"], pw, ro, rd)
    sigma_c, times["coarse kernel"] = _timed(st["sigma"], pw, ro, rd, occ_c)
    (z_fine, occ_f), times["resample"] = _timed(st["resample"], pw, ro, rd, sigma_c, sat)
    rgb, times["fine kernel"] = _timed(st["fine"], pw, ro, rd, z_fine, bc, occ_f)
    _, times["finish"] = _timed(st["finish"], rgb)
    print(_stage_line("hier dense frame 0", times), flush=True)

    n, S_c = ro.shape[0], rcfg.n_samples
    T = n // 256
    z_c = linspace(scene.near, scene.far, S_c, device="cuda")
    occ = torch.ones((T, S_c // 8), dtype=torch.int32, device="cuda")
    ms_a = _cuda_ms(lambda: sigma_head_kernel(pw, ro, rd, z_c, occ, "softplus"), 3)
    ref_a, plain_a = _cuda_call(lambda: fused_sigma_head_reference(pw, ro, rd, z_c, occ,
                                                                   "softplus"))
    err_a = _check_sigma_buf("hier dense, sigma_head vs plain", sigma_head_kernel(
        pw, ro, rd, z_c, occ, "softplus"), ref_a)
    ops = prepare_head_operands(pw, ro, rd, z_fine, bc, rcfg.last_dist, rcfg.ert_eps, None,
                                "softplus")
    got_b, slabs = render_head_kernel(ops)
    ms_b = _cuda_ms(lambda: render_head_kernel(ops), 3)
    (ref_b, _), plain_b = _cuda_call(lambda: fused_render_head_reference(ops))
    err_b = _check_head("hier dense, render_head vs plain", got_b, ref_b)
    w_bytes = sum(t.numel() * t.element_size() for k, t in pw.items()
                  if k not in ("w_view", "b_view"))
    S_f = z_fine.shape[1]
    flops_a = float(occ.sum()) * 8 * 256 * field_flops_per_sample("head", color=False)
    bytes_a = 2 * n * 3 * 4 + S_c * 4 + occ.numel() * 4 + w_bytes + n * S_c * 4
    flops_b = float(slabs.sum()) * 8 * 256 * field_flops_per_sample("head")
    bytes_b = (2 * n * 3 * 4 + 2 * S_f * n * 4 + n * 256 * 2 + n * 3 * 4 + T * (S_f // 8) * 4
               + w_bytes + n * 3 * 4 + T * 4)
    for name, ms, plain, flops, nb in (("sigma_head", ms_a, plain_a, flops_a, bytes_a),
                                       ("render_head", ms_b, plain_b, flops_b, bytes_b)):
        print(f"[hier dense] {name} {ms:.3f} ms per launch; plain {plain:.1f} ms; "
              f"{flops / 1e12:.2f} TFLOP at live widths -> {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms "
              f"at bf16 peak ({flops / ms / 1e9:.1f} TFLOP/s achieved); {nb / 1e6:.1f} MB",
              flush=True)
    print(f"[hier dense] render_head slabs run {int(slabs.sum())} of {T * (S_f // 8)}; L2 weight "
          f"rate {_l2_rate(('head',), float(slabs.sum()) * 16, ms_b):.3f} TB/s, sigma_head "
          f"{_l2_rate(('head',), float(occ.sum()) * 16, ms_a, color=False):.3f} TB/s; frame-level "
          f"error vs plain {frame_err:.3e}; library_ms is null for sigma_head and render_head: no "
          f"single PyTorch call computes a packed NeRF field", flush=True)
    entries = [_entry("sigma_head", "sigma_head.cu", "dfanerf_tpu/ops/fused_render.py:837",
                      launches["sigma_head"], err_a, ms_a, plain_a, flops_a, bytes_a),
               _entry("render_head", "render_head.cu", "dfanerf_tpu/ops/fused_render.py:1954",
                      launches["render_head"], err_b, ms_b, plain_b, flops_b, bytes_b)]
    return entries, frames


def _check_hier_flags(tag, args, kw, result):
    """One refresh's coarse head flags (the node-grid kernel's nodes) against
    the flags of the same inputs through the plain grid with widened float32
    products (see NODE_TOL)."""
    from unittest import mock

    from dfanerf_torch.ops import fused_render, occupancy

    if torch.backends.cuda.matmul.allow_tf32:
        _fail("TF32 float32 products are on: the widened flags need exact float32 products")
    pw, branch, ro, rd, z, thresh = args
    flags, (sat, lo, span) = result
    grid_res, act = kw["grid_res"], kw["act"]
    thr = thresh * 0.25
    sig = occupancy.node_density(pw, branch, lo, span, grid_res, act)
    with mock.patch.object(occupancy, "_mm_cast", fused_render._mm_widened):
        sig_w = occupancy.node_density_reference(pw, branch, lo, span, grid_res, act)
    on, on_w = sig > thr, sig_w > thr
    flipped = on != on_w
    n_far = int((flipped & ((sig_w - thr).abs() > NODE_TOL)).sum())

    def flags_of(nodes):
        return occupancy.occupancy_flags_and_sat(pw, branch, ro, rd, z, thresh, grid_res,
                                                 (occupancy._occupancy_sat(nodes), lo, span),
                                                 act)[0]

    wide = flags_of(on_w).bool()
    ship = flags.bool()
    print(f"[{tag}] {int((ship != wide).sum())} of {ship.numel()} flags differ; "
          f"{int(flipped.sum())} of {on.numel()} nodes on the other side of {thr}, {n_far} of them "
          f"farther than {NODE_TOL:.0e} from it; node density max diff "
          f"{float((sig - sig_w).abs().max()):.3e}", flush=True)
    if not torch.equal(ship, flags_of(on).bool()):
        _fail(f"{tag}: the shipped flags are not those of their nodes")
    if n_far:
        _fail(f"{tag}: {n_far} nodes flip farther than {NODE_TOL:.0e} from the threshold")


def phase_hier_pair_main_path(noskip_frames):
    """Config 2's serving recipe at full width through the entry points: 12
    frames over three refreshes; flags, lists, launches, host syncs, one
    refresh frame and one steady frame against the plain versions; times."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.ops.fused_render import field_flops_per_sample, view_bias
    from dfanerf_torch.ops.occupancy import node_grid_kernel
    from dfanerf_torch.ops.pair_hier import (
        pair_field_eval_perz_reference, pair_field_perz_kernel, pair_sigma_eval_reference,
        pair_sigma_kernel,
    )

    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**HIER_PAIRS))
    rcfg = cfg.render
    scene, args = _hier_scene(cfg)
    warm = renderer.make_head_hierarchical_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    warm(*args(0))
    warm(*args(1))
    torch.cuda.synchronize()

    render = renderer.make_head_hierarchical_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    kernels = {"pair_sigma": pair_sigma_kernel, "pair_field_perz": pair_field_perz_kernel,
               "node_grid": node_grid_kernel}
    for k in kernels.values():
        k.launches = 0
    frames, marks, refreshes, flag_runs, syncs = [], [], [], [], 0
    with _spy("occupancy_flags_and_sat", flag_runs):
        for i in range(HIER_FRAMES):
            a = args(i)
            c = render.cache
            steady = "empty" in c and c["age"] < rcfg.occ_refresh_every
            before = {name: k.launches for name, k in kernels.items()}
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if steady:
                    torch.cuda.set_sync_debug_mode("warn")
                e0.record()
                frames.append(render(*a))
                e1.record()
                torch.cuda.set_sync_debug_mode("default")
            syncs += sum("synchroniz" in str(w.message) for w in caught) if steady else 0
            marks.append((steady, e0, e1, {n: k.launches - before[n] for n, k in kernels.items()}))
            if not steady:
                if c["empty"]:
                    _fail(f"hier pair refresh at frame {i} found no occupied tile")
                refreshes.append((i, c["ti_c"].numel(), c["ti_f"].numel(), len(c["tiles_u"]),
                                  [x.clone() for x in (c["ti_c"], c["ji_c"], c["ti_f"],
                                                       c["ji_f"])]))
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    steady_ms = [e0.elapsed_time(e1) for st, e0, e1, _ in marks if st]
    refresh_ms = [e0.elapsed_time(e1) for st, e0, e1, _ in marks if not st]
    T = (-(-H // 16)) ** 2
    J_c, J_f = rcfg.n_samples // 8, (rcfg.n_samples + rcfg.n_importance) // 8
    for i, k_c, k_f, k_u, _ in refreshes:
        print(f"[hier pair] refresh at frame {i}: K_c {k_c} ({k_c / (T * J_c):.1%} of {T * J_c}), "
              f"K_f {k_f} ({k_f / (T * J_f):.1%} of {T * J_f}); {k_u} of {T} tiles in the union",
              flush=True)
        for name, k, total in (("coarse", k_c, T * J_c), ("fine", k_f, T * J_f)):
            if not PAIR_FRACTION[0] <= k / total <= PAIR_FRACTION[1]:
                _fail(f"hier pair: {name} lists {k} of {total} pairs at frame {i}, outside "
                      f"{PAIR_FRACTION[0]:.0%}-{PAIR_FRACTION[1]:.0%}")
    window = (sum(refresh_ms) / len(refresh_ms)
              + (rcfg.occ_refresh_every - 1) * sum(steady_ms) / len(steady_ms)) / rcfg.occ_refresh_every
    print(f"[hier pair] {HIER_FRAMES} frames {H}x{W}, {rcfg.n_samples} + {rcfg.n_importance} "
          f"samples: {sum(steady_ms) / len(steady_ms):.2f} ms per steady frame ({len(steady_ms)} "
          f"frames), {sum(refresh_ms) / len(refresh_ms):.2f} ms per refresh frame "
          f"({len(refresh_ms)} frames), {window:.2f} ms per frame over a refresh window (CUDA "
          f"events, warm); launches {launches}; host syncs in steady frames {syncs}", flush=True)
    if len(refresh_ms) != 3:
        _fail(f"{len(refresh_ms)} refresh frames in {HIER_FRAMES}, expected 3")
    for i, (st, _, _, got) in enumerate(marks):
        if st and got != {"pair_sigma": 1, "pair_field_perz": 1, "node_grid": 0}:
            _fail(f"hier pair steady frame {i} launched {got}")
        if not st and got["node_grid"] != 1:
            _fail(f"hier pair refresh frame {i} launched {got}: one node grid, the head's")
    if syncs:
        _fail(f"{syncs} host synchronizations in the hier pair steady frames")
    for i, img in enumerate(frames):
        _check_image(f"hier pair frame {i}", img)
    errs = [float((frames[i] - noskip_frames[i]).abs().max()) for i in range(len(noskip_frames))]
    print(f"[hier pair] frames finite, in [0, 1]; max error against the no-skip frames 0-"
          f"{len(noskip_frames) - 1} (same weights and poses; random weights set no bar): "
          f"{max(errs):.4e} ({', '.join(f'{e:.2e}' for e in errs)})", flush=True)
    coarse_runs = [r for r in flag_runs if r[1].get("sat_cache") is None]
    for (i, *_), (occ_args, occ_kw, result) in zip(refreshes, coarse_runs, strict=True):
        _check_hier_flags(f"hier pair refresh frame {i}, coarse flags vs widened float32",
                          occ_args, occ_kw, result)

    # a refresh frame (0; a fresh renderer with the plain versions, whose
    # lists must equal the kernels') and a steady frame (the last, under the
    # kernels' lists) against the plain versions
    with _plain_hier_pairs():
        plain = renderer.make_head_hierarchical_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
        ref = plain(*args(0))
        torch.cuda.synchronize()
        pc = plain.cache
        same = all(torch.equal(a, b) for a, b in zip(
            (pc["ti_c"], pc["ji_c"], pc["ti_f"], pc["ji_f"]), refreshes[0][4]))
        print(f"[hier pair] refresh frame 0 with the plain versions: pair lists "
              f"{'equal to' if same else 'DIFFER from'} the kernels'", flush=True)
        if not same:
            _fail("hier pair: the plain versions' refresh lists differ from the kernels'")
        err = _check_head("hier pair refresh frame 0, kernels vs plain", frames[0], ref)
        last = args(HIER_FRAMES - 1)
        ref = render.run_fast(*last)
        torch.cuda.synchronize()
        err = max(err, _check_head(f"hier pair steady frame {HIER_FRAMES - 1}, kernels vs plain",
                                   frames[-1], ref))

    # stages and kernels on the last steady frame's operands
    st, c = render.stages, render.cache
    times = {}
    (pw, ro, rd, bc_p), times["prep"] = _timed(st["prep"], *last)
    sel = c["tiles_sel"]
    (ro_g, rd_g, bc_g), times["gather"] = _timed(
        lambda: tuple(st["gather"](x, sel) for x in (ro, rd, bc_p)))
    sig_buf, times["coarse pair kernel"] = _timed(st["sigma"], pw, ro_g, rd_g)
    (z_buf, dists, occ_f), times["resample"] = _timed(st["resample"], pw, ro_g, rd_g, sig_buf)
    bufs, times["fine pair kernel"] = _timed(st["fine"], pw, ro_g, rd_g, z_buf)
    _, times["finish"] = _timed(st["finish"], bufs, occ_f, dists, bc_g, bc_p)
    k_u = len(c["tiles_u"])
    ti_c, ji_c, ti_f, ji_f = c["ti_c"], c["ji_c"], c["ti_f"], c["ji_f"]
    # a refresh on the same operands (it replaces the lists in the cache)
    _, times["coarse flags + SAT"] = _timed(st["coarse_flags"], pw, ro, rd)
    _, times["whole refresh (coarse flags + SAT, 2 host copies, lists, coarse pass, resample)"] = (
        _timed(st["refresh"], pw, ro, rd, bc_p))
    print(_stage_line(f"hier pair steady frame {HIER_FRAMES - 1}", times), flush=True)

    n_u = k_u * 256
    z_c = linspace(scene.near, scene.far, rcfg.n_samples, device="cuda")
    vr = view_bias(pw, rd_g).to(torch.bfloat16).contiguous()
    w_bytes = sum(t.numel() * t.element_size() for k, t in pw.items()
                  if k not in ("w_view", "b_view"))
    K_c, K_f = ti_c.numel(), ti_f.numel()
    got_c = pair_sigma_kernel(pw, ro_g, rd_g, z_c, ti_c, ji_c, "softplus")
    ms_c = _cuda_ms(lambda: pair_sigma_kernel(pw, ro_g, rd_g, z_c, ti_c, ji_c, "softplus"), 3)
    ref_c, plain_c = _cuda_call(lambda: pair_sigma_eval_reference(pw, ro_g, rd_g, z_c, ti_c, ji_c,
                                                                  "softplus"))
    listed = _listed_mask(J_c, k_u, ti_c, ji_c, "cuda")
    err_c = _check_sigma_buf("hier pair, pair_sigma vs plain", got_c[listed], ref_c[listed])
    got_f = pair_field_perz_kernel(pw, ro_g, rd_g, vr, z_buf, ti_f, ji_f, "softplus")
    ms_f = _cuda_ms(lambda: pair_field_perz_kernel(pw, ro_g, rd_g, vr, z_buf, ti_f, ji_f,
                                                   "softplus"), 3)
    ref_f, plain_f = _cuda_call(lambda: pair_field_eval_perz_reference(pw, ro_g, rd_g, vr, z_buf,
                                                                       ti_f, ji_f, "softplus"))
    err_f = _check_buffers("hier pair, pair_field_perz vs plain", got_f, ref_f,
                           _listed_mask(J_f, k_u, ti_f, ji_f, "cuda"))
    flops_c = K_c * 8 * 256 * field_flops_per_sample("head", color=False)
    bytes_c = 2 * n_u * 3 * 4 + rcfg.n_samples * 4 + 2 * K_c * 4 + w_bytes + K_c * 8 * 256 * 4
    flops_f = K_f * 8 * 256 * field_flops_per_sample("head")
    bytes_f = (2 * n_u * 3 * 4 + K_f * 8 * 256 * 4 + n_u * 256 * 2 + 2 * K_f * 4 + w_bytes
               + K_f * 8 * 256 * (4 + 3 * 2))
    for name, K, ms, plain_ms, flops, nb in (
            ("pair_sigma", K_c, ms_c, plain_c, flops_c, bytes_c),
            ("pair_field_perz", K_f, ms_f, plain_f, flops_f, bytes_f)):
        print(f"[hier pair] {name}: {K} pairs, {ms:.3f} ms per launch; plain {plain_ms:.1f} ms; "
              f"{flops / 1e12:.3f} TFLOP at live widths -> {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at "
              f"bf16 peak ({flops / ms / 1e9:.1f} TFLOP/s achieved); {nb / 1e6:.1f} MB", flush=True)
    print(f"[hier pair] L2 weight rate: pair_field_perz {_l2_rate(('head',), K_f * 16, ms_f):.3f} "
          f"TB/s, pair_sigma {_l2_rate(('head',), K_c * 16, ms_c, color=False):.3f} TB/s; "
          f"frame-level error vs plain {err:.3e}; library_ms is null for pair_sigma "
          f"and pair_field_perz: no single PyTorch call computes a packed NeRF field on listed "
          f"(tile, slab) pairs", flush=True)
    return [_entry("pair_sigma", "pair_hier.cu", "dfanerf_tpu/ops/fused_render.py:2165",
                   launches["pair_sigma"], err_c, ms_c, plain_c, flops_c, bytes_c),
            _entry("pair_field_perz", "pair_perz.cu", "dfanerf_tpu/ops/fused_render.py:2256",
                   launches["pair_field_perz"], err_f, ms_f, plain_f, flops_f, bytes_f)]


# The shipped serving configuration: the render section of
# configs/obama_serve_tpu.json (occupancy threshold 0.5 on a grid of 48,
# per-field tile classes, refresh every 4 frames, ERT 1e-4, 64 samples, bf16)
# with its decoder (the default: hidden 256, 8 blocks, deformation field,
# relu density). The tile-class branch renders SERVE_FRAMES frames
# (refreshes at 0, 4 and 8), the plain occupancy branch (tile compaction
# off) SERVE_PLAIN_FRAMES (refreshes at 0 and 4), and the tile-class branch
# with the epilogue's kernel form (bg_epilogue_fused, far_joint)
# SERVE_EPILOGUE_FRAMES.
SERVE_CONFIG = "configs/obama_serve_tpu.json"
SERVE_FRAMES = 12
SERVE_PLAIN_FRAMES = 6
SERVE_EPILOGUE_FRAMES = 4
# Added to the seeded sigma_out bias, as SIGMA_SHIFT above, with the head's
# shape latent z_shape[0] scaled by SERVE_HEAD_LATENT: relu of the
# random-init densities lies below the node threshold 0.5 / 4 = 0.125
# everywhere, and the flags go from none at a shift of +0.06 to all at
# +0.12 (frames 0, 4 and 8). At +0.08 only the torso flags slabs; the
# latent scale lifts the head's densities, so that every class is
# non-empty: (both, head, torso, none) = (181, 366, 85, 209), (51, 349, 54,
# 387) and (505, 125, 150, 61) of 841 tiles at frames 0, 4 and 8 (a search
# over the shift and the scale on an H100; the main path prints the classes
# of each refresh).
SERVE_SHIFT = 0.08
SERVE_HEAD_LATENT = 3.0
# The kernel checks' saturating field: relu densities of ~30 end every ray's
# transmittance below ert_eps = 1e-4 after about 4 of the 8 slabs.
SATURATE_SHIFT = 30.0
CLASS_VARIANTS = ("render_rays_epilogue", "render_rays_head", "render_rays_torso")


def _serve_cfg(tile_compaction: bool = True):
    from dfanerf_torch.config import ExperimentConfig

    cfg = ExperimentConfig.from_json(os.path.join(HERE, SERVE_CONFIG))
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, occ_tile_compaction=tile_compaction))


def _class_sizes(occ):
    """(both, head-only, torso-only, none) tile counts of per-field flags
    [2, T, J]."""
    th, tt = occ[0].amax(dim=1) > 0, occ[1].amax(dim=1) > 0
    return tuple(int(x.sum()) for x in (th & tt, th & ~tt, tt & ~th, ~th & ~tt))


def _check_epilogue(tag, got, ref, occ):
    """render_rays in epilogue mode vs its plain version: the sums (TOL's
    head bars; no background blend is in them), the transmittances (the
    head's max bar), the slab counts (equal), and the tiles without a flag
    (exactly acc 0 and t 1). Returns the largest error."""
    acc_h, acc_c, slabs, t_h, t_c = got
    r_h, r_c, slabs_r, rt_h, rt_c = ref
    errs = [_errors(a, b) for a, b in ((acc_h, r_h), (acc_c, r_c), (t_h, rt_h), (t_c, rt_c))]
    empty = (occ.amax(dim=1) == 0).repeat_interleave(256)
    n_bad = int((acc_h[empty] != 0).sum() + (acc_c[empty] != 0).sum() + (t_h[empty] != 1).sum()
                + (t_c[empty] != 1).sum())
    same = torch.equal(slabs, slabs_r)
    print(f"[{tag}] sums head max {errs[0][0]:.3e} mean {errs[0][1]:.3e}, com max {errs[1][0]:.3e} "
          f"mean {errs[1][1]:.3e} (tol {TOL['head_max']:.0e}/{TOL['head_mean']:.0e}); t head max "
          f"{errs[2][0]:.3e}, com max {errs[3][0]:.3e} (tol {TOL['head_max']:.0e}); slabs run "
          f"{int(slabs.sum())} of {occ.numel()}, {'equal' if same else 'DIFFERENT'}; "
          f"{int(empty.sum()) // 256} tiles without a flag, {n_bad} values there not exactly "
          f"acc 0 / t 1", flush=True)
    if not all(torch.isfinite(x).all() for x in got if x.is_floating_point()):
        _fail(f"{tag}: non-finite output")
    if (any(m > TOL["head_max"] for m, _ in errs) or any(a > TOL["head_mean"] for _, a in errs[:2])
            or not same or n_bad):
        _fail(f"{tag}: kernel disagrees with its plain version")
    return max(m for m, _ in errs)


def phase_serve_kernels_vs_plain():
    """The six render_rays instantiations and far_joint against their plain
    versions on the card, at a 450x450 frame's rays (frame 0 of the serving
    path, with its seeded weights) and 64 samples: flags with gaps and tiles
    without a flag, and a saturating field whose rays terminate early (ERT;
    not for the torso only with the background in the kernel, whose head
    stack stays near 1 without the head field, so its rays never end early).
    far_joint also against far_head + far_torso on the same rays (bit for
    bit), there and at FAR_COUNTS rays, under relu and softplus. Returns
    each kernel's largest error."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.ops.far_eval import (
        far_eval_reference, far_head_kernel, far_joint_kernel, far_torso_kernel,
    )
    from dfanerf_torch.ops.fused_render import (
        RENDER_VARIANTS, fused_render_rays_reference, prepare_render_operands, render_rays_kernel,
        view_bias,
    )

    cfg = _serve_cfg()
    rcfg = cfg.render
    inputs = {}
    for tag, shift in (("seeded", SERVE_SHIFT), ("saturating", SERVE_SHIFT + SATURATE_SHIFT)):
        scene, args = _pair_scene(cfg, shift, 1, SERVE_HEAD_LATENT)
        render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
        inputs[tag] = render.inputs_fn(*args(0))
    pw_h, pw_t, ro, rd, ro_t, rd_t, bc = inputs["seeded"]
    T, J = ro.shape[0] // 256, rcfg.n_samples // 8
    z = linspace(scene.near, scene.far, rcfg.n_samples, device="cuda")
    g = torch.Generator().manual_seed(4)
    flags = (torch.rand((2, T, J), generator=g) < 0.5).to(torch.int32)
    flags[:, ::5] = 0
    flags = flags.cuda()
    print(f"[serve kernels vs plain] {T} tiles x {J} slabs; flags head {int(flags[0].sum())}, "
          f"torso {int(flags[1].sum())}, joint {int(flags.amax(dim=0).sum())} of {T * J}; every "
          f"5th tile without a flag; ert_eps {rcfg.ert_eps}", flush=True)
    cases = (("flags with gaps", inputs["seeded"][:2], flags),
             (f"saturating field (bias +{SATURATE_SHIFT:g}), every flag", inputs["saturating"][:2],
              None))
    worst = {}
    for (fields, epilogue), name in RENDER_VARIANTS.items():
        for tag, (ph, pt), occ in (cases[:1] if name == "render_rays_torso_bg" else cases):
            ops = prepare_render_operands(ph, pt, ro, rd, ro_t, rd_t, z, bc, rcfg.last_dist,
                                          rcfg.ert_eps, occ, "relu", epilogue, fields)
            got = render_rays_kernel(ops)
            torch.cuda.synchronize()
            ref = fused_render_rays_reference(ops)
            torch.cuda.synchronize()
            tag = f"{name} vs plain, {tag}"
            if epilogue:
                err = _check_epilogue(tag, got, ref, ops.occ)
            else:
                far = (ref[4], _far_torso_delta(ops, ro.shape[0])) if fields == "torso" else None
                err = _check_pair(tag, got[0], got[1], ref[0], ref[1], ref[3], far)
                if not torch.equal(got[2], ref[2]):
                    _fail(f"{tag}: slab counts differ from the plain version's")
                print(f"[{tag}] slabs run {int(got[2].sum())} of {T * J}, equal", flush=True)
            worst[name] = max(worst.get(name, 0.0), err)

    far = float(z[-1])
    vr_t = view_bias(pw_t, rd_t).to(torch.bfloat16).contiguous()
    far_err = 0.0
    far_cases = [(n, act) for n in FAR_COUNTS + (ro.shape[0],) for act in ("relu", "softplus")]
    for n, act in far_cases:
        rays = [x[:n] for x in (ro, rd, ro_t, rd_t)]
        sh, ct = far_joint_kernel(pw_h, pw_t, *rays, far, vr_t[:n], act)
        sh_s = far_head_kernel(pw_h, rays[0], rays[1], far, act=act)
        ct_s = far_torso_kernel(pw_t, rays[2], rays[3], far, vr_t[:n], act=act)
        torch.cuda.synchronize()
        sh_r, ct_r = far_eval_reference(pw_h, pw_t, *rays, far, vr_t[:n], act)
        far_err = max(far_err, *_check_far(f"far_joint vs plain, {n} rays, {act}", sh, ct, sh_r,
                                           ct_r))
        same = torch.equal(sh, sh_s) and torch.equal(ct, ct_s)
        print(f"[far_joint vs far_head + far_torso, {n} rays, {act}] "
              f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            _fail("far_joint differs from far_head + far_torso on the same rays")
    worst["far_joint"] = far_err
    return worst


@contextlib.contextmanager
def _plain_render_kernel():
    """fused_render_rays with its CUDA kernel swapped for the plain version
    on the card (the wrapper's own epilogue and padding stay as shipped)."""
    from dfanerf_torch.ops import fused_render

    real = fused_render.render_rays_kernel
    fused_render.render_rays_kernel = fused_render.fused_render_rays_reference
    try:
        yield
    finally:
        fused_render.render_rays_kernel = real


def _far_sh(render, a, z_vals):
    """The head's far-plane density sh per pixel [H, W] of frame args a,
    as the background epilogue computes it (for _check_pair)."""
    from dfanerf_torch.ops.fused_render import density_act, spatial_untile
    from dfanerf_torch.ops.occupancy import packed_sigma_xla

    pw_h, _, ro, rd, *_ = render.inputs_fn(*a)
    sh = density_act(packed_sigma_xla(pw_h, ro + rd * z_vals[-1], "head", pw_h["w_blocks"].dtype))
    return spatial_untile(sh[:, None], H, W)[..., 0]


def _run_frames(render, args, n_frames, kernels, is_steady, on_refresh=None):
    """Render frames 0 .. n_frames - 1, each between CUDA events, with host
    syncs counted in the steady frames (is_steady(cache) before the frame).
    kernels: name -> (binding, variant or None), launches counted per frame.
    Returns frames, [(steady, ms, launches)], syncs."""
    frames, marks, syncs = [], [], 0

    def counts():
        return {name: (k.launches if v is None else k.variant_launches.get(v, 0))
                for name, (k, v) in kernels.items()}

    for i in range(n_frames):
        a = args(i)
        steady = is_steady(render.cache)
        before = counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if steady:
                torch.cuda.set_sync_debug_mode("warn")
            e0.record()
            frames.append(render(*a))
            e1.record()
            torch.cuda.set_sync_debug_mode("default")
        syncs += sum("synchroniz" in str(w.message) for w in caught) if steady else 0
        after = counts()
        marks.append((steady, e0, e1, {n: after[n] - before[n] for n in after if after[n] - before[n]}))
        if not steady and on_refresh is not None:
            on_refresh(i)
    torch.cuda.synchronize()
    return frames, [(st, e0.elapsed_time(e1), got) for st, e0, e1, got in marks], syncs


def _frame_times(tag, marks, every):
    steady = [ms for st, ms, _ in marks if st]
    refresh = [ms for st, ms, _ in marks if not st]
    s_ms, r_ms = sum(steady) / len(steady), sum(refresh) / len(refresh)
    window = (r_ms + (every - 1) * s_ms) / every
    print(f"[{tag}] {len(marks)} frames {H}x{W}, {N_SAMPLES} samples: {s_ms:.2f} ms per steady "
          f"frame ({len(steady)} frames), {r_ms:.2f} ms per refresh frame ({len(refresh)} "
          f"frames), {window:.2f} ms per frame over a refresh window of {every} (CUDA events, "
          f"warm); per frame {', '.join(f'{ms:.2f}' for _, ms, _ in marks)}", flush=True)
    return s_ms, r_ms, window


def _noskip_errors(tag, frames, noskip):
    """Each frame's max and mean error against the dense no-skip frame of
    the same weights and pose: printed, not held (random weights set no
    bar)."""
    errs = [_errors(f[1], d[1]) for f, d in zip(frames, noskip)]
    print(f"[{tag}] composite vs the dense no-skip frames (random weights set no bar): max "
          f"{max(e[0] for e in errs):.4e}, mean {max(e[1] for e in errs):.4e} (frames "
          f"{', '.join(f'{m:.2e}/{a:.1e}' for m, a in errs)})", flush=True)


def _serve_noskip_frames(cfg, args, n_frames):
    """The dense no-skip render (occupancy off, ERT off) of frames 0 ..
    n_frames - 1 with the same weights, for the printed error."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.data.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(n_frames=1, H=H, W=W, seed=0)
    dense = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, occ_sigma_thresh=0.0, ert_eps=0.0))
    render = renderer.make_frame_renderer(dense, scene.hwfcxy, scene.near, scene.far)
    return [render(*args(i)) for i in range(n_frames)]


def phase_serve_main_path():
    """The shipped serving config at full width through the entry points,
    on its tile-class branch: SERVE_FRAMES frames over three refreshes;
    class sizes, flags, launches per steady frame (one render_rays per
    non-empty segment), host syncs, a refresh and a steady frame against
    the plain versions; frame and stage times; each segment's kernel."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.ops.fused_render import (
        R_T, fused_render_rays_reference, prepare_render_operands, render_flops_per_sample,
        render_rays_kernel,
    )
    from dfanerf_torch.ops.occupancy import node_grid_kernel
    from dfanerf_torch.render.renderer import CLASS_FIELDS

    cfg = _serve_cfg()
    rcfg = cfg.render
    scene, args = _pair_scene(cfg, SERVE_SHIFT, SERVE_FRAMES, SERVE_HEAD_LATENT)
    warm = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    warm(*args(0))
    warm(*args(1))
    torch.cuda.synchronize()

    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    kernels = {name: (render_rays_kernel, name) for name in CLASS_VARIANTS}
    kernels["node_grid"] = (node_grid_kernel, None)
    render_rays_kernel.launches, render_rays_kernel.variant_launches = 0, {}
    refreshes, flag_runs = [], []

    def on_refresh(i):
        c = render.cache
        refreshes.append((i, c["ks"], c["order"].clone(), flag_runs[-1]))

    with _spy("conservative_occupancy", flag_runs):
        frames, marks, syncs = _run_frames(
            render, args, SERVE_FRAMES, kernels,
            lambda c: c["order"] is not None and c["age"] < rcfg.occ_refresh_every, on_refresh)
    launches = {name: render_rays_kernel.variant_launches.get(name, 0) for name in CLASS_VARIANTS}
    T = (-(-H // 16)) ** 2
    for i, ks, _, (_, _, occ) in refreshes:
        sizes = _class_sizes(occ)
        print(f"[serve tile classes] refresh at frame {i}: classes both / head / torso / none "
              f"{sizes} of {T} tiles; segments (bucketed) {ks}; flag density head "
              f"{float(occ[0].float().mean()):.3f}, torso {float(occ[1].float().mean()):.3f}",
              flush=True)
        if not (sizes[0] and (sizes[1] or sizes[2]) and sizes[3]):
            _fail(f"serve tile classes at frame {i}: both, a single-field class and none must "
                  f"be non-empty, got {sizes}")
    s_ms, r_ms, window = _frame_times("serve tile classes", marks, rcfg.occ_refresh_every)
    print(f"[serve tile classes] launches {launches}; host syncs in steady frames {syncs}",
          flush=True)
    if len(refreshes) != 3:
        _fail(f"{len(refreshes)} refresh frames in {SERVE_FRAMES}, expected 3")
    ks_of = {}
    for i, ks, _, _ in refreshes:
        for f in range(i, SERVE_FRAMES):
            ks_of[f] = ks
    for i, (st, _, got) in enumerate(marks):
        want = {CLASS_VARIANTS[c]: 1 for c in range(3) if ks_of[i][c]}
        if st and got != want:
            _fail(f"serve tile classes steady frame {i} launched {got}, expected {want}")
        if not st and got.get("node_grid") != 2:
            _fail(f"serve tile classes refresh frame {i} launched {got}: one node grid a field")
    if syncs:
        _fail(f"{syncs} host synchronizations in the serve tile-class steady frames")
    for i, (head, com) in enumerate(frames):
        _check_frame(f"serve tile classes frame {i}", head, com)
    for i, _, _, (occ_args, occ_kw, flags) in refreshes:
        _check_flags(f"serve tile classes refresh frame {i}, flags vs widened float32",
                     occ_args, occ_kw, flags)

    # a refresh frame (0, a fresh renderer whose classes must equal the
    # kernels') and a steady frame (the last, composed from the stages under
    # the kernels' classes) through the plain versions
    z_vals = linspace(scene.near, scene.far, rcfg.n_samples, device="cuda")
    st, c = render.stages, render.cache
    last = args(SERVE_FRAMES - 1)
    with _plain_render_kernel():
        plain = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
        head_r, com_r = plain(*args(0))
        same = (plain.cache["ks"] == refreshes[0][1]
                and torch.equal(plain.cache["order"], refreshes[0][2]))
        if not same:
            _fail("serve tile classes: the plain run's classes differ from the kernels'")
        err = _check_pair("serve tile classes refresh frame 0, kernels vs plain", frames[0][0],
                          frames[0][1], head_r, com_r, _far_sh(render, args(0), z_vals))
        pw_h, pw_t, *_ = inputs = render.inputs_fn(*last)
        rays = st["gather"](inputs)
        outs = [st["segment"](pw_h, pw_t, rays, ci) for ci in range(3) if c["ks"][ci]]
        head_r, com_r = (st["untile"](x) for x in st["finish"](pw_h, pw_t, rays, outs))
        torch.cuda.synchronize()
        err = max(err, _check_pair(f"serve tile classes steady frame {SERVE_FRAMES - 1}, kernels "
                                   f"vs plain", frames[-1][0], frames[-1][1], head_r, com_r,
                                   _far_sh(render, last, z_vals)))
    noskip = _serve_noskip_frames(cfg, args, SERVE_FRAMES)
    _noskip_errors("serve tile classes", frames, noskip)

    # the stages on the last steady frame's operands, each timed alone
    times = {}
    inputs, times["prep"] = _timed(render.inputs_fn, *last)
    pw_h, pw_t = inputs[:2]
    rays, times["gather"] = _timed(st["gather"], inputs)
    outs, edges = [], [0]
    for k in c["ks"]:
        edges.append(edges[-1] + k * R_T)
    for ci in range(3):
        if c["ks"][ci]:
            out, times[f"segment {CLASS_FIELDS[ci]} ({c['ks'][ci]} tiles: kernel, epilogue)"] = (
                _timed(st["segment"], pw_h, pw_t, rays, ci))
            outs.append(out)
    tiled, times["none tiles' epilogue + scatter"] = _timed(st["finish"], pw_h, pw_t, rays, outs)
    _, times["untile"] = _timed(lambda: [st["untile"](x) for x in tiled])
    saved = dict(c)  # a refresh on these operands would replace the classes
    occ, times["flags (refresh frames)"] = _timed(st["flags"], inputs)
    _, times["host split (refresh frames)"] = _timed(lambda: st["refresh"](occ.cpu().numpy()))
    c.update(saved)
    print(_stage_line(f"serve tile classes steady frame {SERVE_FRAMES - 1}", times), flush=True)

    # each segment's kernel at the main path's shapes (the classes of the
    # last refresh)
    ks, entries = c["ks"], []
    rays = st["gather"](render.inputs_fn(*last))
    for ci, name in enumerate(CLASS_VARIANTS):
        k = ks[ci]
        if not k:
            continue
        seg = [x[edges[ci]:edges[ci] + k * R_T] for x in rays]
        ops = prepare_render_operands(pw_h, pw_t, *seg[:4], z_vals, seg[4], rcfg.last_dist,
                                      rcfg.ert_eps, c["occs"][ci], "relu", True, CLASS_FIELDS[ci])
        got = render_rays_kernel(ops)
        ms = _cuda_ms(lambda: render_rays_kernel(ops), 3)
        ref, plain_ms = _cuda_call(lambda: fused_render_rays_reference(ops))
        err_k = _check_epilogue(f"serve segment {CLASS_FIELDS[ci]}, {name} vs plain", got, ref,
                                ops.occ)
        n_pad, S = k * R_T, rcfg.n_samples
        flops = float(got[2].sum()) * 8 * R_T * render_flops_per_sample(CLASS_FIELDS[ci])
        fields = ("head", "torso") if CLASS_FIELDS[ci] == "both" else (CLASS_FIELDS[ci],)
        weights = sum(t.numel() * t.element_size() for pw in (pw_h, pw_t)
                      for key, t in pw.items() if key not in ("w_view", "b_view"))
        n_bytes = (4 * n_pad * 3 * 4 + S * 4 + 2 * S * n_pad * 4 + 2 * n_pad * 256 * 2
                   + n_pad * 3 * 4 + k * (S // 8) * 4 + weights + 2 * n_pad * 3 * 4
                   + 2 * n_pad * 4 + k * 4)
        print(f"[serve segment {CLASS_FIELDS[ci]}] {name}: {k} tiles, slabs run "
              f"{int(got[2].sum())} of {k * (S // 8)}; {ms:.3f} ms per launch; plain "
              f"{plain_ms:.1f} ms; {flops / 1e12:.3f} TFLOP at live widths -> "
              f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak "
              f"({flops / ms / 1e9:.1f} TFLOP/s achieved); {n_bytes / 1e6:.1f} MB; SM time per "
              f"slab run {ms * 132 / max(int(got[2].sum()), 1):.3f} ms (132 SMs); L2 weight rate "
              f"{_l2_rate(fields, float(got[2].sum()) * 16, ms):.3f} TB/s",
              flush=True)
        entries.append(_entry(name, "render_rays.cu", "dfanerf_tpu/ops/fused_render.py:167",
                              launches[name], err_k, ms, plain_ms, flops, n_bytes))
    print(f"[serve tile classes] frame-level error vs plain {err:.3e}", flush=True)
    return entries, args, noskip, (s_ms, r_ms, window)


def phase_serve_plain_main_path(args, noskip):
    """The shipped serving config with tile compaction off (the plain
    occupancy branch): SERVE_PLAIN_FRAMES frames over two refreshes, one
    render_rays launch (epilogue mode, joint flags) per steady frame, no
    host sync; a refresh and a steady frame against the plain versions."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.data.synthetic import make_synthetic_scene
    from dfanerf_torch.ops.fused_render import render_rays_kernel

    cfg = _serve_cfg(tile_compaction=False)
    rcfg = cfg.render
    scene = make_synthetic_scene(n_frames=1, H=H, W=W, seed=0)
    warm = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    warm(*args(0))
    warm(*args(1))
    torch.cuda.synchronize()
    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    name = "render_rays_epilogue"
    render_rays_kernel.launches, render_rays_kernel.variant_launches = 0, {}
    frames, marks, syncs = _run_frames(
        render, args, SERVE_PLAIN_FRAMES, {name: (render_rays_kernel, name)},
        lambda c: c["occ"] is not None and c["age"] < rcfg.occ_refresh_every)
    launches = render_rays_kernel.variant_launches.get(name, 0)
    times = _frame_times("serve plain occupancy", marks, rcfg.occ_refresh_every)
    print(f"[serve plain occupancy] launches {render_rays_kernel.variant_launches}; host syncs in "
          f"steady frames {syncs}; joint flags {int(render.cache['occ'].amax(dim=0).sum())} of "
          f"{render.cache['occ'][0].numel()} slabs", flush=True)
    if sum(not st for st, _, _ in marks) != 2:
        _fail(f"serve plain occupancy: expected 2 refresh frames in {SERVE_PLAIN_FRAMES}")
    for i, (st, _, got) in enumerate(marks):
        if st and got != {name: 1}:
            _fail(f"serve plain occupancy steady frame {i} launched {got}")
    if syncs:
        _fail(f"{syncs} host synchronizations in the serve plain occupancy steady frames")
    for i, (head, com) in enumerate(frames):
        _check_frame(f"serve plain occupancy frame {i}", head, com)
    z_vals = linspace(scene.near, scene.far, rcfg.n_samples, device="cuda")
    last = args(SERVE_PLAIN_FRAMES - 1)
    with _plain_render_kernel():
        plain = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
        head_r, com_r = plain(*args(0))
        err = _check_pair("serve plain occupancy refresh frame 0, kernels vs plain", frames[0][0],
                          frames[0][1], head_r, com_r, _far_sh(render, args(0), z_vals))
        head_r, com_r = render(*last)  # a steady frame: the age stays below the refresh
        err = max(err, _check_pair(f"serve plain occupancy steady frame "
                                   f"{SERVE_PLAIN_FRAMES - 1}, kernels vs plain", frames[-1][0],
                                   frames[-1][1], head_r, com_r, _far_sh(render, last, z_vals)))
    _noskip_errors("serve plain occupancy", frames, noskip)
    print(f"[serve plain occupancy] frame-level error vs plain {err:.3e}", flush=True)
    return launches, times


def phase_serve_epilogue_kernel_form(args):
    """The tile-class branch with its background epilogue in its kernel
    form, bg_epilogue_fused (far_joint), as a caller who swaps it in gets:
    the decoder is relu, so the quirk of bg_epilogue_fused (always relu)
    changes nothing. SERVE_EPILOGUE_FRAMES frames; far_joint launches once
    per epilogue (each rendered segment and the none tiles) in a steady
    frame; frames against the shipped epilogue's; far_joint and its plain
    version timed on the frame's 215,296 rays."""
    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.core.rays import linspace
    from dfanerf_torch.data.synthetic import make_synthetic_scene
    from dfanerf_torch.ops import composite
    from dfanerf_torch.ops.far_eval import (
        bg_epilogue_fused, far_eval_reference, far_joint_kernel,
    )
    from dfanerf_torch.ops.fused_render import field_flops_per_sample, view_bias
    from dfanerf_torch.ops._build import weight_blobs

    cfg = _serve_cfg()
    rcfg = cfg.render
    if cfg.decoder.density_activation != "relu":
        _fail("the epilogue's kernel form always uses relu; the config's decoder does not")
    scene = make_synthetic_scene(n_frames=1, H=H, W=W, seed=0)

    def fused(*a, act="relu"):
        return bg_epilogue_fused(*a)

    real = composite._bg_epilogue
    shipped = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    ref, ref_marks, _ = _run_frames(shipped, args, SERVE_EPILOGUE_FRAMES, {}, lambda c: False)
    composite._bg_epilogue = fused
    try:
        with _patched(_bg_epilogue=fused):
            warm = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
            warm(*args(0))
            torch.cuda.synchronize()
            render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
            far_joint_kernel.launches = 0
            frames, marks, _ = _run_frames(
                render, args, SERVE_EPILOGUE_FRAMES, {"far_joint": (far_joint_kernel, None)},
                lambda c: False)
    finally:
        composite._bg_epilogue = real
    launches = far_joint_kernel.launches
    ks = render.cache["ks"]
    want = sum(1 for k in ks if k) + (sum(ks) < (-(-H // 16)) ** 2)
    print(f"[serve epilogue kernel form] {SERVE_EPILOGUE_FRAMES} frames, far_joint launches "
          f"{launches} ({[got for _, _, got in marks]}; {want} epilogues per frame under the "
          f"classes {ks}); {sum(ms for _, ms, _ in marks[1:]) / (len(marks) - 1):.2f} ms per "
          f"frame after the first, against {sum(ms for _, ms, _ in ref_marks[1:]) / (len(marks) - 1):.2f} "
          f"with the shipped epilogue", flush=True)
    if any(got.get("far_joint", 0) != want for _, _, got in marks[1:]):
        _fail("the epilogue's kernel form did not launch far_joint once per epilogue")
    z_vals = linspace(scene.near, scene.far, rcfg.n_samples, device="cuda")
    err = 0.0
    for i in range(SERVE_EPILOGUE_FRAMES):
        err = max(err, _check_pair(f"serve epilogue kernel form frame {i} vs the shipped epilogue",
                                   frames[i][0], frames[i][1], ref[i][0], ref[i][1],
                                   _far_sh(render, args(i), z_vals)))

    pw_h, pw_t, ro, rd, ro_t, rd_t, _ = render.inputs_fn(*args(SERVE_EPILOGUE_FRAMES - 1))
    n, far = ro.shape[0], float(z_vals[-1])
    vr_t = view_bias(pw_t, rd_t).to(torch.bfloat16).contiguous()
    got = far_joint_kernel(pw_h, pw_t, ro, rd, ro_t, rd_t, far, vr_t)
    ms = _cuda_ms(lambda: far_joint_kernel(pw_h, pw_t, ro, rd, ro_t, rd_t, far, vr_t), 5)
    ref_far, plain_ms = _cuda_call(lambda: far_eval_reference(pw_h, pw_t, ro, rd, ro_t, rd_t,
                                                               far, vr_t))
    err_k = max(*_check_far(f"serve far_joint vs plain, {n} rays", *got, *ref_far))
    acc = [ro.new_zeros((n, 3)), ro.new_zeros((n, 3)), ro.new_ones((n, 1)), ro.new_ones((n, 1))]
    epi = (pw_h, pw_t, ro, rd, ro_t, rd_t, z_vals, ro.new_zeros((n, 3)), rcfg.last_dist, *acc)
    epi_ms = _cuda_ms(lambda: real(*epi), 5)
    fused_ms = _cuda_ms(lambda: bg_epilogue_fused(*epi), 5)
    flops = n * (field_flops_per_sample("head", color=False)
                 + field_flops_per_sample("torso", sigma=False))
    n_bytes = (4 * n * 3 * 4 + n * 256 * 2 + n * 4 + n * 3 * 4
               + sum(x.numel() * x.element_size() for x in weight_blobs(pw_h, "head"))
               + sum(x.numel() * x.element_size() for x in weight_blobs(pw_t, "torso")))
    print(f"[serve epilogue kernel form] far_joint: {n} rays, {ms:.3f} ms per launch; plain "
          f"{plain_ms:.1f} ms; {flops / 1e12:.3f} TFLOP at live widths -> "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak ({flops / ms / 1e9:.1f} TFLOP/s "
          f"achieved); {n_bytes / 1e6:.1f} MB; L2 weight rate "
          f"{_far_l2_rate('far_joint', n, ms):.3f} TB/s. The whole-frame epilogue: _bg_epilogue "
          f"(plain PyTorch) {epi_ms:.3f} ms, bg_epilogue_fused {fused_ms:.3f} ms; frame-level error "
          f"{err:.3e}", flush=True)
    return _entry("far_joint", "far_eval.cu", "dfanerf_tpu/ops/fused_render.py:1381", launches,
                  err_k, ms, plain_ms, flops, n_bytes)


# Training (the second half of the main path) at benchmarks/serve_trained.py
# run()'s shape (:157-166): softplus density, 64 samples, bf16, 2048 rays, the
# distortion loss (3e-3) from step 2000, on make_synthetic_dataset(n_frames=8,
# H=450, W=450, n_samples_gt=64). TRAIN_STEPS from the seed's weights must
# bring the mean loss of the last TRAIN_WINDOW steps below TRAIN_DROP of the
# first TRAIN_WINDOW's (tests/test_train.py:30-41). The recipe's projected
# training time is RECIPE_STEPS steps (12,000 with distortion from 2,000, then
# a 2,000-step polish without).
TRAIN_STEPS, TRAIN_WINDOW, TRAIN_DROP = 60, 20, 0.6
# Warm ms per step: TRAIN_TURNS turns of TRAIN_TIMED steps for each setting
# of the distortion term, in ABBA order, reported as the median and the spread
# of the turns; then a torch.profiler trace of TRAIN_PROFILED steps.
TRAIN_TIMED, TRAIN_TURNS, TRAIN_WARM, TRAIN_PROFILED = 20, 3, 3, 10
PARITY_RAYS = 256
RECIPE_STEPS = {"distortion off": 2000 + 2000, "distortion on": 12000 - 2000}
# The trained field served by the render_rays kernel (bf16) against the
# unfused float32 field that training optimises: tests/test_ops.py:97-99's
# bars for the kernel against render_ray_batch.
SERVE_BARS = {"head_max": 2e-2, "head_mean": 2e-3, "com_mean": 5e-3}


def _recipe_cfg(**render):
    from dfanerf_torch.config import ExperimentConfig, RenderConfig, TrainConfig
    from dfanerf_torch.models import DecoderConfig

    return ExperimentConfig(
        decoder=DecoderConfig(density_activation="softplus"),
        render=RenderConfig(**{"n_samples": N_SAMPLES, "use_fused_kernel": True,
                               "compute_dtype": "bfloat16", "ert_eps": 0.0, **render}),
        train=TrainConfig(n_rand=2048, distortion_lambda=3e-3, distortion_from=2000))


def _timed_steps(step, state, data, generator, n):
    """ms per step over n steps (CUDA events), with any host sync an error."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        for _ in range(n):
            state, m = step(state, data, generator)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, m


def _profiled_steps(activities, step, state, data, generator):
    """A torch.profiler trace of TRAIN_PROFILED steps and the trace window's
    own wall time per step (CUDA events around the profiled steps)."""
    from torch.profiler import profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        start.record()
        for _ in range(TRAIN_PROFILED):
            step(state, data, generator)
        end.record()
        torch.cuda.synchronize()
    return prof, start.elapsed_time(end) / TRAIN_PROFILED


def _device_rows(prof):
    """(device us, name, count) of the card's own events (kernels, copies,
    fills): the host ops that launched them report the same time again, and
    the ranges' device spans are annotations, not work."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def _host_issue_ms(step, state, data, generator):
    """The host's time to issue one step from an idle card (perf_counter
    around the step, no sync inside it): median, min and max over
    TRAIN_PROFILED steps. The card starts each step idle, so the host waits
    for it only where the launch queue fills."""
    import numpy as np

    times = []
    for _ in range(TRAIN_PROFILED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, data, generator)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times)), min(times), max(times)


def _train_profile(step, state, data, generator, step_ms, card):
    """Two torch.profiler traces of TRAIN_PROFILED steps (distortion on).
    The card's events alone: the busy share of that window's own wall time
    (the host's ops unrecorded, so the step keeps its unprofiled pace). With
    the host's ops too: the kernel time of each stage of a step (the step's
    profiler ranges; the backward's kernels, launched from autograd's device
    thread, are the rest) and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from dfanerf_torch.train.step import STAGES

    host = _host_issue_ms(step, state, data, generator)
    prof, window_ms = _profiled_steps([ProfilerActivity.CUDA], step, state, data, generator)
    device_ms = sum(r[0] for r in _device_rows(prof)) / 1e3 / TRAIN_PROFILED
    prof, full_window_ms = _profiled_steps([ProfilerActivity.CPU, ProfilerActivity.CUDA], step,
                                           state, data, generator)
    rows = _device_rows(prof)
    full_device_ms = sum(r[0] for r in rows) / 1e3 / TRAIN_PROFILED
    if device_ms == 0 or full_device_ms == 0:
        _fail("the profiler saw no kernel of the train step")
    stages = {n: sum(e.device_time_total for e in prof.events()
                     if e.name == n and e.device_type == DeviceType.CPU) / 1e3 / TRAIN_PROFILED
              for n in STAGES}
    stages["train.backward"] = full_device_ms - sum(v for n, v in stages.items()
                                                    if n != "train.backward")
    top = [f"{k[:48]} {t / 1e3 / TRAIN_PROFILED:.2f} ms x{n // TRAIN_PROFILED}"
           for t, k, n in sorted(rows, reverse=True)[:6]]
    print(f"[train] a profiled step (torch.profiler, {TRAIN_PROFILED} steps, distortion on, "
          f"CUDA events around the profiled steps): the card's events alone: {window_ms:.3f} ms "
          f"of wall time, {device_ms:.3f} ms of kernels, busy {100 * device_ms / window_ms:.1f}% "
          f"({100 * device_ms / step_ms:.1f}% of the unprofiled median step, {step_ms:.3f} ms); "
          f"with the host's ops: {full_window_ms:.3f} ms of wall time, {full_device_ms:.3f} ms "
          f"of kernels, busy {100 * full_device_ms / full_window_ms:.1f}%; kernel ms by stage "
          f"{json.dumps({n: round(v, 3) for n, v in stages.items()})}; "
          f"{sum(r[2] for r in rows) // TRAIN_PROFILED} launches a step; top: {top}; {card}",
          flush=True)
    print(f"[train] the host's time to issue a step from an idle card (perf_counter, no sync, "
          f"{TRAIN_PROFILED} steps): median {host[0]:.3f} ms, {host[1]:.3f}-{host[2]:.3f}; "
          f"kernels {device_ms:.3f} ms; unprofiled median step {step_ms:.3f} ms; {card}",
          flush=True)


def phase_train(card):
    """Training through the entry points (make_synthetic_dataset,
    init_train_state, make_train_step, train_loop, load_checkpoint) at the
    recipe's shape: the ground truth against the CPU; one float32 step on
    the card against the same step on the CPU; TRAIN_STEPS steps of the
    recipe through train_loop (loss falling, a checkpoint read back bit for
    bit); warm ms per step with the distortion term off and on, with no host
    sync; the peak memory; then a held-out frame of the trained weights from
    render_rays against the unfused float32 renderer. Returns the
    render_rays launches of that render, the scene and the trained state."""
    import copy
    import tempfile

    import numpy as np

    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.compat.from_jax import state_to_jax
    from dfanerf_torch.data.synthetic import make_synthetic_dataset
    from dfanerf_torch.ops.fused_render import render_rays_kernel
    from dfanerf_torch.train.checkpoint import _flatten, load_checkpoint
    from dfanerf_torch.train.loop import train_loop
    from dfanerf_torch.train.state import init_train_state
    from dfanerf_torch.train.step import dataset_to_device, make_train_step

    t0 = time.time()
    ds = make_synthetic_dataset(n_frames=8, H=H, W=W, n_samples_gt=N_SAMPLES, device="cuda")
    scene_s = time.time() - t0
    t0 = time.time()
    cpu = make_synthetic_dataset(n_frames=1, H=H, W=W, n_samples_gt=N_SAMPLES, device="cpu")
    cpu_s = time.time() - t0
    for k in ("imgs_com", "imgs_head"):
        d = np.abs(getattr(ds, k)[0].astype(np.int16) - getattr(cpu, k)[0].astype(np.int16))
        print(f"[train] ground truth {k}[0], card vs CPU: max {int(d.max())} LSB, "
              f"{int((d > 0).sum())} of {d.size} channel values differ", flush=True)
        if d.max() > 1:
            _fail(f"ground truth {k}[0] differs from the CPU's by {int(d.max())} LSB")
    print(f"[train] scene {ds.n_frames} frames {H}x{W}, {N_SAMPLES} samples: {scene_s:.2f} s on "
          f"the card (2 targets a frame), frame 0 on the CPU {cpu_s:.2f} s", flush=True)

    # one float32 step, card against CPU, from the same state and batch
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        _fail("TF32 is on: the float32 check needs full float32 products and convolutions")
    cfg32 = _recipe_cfg(compute_dtype="float32")
    cfg32 = dataclasses.replace(cfg32, train=dataclasses.replace(cfg32.train, n_rand=PARITY_RAYS))
    states, metrics = {}, {}
    batch = make_train_step(cfg32, ds, device="cpu").draw_batch(torch.Generator().manual_seed(3))
    for dev in ("cpu", "cuda"):
        st = init_train_state(cfg32, seed=0, device=dev)
        st["step"] = cfg32.train.distortion_from  # the distortion term on
        b = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
        states[dev], metrics[dev] = make_train_step(cfg32, ds, device=dev).step_on_batch(
            st, dataset_to_device(ds, dev), b)
    rel = {k: abs(float(metrics["cuda"][k]) / float(metrics["cpu"][k]) - 1)
           for k in ("loss", "loss_head", "loss_com", "grad_norm")}
    p_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in zip(
        states["cuda"]["params"].parameters(), states["cpu"]["params"].parameters()))
    print(f"[train] float32 step ({PARITY_RAYS} rays, TF32 off for matmuls and cuDNN), card vs "
          f"CPU: relative differences {json.dumps(rel)}; params after the step within "
          f"{p_err:.3e}", flush=True)
    if max(rel.values()) > 1e-4:
        _fail(f"the float32 train step on the card differs from the CPU's: {rel}")
    del states

    # the recipe through the training loop
    cfg = _recipe_cfg()
    loop_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, i_print=1, i_weights=TRAIN_STEPS))
    losses = []
    with tempfile.TemporaryDirectory() as run:
        t0 = time.time()
        state = train_loop(loop_cfg, ds, n_iters=TRAIN_STEPS, run_dir=run, val_render=False,
                           device="cuda", on_metrics=lambda i, m: losses.append(m["loss"]))
        torch.cuda.synchronize()
        loop_s = time.time() - t0
        saved = load_checkpoint(os.path.join(run, f"{TRAIN_STEPS:06d}.npz"), state)
    flat_a, flat_b = _flatten(state_to_jax(saved)), _flatten(state_to_jax(state))
    if flat_a.keys() != flat_b.keys() or not all(
            flat_a[k].dtype == flat_b[k].dtype and np.array_equal(flat_a[k], flat_b[k])
            for k in flat_a):
        _fail("the checkpoint read back differs from the state saved")
    first, last = np.mean(losses[:TRAIN_WINDOW]), np.mean(losses[-TRAIN_WINDOW:])
    print(f"[train] train_loop, {TRAIN_STEPS} steps of the recipe from the seed's weights: "
          f"{loop_s:.2f} s (a metrics read each step); mean loss of the first {TRAIN_WINDOW} "
          f"{first:.5f}, of the last {last:.5f} ({last / first:.3f}x); checkpoint of "
          f"{len(flat_a)} arrays read back bit for bit", flush=True)
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        _fail(f"{len(losses)} losses logged, or non-finite ones")
    if not last < TRAIN_DROP * first:
        _fail(f"no convergence: mean loss {first:.5f} -> {last:.5f}")

    # warm ms per step, distortion off and on in ABBA turns
    step = make_train_step(cfg, ds, device="cuda")
    data = dataset_to_device(ds, "cuda")
    timed = copy.deepcopy(state)
    gen = torch.Generator().manual_seed(7)
    at = {"distortion off": TRAIN_STEPS, "distortion on": cfg.train.distortion_from}
    ms, peak = {label: [] for label in at}, 0.0
    for turn in range(2 * TRAIN_TURNS):
        label = list(at)[(turn + turn // 2) % 2]
        timed["step"] = at[label]
        for _ in range(TRAIN_WARM):
            step(timed, data, gen)
        torch.cuda.reset_peak_memory_stats()
        t, m = _timed_steps(step, timed, data, gen, TRAIN_TIMED)
        ms[label].append(t)
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        if not np.isfinite(float(m["loss"])):
            _fail(f"a non-finite loss in the timed steps ({label})")
    med = {label: float(np.median(v)) for label, v in ms.items()}
    for label, v in ms.items():
        print(f"[train] {label}: median {med[label]:.3f} ms per step ({1e3 / med[label]:.1f} "
              f"steps/s), turns {min(v):.3f}-{max(v):.3f} ms (spread "
              f"{100 * (max(v) - min(v)) / med[label]:.1f}% of the median; {TRAIN_TURNS} turns of "
              f"{TRAIN_TIMED} warm steps, CUDA events, no host sync): {[round(x, 3) for x in v]}; "
              f"{card}", flush=True)
    print(f"[train] peak memory of a step {peak:.2f} GiB; {card}", flush=True)
    _train_profile(step, timed, data, gen, med["distortion on"], card)
    projected = sum(RECIPE_STEPS[k] * med[k] for k in med) / 1e3
    print(f"[train] projected recipe time ({RECIPE_STEPS['distortion off']} steps without the "
          f"distortion term, {RECIPE_STEPS['distortion on']} with, at the median turn of each): "
          f"{projected:.1f} s; {card}", flush=True)
    del timed

    # a held-out frame of the trained weights: render_rays vs the unfused field
    i = int(ds.i_val[0])
    auds, exps, poses = (torch.from_numpy(x).cuda() for x in (ds.auds, ds.exps, ds.poses))
    bc_img = torch.from_numpy(ds.bc_img).cuda()
    params = state["params"]
    use_smo = state["step"] >= cfg.signal.nosmo_iters
    sig, sig_t = renderer.encode_frame_signals(params, auds, exps, poses, i, ds.n_frames, cfg,
                                               use_smo)
    args = (params, state["z_shape"], state["z_app"], poses[i], poses[0], sig, sig_t, bc_img)
    unfused = renderer.make_frame_renderer(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, use_fused_kernel=False, compute_dtype="float32")), ds.hwfcxy, ds.near, ds.far)
    head_r, com_r = unfused(*args)
    render = renderer.make_frame_renderer(cfg, ds.hwfcxy, ds.near, ds.far)
    torch.cuda.synchronize()
    render_rays_kernel.launches = 0
    head, com = render(*args)
    torch.cuda.synchronize()
    launches = render_rays_kernel.launches
    if launches != 1:
        _fail(f"render_rays launched {launches} times for one trained frame")
    _check_frame("trained frame", head, com)
    _check_frame("trained frame, unfused", head_r, com_r)
    (h_max, h_mean), (_, c_mean) = _errors(head, head_r), _errors(com, com_r)
    psnr = {}
    for tag, h, c in (("render_rays", head, com), ("unfused", head_r, com_r)):
        for name, img, gt in (("head", h, ds.imgs_head[i]), ("com", c, ds.imgs_com[i])):
            mse = float(((img.clamp(0, 1) - torch.from_numpy(gt).cuda().float() / 255) ** 2).mean())
            psnr[f"{tag} {name}"] = round(-10 * np.log10(max(mse, 1e-12)), 2)
    print(f"[train] held-out frame {i} of the trained weights, render_rays (bf16) vs the unfused "
          f"float32 field: head max {h_max:.3e} mean {h_mean:.3e}, com mean {c_mean:.3e} (bars "
          f"{SERVE_BARS}); val PSNR (dB) {json.dumps(psnr)}; render_rays launches {launches}",
          flush=True)
    if h_max >= SERVE_BARS["head_max"] or h_mean >= SERVE_BARS["head_mean"] \
            or c_mean >= SERVE_BARS["com_mean"]:
        _fail("the trained frame from render_rays is outside the bars of the unfused field")
    return launches, ds, state


# phase_reference_ckpt: driving frames, param_scale and window of the
# manifests rendered from the trained state's reference checkpoint
REF_FRAMES, REF_SCALE, REF_WINDOW = 8, 0.5, 3


def _render_rays_bytes(ops, fields):
    """Bytes render_rays must move: rays, depths, dists, view biases, the
    background, flags, the packed weights of the fields it evaluates, the
    outputs and the slab counts."""
    from dfanerf_torch.ops.fused_render import R_T

    n_pad, S = ops.n_tiles * R_T, ops.z_vals.numel()
    packs = [pw for f, pw in (("head", ops.packed_h), ("torso", ops.packed_t))
             if fields in ("both", f)]
    weights = sum(t.numel() * t.element_size() for pw in packs for k, t in pw.items()
                  if k not in ("w_view", "b_view"))
    return (4 * n_pad * 3 * 4 + S * 4 + 2 * S * n_pad * 4 + 2 * n_pad * 256 * 2 + n_pad * 3 * 4
            + ops.occ.numel() * 4 + weights + 2 * n_pad * 3 * 4 + ops.n_tiles * 4)


def phase_reference_ckpt(card, state, ds):
    """phase_train's trained full-width state written as a reference
    {:06d}.tar, read back onto the card with load_reference_checkpoint (bit
    for bit), and rendered through render_video_frames over the poses of
    driving_manifest (param_scale 0.5) and multi_window_manifest (window 3)
    built from the scene's manifest: the dense render_rays <1,1,1>, one
    launch a frame, frames timed with CUDA events, one frame's kernel
    against the plain version. Then the same frame through fused_render_rays
    with one field and the background in the kernel (<1,0,1>, <0,1,1>):
    one launch each, against the plain version, timed. Returns their
    kernel-line entries and render_rays <1,1,1>'s launches."""
    import tempfile

    import numpy as np

    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.compat.torch_ckpt import load_reference_checkpoint, reference_train_state
    from dfanerf_torch.ops.fused_render import (
        R_T, fused_render_rays, fused_render_rays_reference, prepare_render_operands,
        render_flops_per_sample, render_rays_kernel,
    )
    from dfanerf_torch.pipeline.manifests import driving_manifest, multi_window_manifest

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from reference_tar import REF_ENTRIES, reference_tar  # the inverse of the converters

    t0 = time.time()
    cfg = _recipe_cfg()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{int(state['step']):06d}.tar")
        nets = {k: getattr(state["params"], k).state_dict() for k in REF_ENTRIES}
        torch.save(reference_tar(nets, state["z_shape"], state["z_app"], state["step"]), path)
        size = os.path.getsize(path)
        ck = load_reference_checkpoint(path)
    n_tensors = 0
    for key in REF_ENTRIES:
        written = getattr(state["params"], key).state_dict()
        if sorted(ck[key]) != sorted(written):
            _fail(f"[reference ckpt] {key}: keys differ from the written state dict")
        for k, v in written.items():
            got = ck[key][k]
            n_tensors += 1
            if got.device.type != "cuda" or got.dtype != v.dtype or not torch.equal(got, v):
                _fail(f"[reference ckpt] {key}.{k} read back differs from the written tensor")
    for k in ("z_shape", "z_app"):
        n_tensors += 1
        if tuple(ck[k].shape) != (1, 2, 256) or not torch.equal(ck[k][0], state[k]):
            _fail(f"[reference ckpt] {k} read back differs from the written latents")
    rstate = reference_train_state(ck, cfg)
    print(f"[reference ckpt] {int(state['step']):06d}.tar ({size / 2 ** 20:.1f} MiB, 10 entries) "
          f"read back onto the card: {n_tensors} tensors equal bit for bit "
          f"({time.time() - t0:.2f} s)", flush=True)

    _, _, focal, cx, cy = ds.hwfcxy
    manifest = {"focal_len": focal, "cx": cx, "cy": cy,
                "frames": [{"img_id": i, "aud_id": i, "transform_matrix": ds.poses[i].tolist()}
                           for i in range(ds.n_frames)]}
    drive, _ = driving_manifest(manifest, REF_FRAMES, param_scale=REF_SCALE)
    multi = multi_window_manifest(manifest, REF_FRAMES, window=REF_WINDOW)
    captured = {}
    real = renderer.fused_render_rays

    def capture(*args, **kw):
        captured.setdefault("call", (args, kw))
        return real(*args, **kw)

    launches, times = 0, {}
    renderer.fused_render_rays = capture
    try:
        for tag, man in (("driving", drive), ("multi-window", multi)):
            frames = man["frames"]
            poses = np.array([f["transform_matrix"] for f in frames], np.float32)
            ids = [f["aud_id"] for f in frames]
            data = {"auds": ds.auds[ids], "exps": ds.exps[ids], "poses": poses,
                    "bc_img": ds.bc_img}
            torch.cuda.synchronize()
            render_rays_kernel.launches = 0
            render_rays_kernel.variant_launches.clear()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            com, head = renderer.render_video_frames(rstate, data, cfg, ds.hwfcxy, ds.near,
                                                     ds.far, range(len(frames)),
                                                     pose_body=poses[0])
            end.record()
            torch.cuda.synchronize()
            n = len(frames)
            times[tag] = start.elapsed_time(end) / n
            if (render_rays_kernel.launches != n
                    or render_rays_kernel.variant_launches != {"render_rays": n}):
                _fail(f"[reference ckpt] {tag}: render_rays launches "
                      f"{render_rays_kernel.variant_launches} for {n} frames")
            if com.shape != (n, H, W, 3) or head.shape != com.shape or com.dtype != np.uint8:
                _fail(f"[reference ckpt] {tag}: frames {com.shape} {com.dtype}")
            if len({bytes(f) for f in com}) < 2 or not (0 < com.mean() < 255):
                _fail(f"[reference ckpt] {tag}: the frames are blank or all the same")
            launches += n
            moved = float(np.abs(np.diff(poses[:, :3, 3], axis=0)).max())
            print(f"[reference ckpt] {tag} manifest ({n} frames, img/aud ids {ids}, pose steps up "
                  f"to {moved:.4f}): render_video_frames {times[tag]:.2f} ms a frame end to end "
                  f"(signals, render_rays, uint8 to the host; CUDA events), render_rays "
                  f"launches {render_rays_kernel.launches}; com mean {com.mean():.2f}; {card}",
                  flush=True)
    finally:
        renderer.fused_render_rays = real

    # frame 0 of the driving manifest: its operands through the kernel and the
    # plain version; then one field with the background in the kernel
    args, kw = captured["call"]
    entries, worst = [], {}
    for fields, name in (("both", "render_rays"), ("head", "render_rays_head_bg"),
                         ("torso", "render_rays_torso_bg")):
        if fields != "both":
            torch.cuda.synchronize()
            render_rays_kernel.variant_launches.clear()
            h, c = fused_render_rays(*args, **kw, fields=fields)
            torch.cuda.synchronize()
            if render_rays_kernel.variant_launches != {name: 1}:
                _fail(f"[reference ckpt] fused_render_rays(fields={fields!r}) launched "
                      f"{render_rays_kernel.variant_launches}")
            _check_frame(f"{name} frame", *(x[:H * W].reshape(H, W, 3) for x in (h, c)))
        ops = prepare_render_operands(*args, **kw, fields=fields)
        got = render_rays_kernel(ops)
        ref, plain_ms = _cuda_call(lambda: fused_render_rays_reference(ops))
        # the padding rays past the frame's (NaN in the plain version) are
        # left out, as the wrapper slices them off
        n = args[2].shape[0]
        far = (ref[4][:n], _far_torso_delta(ops, n)) if fields == "torso" else None
        err = _check_pair(f"reference ckpt frame 0, {name} vs plain", got[0][:n], got[1][:n],
                          ref[0][:n], ref[1][:n], ref[3][:n], far)
        if not torch.equal(got[2], ref[2]):
            _fail(f"{name}: slab counts differ from the plain version's")
        ms = _cuda_ms(lambda: render_rays_kernel(ops), 3)
        slabs = float(got[2].sum())
        flops = slabs * 8 * R_T * render_flops_per_sample(fields)
        n_bytes = _render_rays_bytes(ops, fields)
        print(f"[reference ckpt] {name}: {ms:.3f} ms per launch; plain {plain_ms:.1f} ms; slabs "
              f"run {int(slabs)} of {ops.n_tiles * ops.n_slabs}; {flops / 1e12:.3f} TFLOP at "
              f"live widths -> {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak "
              f"({flops / ms / 1e9:.1f} TFLOP/s achieved); {card}", flush=True)
        worst[name] = err
        if fields != "both":
            entries.append(_entry(name, "render_rays.cu", "dfanerf_tpu/ops/fused_render.py:167",
                                  1, err, ms, plain_ms, flops, n_bytes))
    print(f"[reference ckpt] phase {time.time() - t0:.1f} s", flush=True)
    return entries, launches


# BASELINE config 5 (phase_config5). Steps of each multi-identity run (loss
# falling below MULTI_DROP x its first MULTI_WINDOW steps' mean over the last
# MULTI_WINDOW, phase_train's rule), its warm steps, then its steps timed in
# turns of MULTI_TURN (CUDA events, sync debug "error").
MULTI_STEPS, MULTI_WINDOW, MULTI_DROP, MULTI_WARM, MULTI_TURN = 50, 20, 0.6, 20, 10
# the second identity: another seed, fewer frames; the dynamic-speaker run's
# speaking frames mix both branches
MULTI_FRAMES2, MULTI_SEED2 = 4, 1
MULTI_SPEAK = ((1, 0, 1, 0, 1, 0, 1, 0), (0, 1, 1, 0))
# warm ms per step: CONFIG5_TURNS turns of CONFIG5_TIMED steps after
# CONFIG5_WARM, median over the turns
CONFIG5_TURNS, CONFIG5_TIMED, CONFIG5_WARM = 3, 5, 3
SPARSITY_LAMBDA, SPARSITY_POINTS = 1e-3, 4096
CLI_STEPS, CLI_FRAMES = 4, 3


def _median_turns(run_turn, labels, turns=CONFIG5_TURNS):
    """{label: (median ms, per-turn ms)} over ``turns`` turns, each running
    ``run_turn(label)`` for every label in a rotated order."""
    import numpy as np

    ms = {label: [] for label in labels}
    for turn in range(turns):
        for label in labels[turn % len(labels):] + labels[:turn % len(labels)]:
            ms[label].append(run_turn(label))
    return {label: (float(np.median(v)), v) for label, v in ms.items()}


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _f32_ulps(a, b) -> int:
    """The largest distance in float32 ulps between two float32 tensors."""
    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def _config5_sharded(card, ds, mesh):
    """The ray-sharded step over the NCCL mesh of one rank: one step against
    TrainStep.step_on_batch on the same batch (distortion and clip off) bit
    for bit; a float32 step on the card against the same step on the CPU;
    warm ms per step and the all-reduce's own ms."""
    import copy

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from dfanerf_torch.parallel import make_sharded_train_step
    from dfanerf_torch.parallel.mesh import all_reduce_mean
    from dfanerf_torch.train.state import init_train_state
    from dfanerf_torch.train.step import dataset_to_device, make_train_step

    cfg = _recipe_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, distortion_lambda=0.0))
    data = dataset_to_device(ds, "cuda")
    sharded = make_sharded_train_step(cfg, ds, mesh)
    single = make_train_step(cfg, ds, device="cuda")
    state = init_train_state(cfg, seed=0, device="cuda")
    a, b = copy.deepcopy(state), copy.deepcopy(state)
    batch = sharded.draw_batch(torch.Generator().manual_seed(5))
    a, ma = single.step_on_batch(a, data, batch)
    b, mb = sharded.step_on_batch(b, data, batch)
    torch.cuda.synchronize()
    same = {k: _same_bits(ma[k], mb[k]) for k in ("loss", "loss_head", "loss_com")}
    diffs = []
    for (n, pa), pb, p0 in zip(a["params"].named_parameters(), b["params"].parameters(),
                               state["params"].parameters()):
        if n.startswith("decoder."):
            if not _same_bits(pa, pb):
                diffs.append((n, _f32_ulps(pa.detach(), pb.detach())))
        elif not _same_bits(pb, p0):
            _fail(f"the sharded step moved {n}: its signals are encoded outside the gradient")
    for k in ("m", "v"):
        for n, t in a["opt"]["decoder"][k].items():
            if not _same_bits(t, b["opt"]["decoder"][k][n]):
                diffs.append((f"opt.decoder.{k}.{n}", _f32_ulps(t, b["opt"]["decoder"][k][n])))
    moved = [n for (n, pa), p0 in zip(a["params"].named_parameters(),
                                      state["params"].parameters())
             if not n.startswith("decoder.") and not _same_bits(pa, p0)]
    print(f"[config5] one sharded step (NCCL, world 1) vs TrainStep.step_on_batch, same batch, "
          f"bf16, {cfg.train.n_rand} rays, distortion and clip off: losses bit for bit "
          f"{json.dumps(same)}; decoder parameters and moments: "
          f"{'bit for bit' if not diffs else f'{len(diffs)} differ, float32 ulps {diffs[:6]}'}; "
          f"the signal nets, which TrainStep moves ({len(moved)} tensors), stay put in the "
          f"sharded step (the reference's signals outside the gradient)", flush=True)
    if not all(same.values()) or diffs:
        _fail("the sharded step at world 1 differs from TrainStep on the same batch")
    del a, b

    # float32: the card against the CPU, over a gloo mesh of the same rank
    cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                     mesh_dim_names=("rays",))
    cfg32 = dataclasses.replace(_recipe_cfg(compute_dtype="float32"), train=dataclasses.replace(
        cfg.train, n_rand=PARITY_RAYS))
    batch = make_sharded_train_step(cfg32, ds, cpu_mesh).draw_batch(
        torch.Generator().manual_seed(6))
    metrics = {}
    for dev, m in (("cpu", cpu_mesh), ("cuda", mesh)):
        st = init_train_state(cfg32, seed=0, device=dev)
        bt = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
        _, metrics[dev] = make_sharded_train_step(cfg32, ds, m).step_on_batch(
            st, dataset_to_device(ds, dev), bt)
    rel = {k: abs(float(metrics["cuda"][k]) / float(metrics["cpu"][k]) - 1)
           for k in ("loss", "loss_head", "loss_com")}
    print(f"[config5] float32 sharded step ({PARITY_RAYS} rays), card (NCCL) vs CPU (gloo): "
          f"relative differences {json.dumps(rel)}", flush=True)
    if max(rel.values()) > 1e-4:
        _fail(f"the float32 sharded step on the card differs from the CPU's: {rel}")

    # warm ms per step beside TrainStep's, and the all-reduce alone
    gen = torch.Generator().manual_seed(7)
    steps = {"sharded": (sharded, copy.deepcopy(state)), "single": (single, copy.deepcopy(state))}

    def turn(label):
        step, st = steps[label]
        for _ in range(CONFIG5_WARM):
            step(st, data, gen)
        return _timed_steps(step, st, data, gen, CONFIG5_TIMED)[0]

    med = _median_turns(turn, list(steps))
    params = steps["sharded"][1]["params"]
    n_bucket = sum(p.numel() for p in params.parameters()) + 3
    bucket = torch.zeros(n_bucket, device="cuda")
    for p in params.parameters():
        p.grad = torch.zeros_like(p)
    losses = [torch.zeros((), device="cuda")] * 3
    ar_ms = _cuda_ms(lambda: dist.all_reduce(bucket, group=mesh.get_group()), 50)
    mean_ms = _cuda_ms(lambda: all_reduce_mean(params, losses, mesh), 50)
    for p in params.parameters():
        p.grad = None
    for label, (m, v) in med.items():
        print(f"[config5] {label} step (bf16, {cfg.train.n_rand} rays, distortion off): median "
              f"{m:.3f} ms per step over {CONFIG5_TURNS} turns of {CONFIG5_TIMED} (CUDA events, "
              f"sync debug error): {[round(x, 3) for x in v]}; {card}", flush=True)
    print(f"[config5] the gradient all-reduce, world 1 (NCCL): all_reduce of the "
          f"{n_bucket * 4 / 2 ** 20:.2f} MiB bucket {ar_ms:.4f} ms; with the flatten, the "
          f"division and the views (all_reduce_mean) {mean_ms:.4f} ms; sharded - single "
          f"{med['sharded'][0] - med['single'][0]:+.3f} ms; {card}", flush=True)


def _run_multi(step, state, data_list, gen):
    """MULTI_STEPS steps: the losses (read once, at the end) and the warm ms
    per step of the turns after MULTI_WARM (CUDA events, sync debug error)."""
    import numpy as np

    losses, turns = [], []
    for i in range(MULTI_STEPS):
        if i >= MULTI_WARM and (i - MULTI_WARM) % MULTI_TURN == 0:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda.set_sync_debug_mode("error")
        state, m = step(state, data_list, gen)
        losses.append(m["loss"])
        if i >= MULTI_WARM and (i - MULTI_WARM) % MULTI_TURN == MULTI_TURN - 1:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.set_sync_debug_mode("default")
            end.synchronize()
            turns.append(start.elapsed_time(end) / MULTI_TURN)
    return state, torch.stack(losses).cpu().numpy(), float(np.median(turns)), turns


def _config5_multi(card, ds):
    """Multi-identity training, n_object=2: static and dynamic speaker,
    the loss falling and the warm ms per step; then a frame of object 0 of
    the static run's state from render_rays against the unfused float32
    field. Returns render_rays' launches."""
    import numpy as np

    import dfanerf_torch.render.renderer as renderer
    from dfanerf_torch.data.synthetic import make_synthetic_dataset
    from dfanerf_torch.ops.fused_render import render_rays_kernel
    from dfanerf_torch.parallel.multi import make_multi_identity_train_step
    from dfanerf_torch.train.state import init_train_state

    t0 = time.time()
    ds2 = make_synthetic_dataset(n_frames=MULTI_FRAMES2, H=H, W=W, n_samples_gt=N_SAMPLES,
                                 seed=MULTI_SEED2, device="cuda")
    print(f"[config5] second identity: {MULTI_FRAMES2} frames {H}x{W}, seed {MULTI_SEED2}, "
          f"{time.time() - t0:.2f} s", flush=True)
    cfg = _recipe_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, n_object=2))
    trained = None
    for dynamic in (False, True):
        dss = [ds, ds2]
        if dynamic:
            dss = [dataclasses.replace(d, speak_frames=np.array(s, np.int32))
                   for d, s in zip(dss, MULTI_SPEAK)]
        step, data_list = make_multi_identity_train_step(cfg, dss, dynamic_speaker=dynamic,
                                                         device="cuda")
        state = init_train_state(cfg, seed=0, device="cuda")
        state, losses, ms, turns = _run_multi(step, state, data_list,
                                              torch.Generator().manual_seed(8))
        first, last = losses[:MULTI_WINDOW].mean(), losses[-MULTI_WINDOW:].mean()
        branches = sorted({step.speaks(o, int(i)) for o, ob in enumerate(step.objects)
                           for i in ob.i_train})
        print(f"[config5] multi-identity, {'dynamic' if dynamic else 'static'} speaker, 2 "
              f"objects ({MULTI_STEPS} steps, bf16, {cfg.train.n_rand} rays each): mean loss "
              f"of the first {MULTI_WINDOW} {first:.5f}, of the last {last:.5f} "
              f"({last / first:.3f}x); branches speaking {branches}; warm median {ms:.3f} ms "
              f"per step, turns of {MULTI_TURN}: {[round(x, 3) for x in turns]} (CUDA events, "
              f"sync debug error); counters {[o['t'] for o in state['opt'].values()]}; {card}",
              flush=True)
        if not np.isfinite(losses).all() or not last < MULTI_DROP * first:
            _fail(f"multi-identity ({'dynamic' if dynamic else 'static'}) did not converge: "
                  f"{first:.5f} -> {last:.5f}")
        if dynamic and branches != [False, True]:
            _fail("the dynamic-speaker run did not mix both branches")
        if not dynamic:
            trained = state

    # a frame of object 0 of the static run: render_rays vs the unfused field
    i = int(ds.i_val[0])
    auds, exps, poses = (torch.from_numpy(x).cuda() for x in (ds.auds, ds.exps, ds.poses))
    bc_img = torch.from_numpy(ds.bc_img).cuda()
    params = trained["params"]
    sig, sig_t = renderer.encode_frame_signals(params, auds, exps, poses, i, ds.n_frames, cfg,
                                               False)
    args = (params, trained["z_shape"][:2], trained["z_app"][:2], poses[i], poses[0], sig,
            sig_t, bc_img)
    unfused = renderer.make_frame_renderer(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, use_fused_kernel=False, compute_dtype="float32")), ds.hwfcxy, ds.near, ds.far)
    head_r, com_r = unfused(*args)
    render = renderer.make_frame_renderer(cfg, ds.hwfcxy, ds.near, ds.far)
    torch.cuda.synchronize()
    render_rays_kernel.launches = 0
    head, com = render(*args)
    torch.cuda.synchronize()
    launches = render_rays_kernel.launches
    if launches != 1:
        _fail(f"render_rays launched {launches} times for object 0's frame")
    _check_frame("config5 object 0", head, com)
    (h_max, h_mean), (_, c_mean) = _errors(head, head_r), _errors(com, com_r)
    print(f"[config5] held-out frame {i} of object 0 of the multi-identity state, render_rays "
          f"(bf16) vs the unfused float32 field: head max {h_max:.3e} mean {h_mean:.3e}, com "
          f"mean {c_mean:.3e} (bars {SERVE_BARS}); render_rays launches {launches}", flush=True)
    if h_max >= SERVE_BARS["head_max"] or h_mean >= SERVE_BARS["head_mean"] \
            or c_mean >= SERVE_BARS["com_mean"]:
        _fail("object 0's frame from render_rays is outside the bars of the unfused field")
    return launches


def _config5_sparsity(card, ds):
    """The serving-bake prior: one float32 step per mode on the card against
    the same step on the CPU (same draws); warm ms per step, bf16, per mode
    beside the step without it."""
    import copy

    from dfanerf_torch.train.state import init_train_state
    from dfanerf_torch.train.step import SPARSITY_MODES, dataset_to_device, make_train_step

    cfg32 = _recipe_cfg(compute_dtype="float32")
    cfg32 = dataclasses.replace(cfg32, train=dataclasses.replace(cfg32.train, n_rand=PARITY_RAYS))
    kw = dict(sparsity_lambda=SPARSITY_LAMBDA, sparsity_points=SPARSITY_POINTS)
    data = {dev: dataset_to_device(ds, dev) for dev in ("cpu", "cuda")}
    for mode in SPARSITY_MODES:
        batch = make_train_step(cfg32, ds, sparsity_mode=mode, device="cpu", **kw).draw_batch(
            torch.Generator().manual_seed(9))
        metrics = {}
        for dev in ("cpu", "cuda"):
            st = init_train_state(cfg32, seed=0, device=dev)
            bt = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
            _, metrics[dev] = make_train_step(cfg32, ds, sparsity_mode=mode, device=dev,
                                              **kw).step_on_batch(st, data[dev], bt)
        rel = {k: abs(float(metrics["cuda"][k]) / float(metrics["cpu"][k]) - 1)
               for k in ("loss", "loss_head", "loss_com", "grad_norm")}
        print(f"[config5] sparsity '{mode}' ({SPARSITY_POINTS} points, lambda "
              f"{SPARSITY_LAMBDA}), float32 step ({PARITY_RAYS} rays), card vs CPU: relative "
              f"differences {json.dumps(rel)}", flush=True)
        if max(rel.values()) > 1e-4:
            _fail(f"the float32 step with the '{mode}' prior differs from the CPU's: {rel}")

    cfg = _recipe_cfg()
    state = init_train_state(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(10)
    steps = {"none": (make_train_step(cfg, ds, device="cuda"), copy.deepcopy(state))}
    for mode in SPARSITY_MODES:
        steps[mode] = (make_train_step(cfg, ds, sparsity_mode=mode, device="cuda", **kw),
                       copy.deepcopy(state))

    def turn(label):
        step, st = steps[label]
        for _ in range(CONFIG5_WARM):
            step(st, data["cuda"], gen)
        return _timed_steps(step, st, data["cuda"], gen, CONFIG5_TIMED)[0]

    med = _median_turns(turn, list(steps))
    base = med["none"][0]
    for label, (m, v) in med.items():
        print(f"[config5] bf16 step ({cfg.train.n_rand} rays, distortion off), prior "
              f"'{label}': median {m:.3f} ms ({m - base:+.3f} vs none) over {CONFIG5_TURNS} "
              f"turns of {CONFIG5_TIMED} (CUDA events, sync debug error): "
              f"{[round(x, 3) for x in v]}; {card}", flush=True)


def _write_identity(d, ds, driving):
    """ds as an identity directory: JPEG frames (OpenCV), the _ba
    manifests, features, and a driving manifest of the frames ``driving``."""
    import cv2

    os.makedirs(os.path.join(d, "head_imgs"))
    os.makedirs(os.path.join(d, "com_imgs"))
    for i in range(ds.n_frames):
        for sub, imgs in (("head_imgs", ds.imgs_head), ("com_imgs", ds.imgs_com)):
            cv2.imwrite(os.path.join(d, sub, f"{i:06d}.jpg"), imgs[i][..., ::-1].copy())
    cv2.imwrite(os.path.join(d, "bc.jpg"), ds.bc_img[..., ::-1].copy())
    _, _, focal, cx, cy = ds.hwfcxy

    def manifest(ids):
        return {"focal_len": focal, "cx": cx, "cy": cy,
                "frames": [{"img_id": int(i), "aud_id": int(i),
                            "transform_matrix": ds.poses[i].tolist(),
                            "face_rect": ds.sample_rects[i].tolist()} for i in ids]}

    for name, ids in (("transforms_train_ba.json", ds.i_train),
                      ("transforms_val_ba.json", ds.i_val), ("driving.json", driving)):
        with open(os.path.join(d, name), "w") as f:
            json.dump(manifest(ids), f)
    torch.save(torch.from_numpy(ds.auds), os.path.join(d, "aud.pt"))
    torch.save({"exp_o": torch.from_numpy(ds.exps)}, os.path.join(d, "exp.pt"))


def _read_ppm(path):
    import numpy as np

    with open(path, "rb") as f:
        magic, w, h, _, pixels = f.read().split(maxsplit=4)
    if magic != b"P6":
        _fail(f"{path} is not a binary PPM")
    return np.frombuffer(pixels, np.uint8).reshape(int(h), int(w), 3)


def _config5_loader_cli(card, ds):
    """An identity directory written with OpenCV and loaded back; cli train
    --datadir and cli render --test-file on the card. Returns render_rays'
    launches of the render."""
    import tempfile

    import cv2
    import numpy as np

    from dfanerf_torch import cli
    from dfanerf_torch.data.dataset import load_audface_dataset
    from dfanerf_torch.ops.fused_render import render_rays_kernel

    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "identity")
        driving = [int(i) for i in ds.i_val[:1]] + [int(i) for i in ds.i_train[:CLI_FRAMES - 1]]
        t0 = time.time()
        _write_identity(d, ds, driving)
        loaded = load_audface_dataset(d, "aud.pt", "exp.pt")
        load_s = time.time() - t0
        for i in range(loaded.n_frames):
            for sub, imgs in (("com_imgs", loaded.imgs_com), ("head_imgs", loaded.imgs_head)):
                ref = cv2.imread(os.path.join(d, sub, f"{i:06d}.jpg"), cv2.IMREAD_COLOR)[..., ::-1]
                if not np.array_equal(imgs[i], ref):
                    _fail(f"{sub}/{i:06d}.jpg: the loader's frame differs from cv2.imread's")
        jpeg = float(np.abs(loaded.imgs_com.astype(np.int16) - ds.imgs_com.astype(np.int16)).mean())
        print(f"[config5] identity directory of {loaded.n_frames} frames {H}x{W} written (OpenCV "
              f"JPEG) and loaded in {load_s:.2f} s: every frame equals cv2.imread's; mean "
              f"|JPEG - source| {jpeg:.2f} LSB", flush=True)
        cfg = _recipe_cfg()
        raw = cfg.to_dict()
        raw.update(basedir=os.path.join(tmp, "runs"), expname="id")
        raw["train"].update(i_weights=CLI_STEPS, i_print=CLI_STEPS)
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        common = ["--config", cfg_path, "--datadir", d]
        t0 = time.time()
        cli.main(["train", *common, "--aud-file", "aud.pt", "--exp-file", "exp.pt",
                  "--n-iters", str(CLI_STEPS)])
        train_s = time.time() - t0
        ckpt = os.path.join(tmp, "runs", "id", f"{CLI_STEPS:06d}.npz")
        out = os.path.join(tmp, "out")
        torch.cuda.synchronize()
        before = render_rays_kernel.launches
        t0 = time.time()
        cli.main(["render", *common, "--ckpt", ckpt, "--test-file", "driving.json",
                  "--out", out])
        render_s = time.time() - t0
        launches = render_rays_kernel.launches - before
        frames = [_read_ppm(os.path.join(out, sub, f"test_{i:06d}.ppm"))
                  for sub in ("render_com", "render_head") for i in range(len(driving))]
    if launches != len(driving) or any(f.shape != (H, W, 3) for f in frames):
        _fail(f"cli render: {launches} render_rays launches, frames {[f.shape for f in frames]}")
    print(f"[config5] cli train --datadir ({CLI_STEPS} steps) {train_s:.2f} s; cli render "
          f"--test-file ({len(driving)} frames, {H}x{W} PPM, composite and head) {render_s:.2f} "
          f"s, render_rays launches {launches}; {card}", flush=True)
    return launches


def phase_config5(card, ds):
    """BASELINE config 5 and the rest of training: the ray-sharded step over
    an NCCL process group of one rank, multi-identity training, the sparsity
    prior, the identity-directory loader and the cli on it. Returns
    render_rays' launches."""
    import torch.distributed as dist

    from dfanerf_torch.parallel import make_mesh
    from dfanerf_torch.parallel.distributed import initialize

    t0 = time.time()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not initialize(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, local_rank=0):
        _fail("initialize() started no process group")
    try:
        if dist.get_backend() != "nccl":
            _fail(f"the CUDA process group runs {dist.get_backend()}, not NCCL")
        _config5_sharded(card, ds, make_mesh())
    finally:
        dist.destroy_process_group()
    launches = _config5_multi(card, ds)
    _config5_sparsity(card, ds)
    launches += _config5_loader_cli(card, ds)
    print(f"[config5] phase {time.time() - t0:.1f} s", flush=True)
    return launches


# --- phase_process: the preprocessing DAG (pipeline/driver.py) ---------------------

PROCESS_FRAMES = 24      # step 6's default ref_id 18 needs at least 19 frames
PROCESS_SIZE = 512       # the driver's default dst_size
PROCESS_BG_SHARE = 0.4   # the share of frame 0's pixels the parser's class-0 bias makes background
BOX_BIAS = 64.0          # BlazeFace's raw w/h regression bias: boxes half its 128x128 input


def write_process_identity(id_dir, n_frames=PROCESS_FRAMES, size=PROCESS_SIZE, seed=0,
                           device="cuda"):
    """A seeded identity directory as steps -1 to 1 would leave it: the
    synthetic scene's composite frames (64x64, rendered on ``device``)
    resized with cv2 to size x size as ori_imgs/{:06d}.jpg, and a 16 kHz
    aud.wav (a modulated tone and noise, one second longer than the
    frames)."""
    import cv2
    import numpy as np
    from scipy.io import wavfile

    from dfanerf_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(n_frames=n_frames, H=64, W=64, seed=seed, device=device)
    os.makedirs(os.path.join(id_dir, "ori_imgs"), exist_ok=True)
    for i, img in enumerate(ds.imgs_com):
        big = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(os.path.join(id_dir, "ori_imgs", f"{i:06d}.jpg"), big[..., ::-1])
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * (n_frames / 25.0 + 1.0))) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t)) + 0.05 * rng.randn(t.size)
    wavfile.write(os.path.join(id_dir, "aud.wav"), 16000,
                  (np.clip(wav, -1, 1) * 32767).astype(np.int16))


def write_process_assets(root, id_dir, seed=0, hrnet_cfg=None, device="cuda"):
    """Seeded stand-ins for the reference's assets under ``root``: the five
    nets' checkpoints (.pth state dicts), the wav2exp encoder, dis_ckpt.pth,
    and a seeded 3DMM at the basis's full size (34,650 points, 100 id and 79
    expression dims, one texture row: the fit reads no texture) in the
    reference's .bin layout. Returns (PipelineAssets, the raised biases).

    Seeded weights give two steps nothing to work on, so two last-layer
    biases are raised in the SAVED checkpoints (the package's nets stay as
    shipped):
    - BlazeFace's regressor_8 / regressor_16 w and h biases, +BOX_BIAS:
      seeded regressions are +-30 around zero, so the blended box would be
      of about zero (or negative) size;
    - BiSeNet's main head (conv_out.conv_out) gets a bias, 0 except class 0
      (background), which is raised until PROCESS_BG_SHARE of frame 0's
      pixels parse as background: seeded logits put every pixel in a head
      class, so step 4 would find no background and step 6's head mask
      would be the whole frame.
    The reference's converters read both (its BiSeNet converter takes a
    conv bias where the checkpoint holds one)."""
    import cv2
    import numpy as np

    from dfanerf_torch.models.perception.bisenet import BiSeNet
    from dfanerf_torch.models.perception.blazeface import BlazeFace
    from dfanerf_torch.models.perception.common import seeded_init_
    from dfanerf_torch.models.perception.ghostnet_eye import EyeNet
    from dfanerf_torch.models.perception.hrnet import HRNet, HRNetConfig
    from dfanerf_torch.models.perception.raft import RAFTSmall
    from dfanerf_torch.pipeline.audio.wav2exp import AudioEncoder
    from dfanerf_torch.pipeline.disentangle import Distangler
    from dfanerf_torch.pipeline.driver import IMAGENET_MEAN, IMAGENET_STD, PipelineAssets
    from dfanerf_torch.pipeline.face3dmm import synthetic_3dmm_arrays, write_face3dmm

    os.makedirs(root, exist_ok=True)
    nets = {"blazeface_pth": BlazeFace(), "hrnet_pth": HRNet(hrnet_cfg or HRNetConfig()),
            "eye_pth": EyeNet(), "bisenet_pth": BiSeNet(out_bias=True), "raft_pth": RAFTSmall(),
            "wav2exp_pth": AudioEncoder(), "dis": Distangler()}
    raised = {}
    paths = {}
    for i, (key, net) in enumerate(nets.items()):
        seeded_init_(net, seed + i)
        with torch.no_grad():
            if key == "blazeface_pth":
                for name, conv in (("regressor_8", net.regressor_8),
                                   ("regressor_16", net.regressor_16)):
                    wh = conv.bias.view(-1, 16)[:, 2:4]
                    wh += BOX_BIAS
                    raised[f"blazeface {name}.bias[w, h]"] = f"+{BOX_BIAS}"
            if key == "bisenet_pth":
                net.conv_out.conv_out.bias.zero_()
                net.to(device).eval()
                img = cv2.imread(os.path.join(id_dir, "ori_imgs", "000000.jpg"))[..., ::-1]
                x = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
                logits = net(torch.from_numpy(x[None]).to(device).permute(0, 3, 1, 2))[0][0]
                deficit = logits[1:].amax(0) - logits[0]
                bias0 = float(torch.quantile(deficit.flatten().float().cpu(), PROCESS_BG_SHARE))
                net.conv_out.conv_out.bias[0] = bias0
                raised["bisenet conv_out.conv_out.bias[0]"] = f"{bias0:+.4f}"
                net.cpu()
        path = os.path.join(root, "dis" if key == "dis" else "", "dis_ckpt.pth" if key == "dis"
                            else key.replace("_pth", ".pth"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(net.state_dict(), path)
        paths[key] = path
    bfm = write_face3dmm(os.path.join(root, "bfm"),
                         synthetic_3dmm_arrays(seed, point_num=34650, id_dim=100, exp_dim=79,
                                               tex_dim=1))
    assets = PipelineAssets(**{k: v for k, v in paths.items() if k != "dis"},
                            disentangle_dir=os.path.dirname(paths["dis"]), face3dmm_dir=bfm)
    return assets, raised


PROCESS_TOL = {"rtol": 1e-4, "atol": 1e-5}  # card vs CPU; atol per unit of the output's scale
PROCESS_CHECK_FRAMES = 2
PROCESS_FIT_ITERS = 50


def _process_close(tag, got, want, rtol=PROCESS_TOL["rtol"], atol=PROCESS_TOL["atol"],
                   scaled=True, phase="process"):
    """Hold a card result against the CPU's: rtol, and atol times the CPU
    output's largest magnitude (at least 1) where ``scaled``."""
    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    if got.shape != want.shape:
        _fail(f"[{phase}] {tag}: card {tuple(got.shape)} vs cpu {tuple(want.shape)}")
    scale = max(1.0, want.abs().max().item()) if scaled else 1.0
    err = (got - want).abs().max().item() if got.numel() else 0.0
    print(f"[{phase}] {tag}: card vs cpu max abs err {err:.3g} (scale {scale:.3g}, rtol {rtol}, "
          f"atol {atol * scale:.3g})", flush=True)
    if not torch.allclose(got, want, rtol=rtol, atol=atol * scale):
        _fail(f"[{phase}] {tag}: the card disagrees with the CPU")
    return err


@torch.no_grad()
def _process_card_vs_cpu(d, assets):
    """The nets, the decoded landmarks, the parsing classes and the flows of
    PROCESS_CHECK_FRAMES frames on the card against the port's CPU path on
    the same inputs, and a PROCESS_FIT_ITERS-step tracker fit; the
    tolerances of the CPU tests."""
    import cv2
    import numpy as np

    from dfanerf_torch.models.perception.bisenet import load_bisenet
    from dfanerf_torch.models.perception.blazeface import (
        detect_faces, generate_anchors, load_blazeface,
    )
    from dfanerf_torch.models.perception.ghostnet_eye import load_eye_net
    from dfanerf_torch.models.perception.hrnet import load_hrnet
    from dfanerf_torch.models.perception.raft import flow_on_crops, load_raft_small, mask_crop
    from dfanerf_torch.pipeline.affine import bbox2cs, crop_affine, pts2cs
    from dfanerf_torch.pipeline.driver import IMAGENET_MEAN, IMAGENET_STD, _imread
    from dfanerf_torch.pipeline.face3dmm import load_face3dmm
    from dfanerf_torch.pipeline.heatmaps import decode_heatmaps
    from dfanerf_torch.pipeline.tracking import fit_landmarks

    loaders = {"blazeface": (load_blazeface, assets.blazeface_pth),
               "hrnet": (load_hrnet, assets.hrnet_pth), "eye": (load_eye_net, assets.eye_pth),
               "bisenet": (load_bisenet, assets.bisenet_pth),
               "raft": (load_raft_small, assets.raft_pth)}
    devs = ("cuda", "cpu")
    nets = {k: {dev: load(path, device=dev) for dev in devs} for k, (load, path) in loaders.items()}

    def both(name, x):
        return [nets[name][dev](x.to(dev)) for dev in devs]

    path = lambda *p: os.path.join(d.id_dir, *p)  # noqa: E731
    imgs = [_imread(path("ori_imgs", f"{i:06d}.jpg")) for i in range(PROCESS_CHECK_FRAMES)]
    small = torch.from_numpy(np.stack([cv2.resize(im, (128, 128)) for im in imgs]))
    small = small.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    (b_gpu, s_gpu), (b_cpu, s_cpu) = both("blazeface", small)
    _process_close("blazeface raw boxes", b_gpu, b_cpu)
    _process_close("blazeface raw scores", s_gpu, s_cpu)
    crops, lms_all = [], []
    anchors = generate_anchors()
    for im in imgs:
        det = detect_faces(nets["blazeface"][devs[0]], anchors, cv2.resize(im, (128, 128))[None])[0]
        if not len(det):
            _fail("[process] no face on a checked frame")
        y0, x0, y1, x1 = det[0, :4] * 128.0
        center, scale = bbox2cs(np.array([x0, y0, x1, y1]) * (PROCESS_SIZE / 128.0))
        crop = crop_affine(im, center, scale, (256, 256))
        crops.append((crop.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    hm_gpu, hm_cpu = both("hrnet", torch.from_numpy(np.stack(crops)).permute(0, 3, 1, 2))
    _process_close("hrnet heatmaps", hm_gpu, hm_cpu)
    c_gpu, v_gpu = decode_heatmaps(hm_gpu, sigma=2.0)
    c_cpu, v_cpu = decode_heatmaps(hm_cpu, sigma=2.0)
    _process_close("decoded landmarks (heatmap px)", c_gpu, c_cpu, rtol=0, atol=1e-3, scaled=False)
    _process_close("landmark scores", v_gpu, v_cpu)
    eyes = []
    for i, im in enumerate(imgs):
        lms = np.loadtxt(path("ori_imgs", f"{i:06d}.lms")).astype(np.float32)
        for sl in (slice(42, 48), slice(36, 42)):
            center, scale = pts2cs(lms[sl])
            crop = crop_affine(im, center, scale * 1.35, (48, 32))
            eyes.append(cv2.cvtColor(crop, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0)
    e_gpu, e_cpu = both("eye", torch.from_numpy(np.stack(eyes))[:, None])
    _process_close("eye heatmaps", e_gpu, e_cpu)
    _process_close("decoded eye landmarks (heatmap px)", decode_heatmaps(e_gpu, modulate=False)[0],
                   decode_heatmaps(e_cpu, modulate=False)[0], rtol=0, atol=1e-3, scaled=False)
    x = np.stack([(im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD for im in imgs])
    (p_gpu, _, _), (p_cpu, _, _) = both("bisenet", torch.from_numpy(x).permute(0, 3, 1, 2))
    _process_close("bisenet main logits", p_gpu, p_cpu)
    cls_gpu, cls_cpu = p_gpu.argmax(1).cpu(), p_cpu.argmax(1)
    top2 = p_cpu.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    flips = cls_gpu != cls_cpu
    print(f"[process] parsing classes: {int(flips.sum())} of {flips.numel()} pixels differ, "
          f"all at near-ties (top-two gap < 1e-4)" if flips.any() else
          f"[process] parsing classes: equal on all {flips.numel()} pixels", flush=True)
    if flips.any() and not bool((gap[flips] < 1e-4).all()):
        _fail("[process] parsing classes differ away from a near-tie")
    ref_mask = _imread(path("face_mask", f"{0:06d}.png"))[..., 0] != 0
    src, rect_s = mask_crop(imgs[0], ref_mask)
    tgt_mask = _imread(path("face_mask", f"{1:06d}.png"))[..., 0] != 0
    tar, rect_t = mask_crop(imgs[1], tgt_mask)
    params = np.array([[*rect_s, *rect_t]], np.int32)
    flows = [flow_on_crops(nets["raft"][dev], src[None], tar[None], params,
                           (PROCESS_SIZE, PROCESS_SIZE)) for dev in devs]
    _process_close("flow (px)", *flows, rtol=0, atol=1e-3, scaled=False)
    ids = sorted(int(os.path.basename(p).split(".")[0])
                 for p in glob.glob(path("ori_imgs", "*.lms")))
    lms = np.stack([np.loadtxt(path("ori_imgs", f"{i:06d}.lms")) for i in ids]).astype(np.float32)
    (got, loss_gpu), (want, loss_cpu) = [
        fit_landmarks(load_face3dmm(d.assets.face3dmm_dir, device=dev), lms,
                      (PROCESS_SIZE / 2.0,) * 2, n_iters=PROCESS_FIT_ITERS) for dev in devs]
    if float(got.focal[0]) != float(want.focal[0]):
        _fail(f"[process] {PROCESS_FIT_ITERS}-step fit: focal {float(got.focal[0])} on the card, "
              f"{float(want.focal[0])} on the cpu")
    for k in ("id", "exp", "euler", "trans"):
        _process_close(f"{PROCESS_FIT_ITERS}-step fit {k}", getattr(got, k), getattr(want, k),
                       rtol=1e-3, scaled=False)
    _process_close(f"{PROCESS_FIT_ITERS}-step fit loss", loss_gpu, loss_cpu, rtol=1e-3,
                   scaled=False)


def phase_process(card):
    """The preprocessing DAG (pipeline/driver.py), steps 2-11, on the card at
    dst_size PROCESS_SIZE over a seeded identity of PROCESS_FRAMES frames
    with seeded assets (write_process_assets: two biases raised in the saved
    checkpoints) and a full-size seeded 3DMM; the shipped widths, ref_id,
    crops, score threshold and iteration counts. Fails unless every step
    did work; then the card against the port's CPU path, and the directory
    through load_audface_dataset."""
    import tempfile

    import numpy as np

    from dfanerf_torch.data.dataset import load_audface_dataset
    from dfanerf_torch.pipeline.driver import PipelineDriver

    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        id_dir = os.path.join(root, "smoke")
        write_process_identity(id_dir)
        assets, raised = write_process_assets(os.path.join(root, "assets"), id_dir)
        print(f"[process] seeded identity: {PROCESS_FRAMES} frames {PROCESS_SIZE}x{PROCESS_SIZE}, "
              f"seeded assets and a 34650-point 3DMM in {time.time() - t0:.1f} s; biases raised "
              f"in the saved checkpoints: {raised}", flush=True)
        d = PipelineDriver(id_dir, assets, PROCESS_SIZE)
        steps = [(2, "landmarks", d.step_landmarks), (3, "parsing", d.step_parsing),
                 (4, "background", d.step_background), (5, "compose", d.step_compose),
                 (6, "flow", d.step_flow), (7, "track", d.step_track),
                 (8, "bundle adjust", d.step_bundle_adjust), (9, "transforms", d.step_transforms),
                 (10, "disentangle", d.step_disentangle), (11, "wav2exp", d.step_wav2exp)]
        seconds = {}
        for n, name, fn in steps:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds[n] = time.perf_counter() - t
            print(f"[process] step {n} {name}: {seconds[n]:.3f} s ({card})", flush=True)
        lm, pa, tr, ba = d.last_landmarks, d.last_parsing, d.last_track, d.last_ba
        heads = np.asarray(pa["head_pixels"])
        n_key = ba["keypoints"]
        print(f"[process] counts: {lm['detected']} of {lm['frames']} frames detected, "
              f"{lm['no_face']} without a face, {lm['low_score']} low-score, {lm['with_lms']} "
              f"with landmarks and eyes; head pixels a frame {heads.min()}-{heads.max()} "
              f"(mean {heads.mean():.0f} of {PROCESS_SIZE ** 2}); {n_key} mined keypoints; "
              f"winning focal {tr['focal']}, fit loss {tr['loss']:.6g}; bundle adjustment loss "
              f"{ba['loss_pts']:.6g} after the points, {ba['loss']:.6g} after the joint phase",
              flush=True)
        if lm["with_lms"] < 19 or lm["eyes"] != lm["with_lms"]:
            _fail(f"[process] step 2 landmarked {lm['with_lms']} frames (ref_id 18 needs 19)")
        if not ((heads > 0) & (heads < PROCESS_SIZE ** 2)).all():
            _fail("[process] step 3: a frame with no head or no background pixel")
        if n_key == 0:
            _fail("[process] step 6 mined no keypoint")
        if not (np.isfinite(tr["loss"]) and ba["loss"] < ba["loss_pts"]):
            _fail("[process] steps 7-8: the fit or bundle adjustment did not converge")
        sum_steps = sum(seconds.values())
        print(f"[process] steps 2-11: {sum_steps:.3f} s ({card})", flush=True)
        ds = load_audface_dataset(id_dir, f"{d.id}_aud.pt", f"{d.id}_64_32.pt", use_ba=True)
        n_lms = len(glob.glob(os.path.join(id_dir, "ori_imgs", "*.lms")))
        if ds.n_frames != n_lms or not np.isfinite(ds.poses).all():
            _fail(f"[process] load_audface_dataset: {ds.n_frames} frames")
        print(f"[process] load_audface_dataset: {ds.n_frames} frames "
              f"({len(ds.i_train)} train, {len(ds.i_val)} val), near/far from step 9", flush=True)
        t = time.time()
        _process_card_vs_cpu(d, assets)
        print(f"[process] card vs cpu checks {time.time() - t:.1f} s", flush=True)
    print(f"[process] phase {time.time() - t0:.1f} s", flush=True)


# phase_tracking_tools: photometric refinement with its splat, NMS, the
# landmark and distangler training tools, the legacy FaceNeRF and a gauss-PE
# training step, on the card against the port's CPU path.
PHOTO_FRAMES, PHOTO_SIZE, PHOTO_STEPS, PHOTO_LR = 4, 512, 50, 1e-2
PHOTO_GRID = (165, 210)  # the 34,650 points as a sheet: 165 x 210
# The refinement's objective is discontinuous: a pixel's validity (splat
# weight > 1e-4) and its bilinear cells flip with the points, and Adam's
# steps keep their size where a gradient is near zero, so chained steps
# amplify rounding. perf/photometric_spread.py measured it between runs
# that differ only in rounding: on the CPU, with the images times 1 + 1e-6 N
# the runs part from the third step on (euler 1e-6, 6.6e-5, 2.4e-4 at steps
# 3-5, over max(1, its scale)), and so does the card from the CPU (with
# --card); after 50 steps the CPU's runs (thread counts 4, 1, 2, 8; six
# perturbed image sets) lie up to PHOTO_SPREAD from the 4-thread run (the
# loss relative). So the first PHOTO_TIGHT_STEPS steps (the second with
# Adam's carried moments) are held card against CPU within PROCESS_TOL, and
# the PHOTO_STEPS-step runs' parameters and loss within twice PHOTO_SPREAD:
# two runs each within the spread of a third are within twice it of each
# other.
PHOTO_TIGHT_STEPS = 2
PHOTO_SPREAD = {"tex": 0.06515, "light": 0.3966, "euler": 0.1082, "trans": 0.4101,
                "loss": 0.01263}
NMS_BOXES = 300
TOOL_STEPS = 10        # heatmap and distangler train steps on the card


def _photometric_setup(device):
    """The seeded full-size 3DMM (phase_process's: 34,650 points, 100 id, 79
    expression dims, one texture row) with its mean shape laid out as a
    165 x 210 sheet facing the camera, triangulated over the grid, and
    PHOTO_FRAMES target frames rendered from a texture and a lighting the
    refinement starts away from. The seeded mean shape is a Gaussian cloud,
    not a surface: the soft z-buffer (weights exp(-50 dz / z)) would keep
    only its nearest points."""
    import numpy as np

    from dfanerf_torch.core.geometry import euler2rot, rot_trans_pts
    from dfanerf_torch.ops.splat import _splat
    from dfanerf_torch.pipeline import photometric as tp
    from dfanerf_torch.pipeline.face3dmm import make_synthetic_3dmm

    m = make_synthetic_3dmm(0, point_num=34650, id_dim=100, exp_dim=79, tex_dim=1, device="cpu")
    g1, g2 = PHOTO_GRID
    yy, xx = np.meshgrid(np.linspace(-100, 100, g1), np.linspace(-80, 80, g2), indexing="ij")
    mu = np.stack([xx, yy, 5 * np.sin(xx / 20) * np.cos(yy / 20)], -1).reshape(-1)
    m = dataclasses.replace(m, mu=torch.from_numpy(mu.astype(np.float32)))
    a = (np.arange(g1 - 1)[:, None] * g2 + np.arange(g2 - 1)[None, :]).ravel()
    tris = np.concatenate([np.stack([a, a + 1, a + g2], 1),
                           np.stack([a + 1, a + g2 + 1, a + g2], 1)])
    vert_tris = np.zeros(g1 * g2, np.int64)
    vert_tris[tris.ravel()] = np.repeat(np.arange(len(tris)), 3)
    rng = np.random.RandomState(0)
    F = PHOTO_FRAMES
    # expression codes small enough that the sheet stays a surface: a code
    # of 0.1 moves each vertex ~1 unit, about the grid's spacing
    exp = torch.from_numpy((rng.randn(F, 79) * 0.01).astype(np.float32))
    euler = torch.from_numpy((rng.randn(F, 3) * 0.05).astype(np.float32))
    trans = torch.tensor([[0.0, 0.0, -600.0]]).repeat(F, 1)
    light = torch.zeros(9, 3)
    light[0], light[3] = 2.5, 0.5
    tris_t, vt_t = torch.from_numpy(tris), torch.from_numpy(vert_tris)
    with torch.no_grad():
        rott = rot_trans_pts(tp.forward_geo(m, torch.zeros(F, 100), exp), euler2rot(euler), trans)
        vn = tp.compute_tri_normal(rott, tris_t)[:, vt_t]
        vis = tp.vertex_visibility(rott, vn)[..., None]
        shaded = tp.forward_tex(m, torch.tensor([[60.0]])) * (tp.sh9_basis(vn) @ light)
        far = torch.tensor([0.0, 0.0, -1e3])
        images, _, weight = _splat(rott * vis + (1 - vis) * far, shaded, 1200.0,
                                   (PHOTO_SIZE / 2, PHOTO_SIZE / 2), (PHOTO_SIZE, PHOTO_SIZE))
    covered = float((weight > 1e-4).float().mean())
    start = (euler + 0.01, trans + torch.tensor([1.0, -1.0, 2.0]))

    def on(dev):
        md = dataclasses.replace(m, **{k: getattr(m, k).to(dev) for k in (
            "base_id", "base_exp", "mu", "base_tex", "mu_tex", "sig_id", "sig_exp", "sig_tex")})
        return (md, tris, vert_tris, torch.zeros(100, device=dev), exp.to(dev),
                start[0].to(dev), start[1].to(dev), 1200.0, (PHOTO_SIZE / 2, PHOTO_SIZE / 2),
                images.to(dev))

    return on, covered, float(vis.mean())


def _oracle_nms(dets, thresh):
    """Greedy IoU suppression from its textbook definition, in numpy."""
    import numpy as np

    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(-scores, kind="stable")
    keep, suppressed = [], np.zeros(len(dets), bool)
    for a, i in enumerate(order):
        if suppressed[i]:
            continue
        keep.append(int(i))
        for j in order[a + 1:]:
            if not suppressed[j]:
                inter = (max(0, min(x2[i], x2[j]) - max(x1[i], x1[j]) + 1)
                         * max(0, min(y2[i], y2[j]) - max(y1[i], y1[j]) + 1))
                if inter / (areas[i] + areas[j] - inter) >= thresh:
                    suppressed[j] = True
    return keep


def phase_tracking_tools(card, ds):
    """The preprocessing tools outside the DAG, on the card against the
    port's CPU path: refine_photometric (PHOTO_FRAMES frames at PHOTO_SIZE)
    on the seeded full-size 3DMM, its first PHOTO_TIGHT_STEPS steps and
    PHOTO_STEPS steps (see PHOTO_SPREAD), timed per step; the
    masked NMS on the card and the host NMS (g++) on NMS_BOXES boxes with
    tied scores against a numpy oracle, exactly; TOOL_STEPS heatmap train
    steps on the eye net and one temporal sequence over two videos;
    TOOL_STEPS distangler train steps and the mouth-keypoint net in both
    modes; one legacy FaceNeRF forward; one float32 train step of a
    gauss-PE decoder on phase_train's scene."""
    import numpy as np

    from dfanerf_torch.models.legacy import FaceNeRF
    from dfanerf_torch.models.perception.ghostnet_eye import load_eye_net
    from dfanerf_torch.ops.nms import nms, nms_native
    from dfanerf_torch.pipeline import disentangle as td
    from dfanerf_torch.pipeline import landmark_training as tl
    from dfanerf_torch.pipeline.landmark_temporal import run_temporal_sequence
    from dfanerf_torch.pipeline.photometric import refine_photometric
    from dfanerf_torch.train.state import init_train_state
    from dfanerf_torch.train.step import dataset_to_device, make_train_step

    import threading

    t0 = time.time()
    on, covered, visible = _photometric_setup("cpu")
    tight = {tag: refine_photometric(*on(dev), n_iters=PHOTO_TIGHT_STEPS, lr=PHOTO_LR)
             for tag, dev in (("card", "cuda"), ("host", "cpu"))}
    for k in ("loss", "tex", "light", "euler", "trans"):
        _process_close(f"refine_photometric, first {PHOTO_TIGHT_STEPS} steps: {k}",
                       tight["card"][k], tight["host"][k], phase="tools")
    args = on("cuda")
    refine_photometric(*args, n_iters=2, lr=PHOTO_LR)  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = {"card": refine_photometric(*args, n_iters=PHOTO_STEPS, lr=PHOTO_LR)}
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / PHOTO_STEPS
    # the CPU's 50 steps run on a thread while the card takes the next checks
    host_args = on("cpu")

    def host_refine():
        try:
            out["host"] = refine_photometric(*host_args, n_iters=PHOTO_STEPS, lr=PHOTO_LR)
        except Exception as e:  # raised again in the main thread after the join
            out["host_error"] = e

    host_run = threading.Thread(target=host_refine)
    host_run.start()

    rng = np.random.RandomState(0)
    x1, y1 = rng.uniform(0, 400, (2, NMS_BOXES))
    w, h = rng.uniform(10, 120, (2, NMS_BOXES))
    dets = np.stack([x1, y1, x1 + w, y1 + h, rng.randint(0, 8, NMS_BOXES) / 8.0], 1)
    dets = dets.astype(np.float32)
    for thresh in (0.3, 0.5, 0.7):
        want = _oracle_nms(dets, thresh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = nms(torch.from_numpy(dets).cuda(), thresh)
        card_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        host = nms_native(dets, thresh)
        host_ms = (time.perf_counter() - t) * 1e3
        print(f"[tools] nms at IoU {thresh}: {len(want)} of {NMS_BOXES} boxes kept (8 score "
              f"levels, ties kept in index order); masked on the card {card_ms:.2f} ms, host "
              f"C++ {host_ms:.3f} ms (the first call builds it)", flush=True)
        if got != want or host != want:
            _fail(f"[tools] nms at IoU {thresh}: keep-lists differ from the oracle")

    # the eye net's heatmap step: the first step on the card against the CPU
    # from the same weights, then TOOL_STEPS steps on the card
    images = torch.from_numpy(rng.rand(8, 1, 32, 48).astype(np.float32))
    joints = torch.from_numpy(rng.uniform(2, 14, (8, 6, 2)).astype(np.float32))
    first, moved = {}, {}
    for tag, dev, n_steps in (("host", "cpu", 1), ("card", "cuda", TOOL_STEPS)):
        net = load_eye_net("random:0", device=dev)
        init, step = tl.make_heatmap_train_step(net, loss="mse", lr=1e-3)
        tensors = tl.trainable_tensors(net)
        opt = init(tensors)
        before = {k: v.clone() for k, v in tensors.items()}
        losses = []
        for _ in range(n_steps):
            losses.append(float(step(tensors, opt, images.to(dev), joints.to(dev))))
            if len(losses) == 1:
                moved[tag] = torch.cat([(tensors[k] - before[k]).flatten().cpu() for k in tensors])
        first[tag] = losses[0]
    agree = float((torch.sign(moved["card"]) == torch.sign(moved["host"])).float().mean())
    print(f"[tools] heatmap train step (eye net, seeded, 8 crops): first loss card "
          f"{first['card']:.6g}, cpu {first['host']:.6g}; the first step's updates agree in sign "
          f"on {100 * agree:.3f}% of {moved['card'].numel()} entries; {TOOL_STEPS} steps on the "
          f"card: "
          f"loss {losses[0]:.5g} -> {losses[-1]:.5g}", flush=True)
    if abs(first["card"] / first["host"] - 1) > PROCESS_TOL["rtol"] or agree < 0.999 \
            or not losses[-1] < losses[0]:
        _fail("[tools] the heatmap train step disagrees with the CPU or does not learn")

    conv = torch.nn.Conv2d(3 + 6, 6, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.rand(conv.weight.shape, generator=torch.Generator().manual_seed(2))
                          * 0.2 - 0.1)
    frames = torch.from_numpy(rng.rand(6, 3, 32, 48).astype(np.float32))
    vid = [0, 0, 0, 1, 1, 1]
    hms = {}
    for tag, dev in (("host", "cpu"), ("card", "cuda")):
        c = conv.to(dev)
        with torch.no_grad():
            hms[tag] = run_temporal_sequence(lambda x: torch.sigmoid(c(x[None])[0]),
                                             frames.to(dev), vid, 6)
    _process_close("run_temporal_sequence, 6 frames of 2 videos", hms["card"], hms["host"],
                   phase="tools")

    # the distangler's train step on the 3DMM's non-jaw landmarks
    from dfanerf_torch.pipeline.face3dmm import make_synthetic_3dmm

    m = make_synthetic_3dmm(0, point_num=34650, id_dim=100, exp_dim=79, tex_dim=1, device="cpu")
    lands = np.asarray(m.lands_info)[-51:]
    batches = [torch.from_numpy((rng.randn(64, 79) * 0.3).astype(np.float32))
               for _ in range(TOOL_STEPS)]
    aux = {}
    for tag, dev, n_steps in (("host", "cpu", 1), ("card", "cuda", TOOL_STEPS)):
        md = dataclasses.replace(m, **{k: getattr(m, k).to(dev) for k in (
            "base_id", "base_exp", "mu", "base_tex", "mu_tex", "sig_id", "sig_exp", "sig_tex")})
        init, step = td.make_disentangle_train_step(md, lands)
        params, opt = init(seed=0, device=dev)
        aux[tag] = [step(params, opt, b.to(dev), 1e-3) for b in batches[:n_steps]]
    for k in ("swap", "cycle", "total"):
        _process_close(f"distangler step 1 {k} loss", aux["card"][0][k], aux["host"][0][k],
                       phase="tools")
    totals = [float(a["total"]) for a in aux["card"]]
    print(f"[tools] distangler: {TOOL_STEPS} train steps on the card, total loss {totals[0]:.5g} "
          f"-> {totals[-1]:.5g}", flush=True)
    if not np.isfinite(totals).all():
        _fail("[tools] the distangler's losses are not finite")
    kp = td.MouthExp2KptsNet(num_hidden_layers=1)
    kp.input_bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)))
    x = torch.from_numpy(rng.randn(16, 32).astype(np.float32))
    for train in (False, True):
        with torch.no_grad():
            got = kp.cuda()(x.cuda(), train=train)
            want = kp.cpu()(x, train=train)
        _process_close(f"mouth_exp2kpts train={train}", got, want, phase="tools")

    fn = FaceNeRF(W=128, use_viewdirs=True)
    x = torch.from_numpy(rng.randn(4096, 82).astype(np.float32))
    with torch.no_grad():
        want = fn(x)
        got = fn.cuda()(x.cuda())
    _process_close("legacy FaceNeRF forward (viewdirs, 4096 points)", got, want, phase="tools")

    # a float32 train step of a gauss-PE decoder, card against CPU
    cfg = _recipe_cfg(compute_dtype="float32")
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               positional_encoding="gauss"),
                              train=dataclasses.replace(cfg.train, n_rand=PARITY_RAYS))
    batch = make_train_step(cfg, ds, device="cpu").draw_batch(torch.Generator().manual_seed(3))
    metrics = {}
    for tag, dev in (("host", "cpu"), ("card", "cuda")):
        st = init_train_state(cfg, seed=0, device=dev)
        b = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
        _, metrics[tag] = make_train_step(cfg, ds, device=dev).step_on_batch(
            st, dataset_to_device(ds, dev), b)
    rel = {k: abs(float(metrics["card"][k]) / float(metrics["host"][k]) - 1)
           for k in ("loss", "grad_norm")}
    print(f"[tools] gauss-PE train step ({PARITY_RAYS} rays, float32), card vs CPU: relative "
          f"differences {json.dumps(rel)}; loss {float(metrics['card']['loss']):.6g}", flush=True)
    if max(rel.values()) > 1e-4:
        _fail(f"[tools] the gauss-PE train step differs from the CPU's: {rel}")

    host_run.join()
    if "host_error" in out:
        raise out["host_error"]
    loss = {tag: float(out[tag]["loss"]) for tag in out}
    diffs = {k: float((out["card"][k].cpu() - out["host"][k]).abs().max())
             for k in ("tex", "light", "euler", "trans")}
    diffs["loss"] = abs(loss["card"] / loss["host"] - 1)
    print(f"[tools] refine_photometric: {PHOTO_FRAMES} frames {PHOTO_SIZE}x{PHOTO_SIZE}, 34650 "
          f"points ({100 * visible:.1f}% visible, {100 * covered:.1f}% of the pixels covered), "
          f"{PHOTO_STEPS} steps at lr {PHOTO_LR:g}: {step_ms:.3f} ms a step on the card (CUDA "
          f"events, warm); loss {float(tight['card']['loss']):.6g} at step {PHOTO_TIGHT_STEPS}, "
          f"after {PHOTO_STEPS}: card {loss['card']:.6g}, cpu {loss['host']:.6g}; card vs cpu "
          f"(the loss relative) {json.dumps({k: float(f'{v:.4g}') for k, v in diffs.items()})}, "
          f"bars twice {json.dumps(PHOTO_SPREAD)}; {card}", flush=True)
    if not all(np.isfinite(v) for v in loss.values()) \
            or any(not diffs[k] <= 2 * PHOTO_SPREAD[k] for k in PHOTO_SPREAD):
        _fail(f"[tools] refine_photometric's {PHOTO_STEPS} steps: card vs cpu {diffs}")
    print(f"[tools] phase {time.time() - t0:.1f} s", flush=True)


ZOO_BATCH = 16   # images a timed batch
ZOO_CHECK = 2    # of them, held against the port's CPU path
ZOO_SEED = 100
# the export round trip's architectures on the card, with the tool's kwargs
ZOO_EXPORTS = {"eye": {}, "face_ghostnet": {}, "u2net": {"out_ch": 68, "small": True}}


def _zoo_nets():
    """name -> (the port's net at the reference's default widths, one input's
    shape at the family's input size): the landmark zoo, plain PyTorch."""
    import functools

    from dfanerf_torch.models.perception import ghostnet_face as gf
    from dfanerf_torch.models.perception import mobilenet as mb
    from dfanerf_torch.models.perception import shufflenet as sh
    from dfanerf_torch.models.perception import u2net as u2
    from dfanerf_torch.models.perception import zoo_extra as z

    P = functools.partial
    face = (3, 256, 256)
    return {
        "MobileNetV2": (mb.MobileNetV2, (3, 224, 224)),
        "FaceMobilenetHeatmap": (mb.FaceMobilenetHeatmap, face),
        "FaceMobilenetGhostHead": (mb.FaceMobilenetGhostHead, face),
        "ShuffleNetV2 x1.0": (sh.ShuffleNetV2, (3, 224, 224)),
        "U2Net": (u2.U2Net, face),
        "U2NETP_S5": (P(u2.U2Net, 68, True), face),
        "FaceGhostNet": (gf.FaceGhostNet, face),
        "PoseResNet 50": (z.PoseResNet, face),
        "PoseFaceResNet 18": (z.PoseFaceResNet, face),
        "FaceMobilenetDReLU": (z.FaceMobilenetDReLU, face),
        "MobileHead": (P(z.MobileHead, 96, 68), (96, 16, 16)),
        "FaceMobilenetDenseReg": (z.FaceMobilenetDenseReg, face),
        "FaceMobilenet eyeBranch": (z.FaceMobilenetStaged, face),
        "FaceMobilenet mutiScale": (P(z.FaceMobilenetStaged, "mutiScale"), face),
        "FAN": (z.FAN, face),
        "MobileHRNet": (z.MobileHRNet, face),
        "EyeNetGeneral": (z.EyeNetGeneral, (1, 32, 48)),
        "EyeGhostnetRegress": (z.EyeGhostnetRegress, (1, 32, 48)),
        "PoseMobilenet": (P(z.PoseMobilenet, image_size=(256, 256)), face),
        "FaceMobilenetDeconv": (z.FaceMobilenetDeconv, face),
        "FaceMobilenetOld": (P(z.FaceMobilenetOld, image_size=(256, 256)), face),
        "CenterMobilenet": (z.CenterMobilenet, (3, 512, 512)),
    }


def _leaves(out):
    """The tensors of a net's output: dicts by key, sequences in order."""
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _leaves(v)]
    return [out]


@torch.no_grad()
def phase_zoo(card):
    """The landmark model zoo (mobilenet, shufflenet, u2net, ghostnet_face,
    zoo_extra), RAFT-basic with ImportanceWeights, and the landmark export:
    every family at the reference's default widths and its input size,
    seeded (on a worker thread, ahead of the card); the first ZOO_CHECK
    images of a ZOO_BATCH batch (drawn on the card) on the card against the
    port's CPU path, which runs on another worker thread meanwhile (TF32
    off; rtol 1e-4, atol 1e-5 per unit of each output's scale,
    _process_close), the batch timed with CUDA events once those threads
    are done (a warm call, then 3); RAFT-basic (12 iterations) on a 320x240 crop pair
    cut as step_flow cuts it (mask_crop) and ImportanceWeights at the
    crop's size; then ZOO_EXPORTS' architectures written from a seeded
    checkpoint by the export tool and read back onto the card with
    load_exported, bit for bit. No kernel of its own: convolutions through
    cuDNN."""
    import concurrent.futures
    import copy
    import queue
    import tempfile
    import threading

    import cv2
    import numpy as np

    from dfanerf_torch.compat.landmark_export import ARCHS, export, load_exported
    from dfanerf_torch.models.perception.common import seeded_init_
    from dfanerf_torch.models.perception.raft import ImportanceWeights, RAFTBasic, mask_crop

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        _fail("[zoo] TF32 is on: the card vs cpu checks need float32 convolutions")
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(ZOO_SEED)
    rows, card_out, cpu_out, on_card, jobs = {}, {}, {}, {}, queue.Queue()

    def cpu_worker():  # the CPU path of every net, beside the card's work
        try:
            while (job := jobs.get()) is not None:
                name, net, xs = job
                with torch.no_grad():
                    cpu_out[name] = _leaves(net(*xs))
        except BaseException as e:  # noqa: BLE001 -- raised after the join
            cpu_out["error"] = e

    worker = threading.Thread(target=cpu_worker)
    worker.start()

    def run(name, net, xc):
        net_c = copy.deepcopy(net).cuda()
        jobs.put((name, net, [x[:ZOO_CHECK].cpu() for x in xc]))
        card_out[name] = [t.cpu() for t in _leaves(net_c(*(x[:ZOO_CHECK] for x in xc)))]
        net_c(*xc)  # the batch's first call: cuDNN's choices
        on_card[name] = (net_c, xc)

    nets = _zoo_nets()
    seeder = concurrent.futures.ThreadPoolExecutor(1)  # seeds the next nets meanwhile
    built = [seeder.submit(lambda i=i, make=make: seeded_init_(make(), ZOO_SEED + i).eval())
             for i, (make, _) in enumerate(nets.values())]
    try:
        for (name, (_, shape)), net in zip(nets.items(), built):
            run(name, net.result(), [torch.randn(ZOO_BATCH, *shape, generator=gen, device="cuda")])

        # RAFT-basic on a crop pair cut as step_flow cuts it: a textured frame
        # and the same frame moved by (3, 5) px, the same face-like mask
        rng = np.random.RandomState(ZOO_SEED)
        frame = cv2.GaussianBlur(rng.uniform(0, 255, (512, 512, 3)).astype(np.float32), (0, 0), 3)
        moved = np.roll(frame, (3, 5), axis=(0, 1))
        mask = np.zeros((512, 512), np.uint8)
        cv2.ellipse(mask, (256, 250), (120, 160), 0, 0, 360, 1, -1)
        crops = [mask_crop(im, mask)[0] for im in (frame, moved)]  # [320, 240, 3] at 0..255
        pair = [torch.from_numpy(c).cuda().permute(2, 0, 1)[None].expand(ZOO_BATCH, -1, -1, -1)
                .contiguous() for c in crops]
        run("RAFT-basic (12 iterations, 320x240 crops)", seeded_init_(RAFTBasic(), 7).eval(), pair)
        feats = torch.randn(ZOO_BATCH, 128, 320, 240, generator=gen, device="cuda")
        run("ImportanceWeights (320x240)", seeded_init_(ImportanceWeights(), 8).eval(),
            [torch.cat(pair, 1) / 255.0, feats])
    finally:
        seeder.shutdown(cancel_futures=True)
        jobs.put(None)
        worker.join()
    if "error" in cpu_out:
        raise cpu_out["error"]
    # timed once the CPU threads are done: these nets launch many small
    # kernels, and a busy host would stretch their times
    for name, (net_c, xc) in on_card.items():
        rows[name] = _cuda_ms(lambda: net_c(*xc), 3)
        print(f"[zoo] {name}: {ZOO_BATCH} x {tuple(xc[0].shape[1:])} {rows[name]:.3f} ms a batch "
              f"on the card ({card})", flush=True)
    del on_card
    for name, got in card_out.items():
        want = cpu_out[name]
        if len(got) != len(want):
            _fail(f"[zoo] {name}: {len(got)} outputs on the card, {len(want)} on the cpu")
        for i, (a, b) in enumerate(zip(got, want)):
            _process_close(f"{name}, output {i}", a, b, phase="zoo")

    # a seeded checkpoint -> export -> load_exported onto the card (the CPU
    # tests hold every architecture of the tool against the reference's)
    with tempfile.TemporaryDirectory() as d:
        for i, (arch, kw) in enumerate(ZOO_EXPORTS.items()):
            sd = seeded_init_(ARCHS[arch].seeded(kw), ZOO_SEED + i).state_dict()
            pth, npz = os.path.join(d, f"{arch}.pth"), os.path.join(d, f"{arch}.npz")
            torch.save(sd, pth)
            export(arch, pth, npz, **kw)
            _, net = load_exported(npz)
            got = net.state_dict()
            if next(net.parameters()).device.type != "cuda" or set(got) != set(sd) or not all(
                    torch.equal(got[k].cpu(), v) for k, v in sd.items()):
                _fail(f"[zoo] export -> load_exported of {arch}: not the checkpoint on the card")
    print(f"[zoo] export -> load_exported on the card: {', '.join(ZOO_EXPORTS)} bit for bit",
          flush=True)
    print(f"[zoo] phase {time.time() - t0:.1f} s; ms a batch of {ZOO_BATCH}: "
          f"{json.dumps({k: round(v, 3) for k, v in rows.items()})} ({card})", flush=True)


def _entry(name, source, replaces, launches, err, ms, plain_ms, flops, n_bytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda", "source": f"dfanerf_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}


def _mark(phase: str) -> None:
    print(f"[time] {phase} done, {time.perf_counter() - T_START:.1f} s since the start",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dfanerf_torch")):
        print("chip_smoke: dfanerf_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    phase_build()
    _mark("phase_build")
    phase_kernel_vs_plain()
    _mark("phase_kernel_vs_plain")
    phase_pair_kernels_vs_plain()
    _mark("phase_pair_kernels_vs_plain")
    kernel, dense_ops = phase_main_path()
    _mark("phase_main_path")
    phase_pair_vs_dense(dense_ops)
    _mark("phase_pair_vs_dense")
    del dense_ops
    pair_kernels, sp8 = phase_pair_main_path()
    _mark("phase_pair_main_path")
    phase_pair_prune()
    _mark("phase_pair_prune")
    pair2_errs, pair2_sp8 = phase_pair2_kernels_vs_plain(sp8)
    _mark("phase_pair2_kernels_vs_plain")
    pack2, _ = phase_pack2_main_path(sp8)
    _mark("phase_pack2_main_path")
    del sp8
    for entry in pack2:
        # the largest error of the kernel's checks: on the main path and alone
        entry["max_abs_err"] = max(entry["max_abs_err"], pair2_errs[entry["name"]])
    phase_refresh_union()
    _mark("phase_refresh_union")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    cfg1_launches = phase_cfg1()
    _mark("phase_cfg1")
    cfg2_launches = phase_cfg2(card)
    _mark("phase_cfg2")
    av_launches = phase_audio_video(card)
    _mark("phase_audio_video")
    for entry in pair_kernels:
        # the pair path's launches and those of the cfg1, cfg2 and audio to
        # video paths
        entry["launches"] += (cfg1_launches[entry["name"]] + cfg2_launches[entry["name"]]
                              + av_launches[entry["name"]])
    phase_hier_kernels_vs_plain()
    _mark("phase_hier_kernels_vs_plain")
    hier_dense, noskip_frames = phase_hier_dense_main_path()
    _mark("phase_hier_dense_main_path")
    hier_pairs = phase_hier_pair_main_path(noskip_frames[:N_FRAMES])
    _mark("phase_hier_pair_main_path")
    del noskip_frames
    serve_errs = phase_serve_kernels_vs_plain()
    _mark("phase_serve_kernels_vs_plain")
    serve, serve_args, serve_noskip, _ = phase_serve_main_path()
    _mark("phase_serve_main_path")
    plain_launches, _ = phase_serve_plain_main_path(serve_args, serve_noskip)
    _mark("phase_serve_plain_main_path")
    del serve_noskip
    far_joint = phase_serve_epilogue_kernel_form(serve_args)
    _mark("phase_serve_epilogue_kernel_form")
    for entry in serve:
        # the largest error of the variant's checks: on the main path's
        # segment and in the kernel checks
        entry["max_abs_err"] = max(entry["max_abs_err"], serve_errs[entry["name"]])
        if entry["name"] == "render_rays_epilogue":
            entry["launches"] += plain_launches
    far_joint["max_abs_err"] = max(far_joint["max_abs_err"], serve_errs["far_joint"])
    missing = set(CLASS_VARIANTS) - {e["name"] for e in serve}
    if missing:
        _fail(f"the serving path ran no segment of {sorted(missing)}")
    train_launches, ds, trained = phase_train(card)
    _mark("phase_train")
    single_bg, ref_launches = phase_reference_ckpt(card, trained, ds)
    _mark("phase_reference_ckpt")
    del trained
    for entry in single_bg:
        entry["max_abs_err"] = max(entry["max_abs_err"], serve_errs[entry["name"]])
    kernel["launches"] += (train_launches + ref_launches + phase_config5(card, ds)
                           + av_launches["render_rays"])
    _mark("phase_config5")
    phase_process(card)
    _mark("phase_process")
    phase_tracking_tools(card, ds)
    _mark("phase_tracking_tools")
    phase_zoo(card)
    _mark("phase_zoo")
    print(f"[total] chip_smoke.py {time.perf_counter() - T_START:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel] + pair_kernels + pack2 + [pair2_sp8] + hier_dense
                      + hier_pairs + serve + [far_joint] + single_bg}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
