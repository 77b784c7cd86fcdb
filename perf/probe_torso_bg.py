"""Where the torso-only render with the background in the kernel
(render_rays <0,1,1>) departs from its plain version, on one NVIDIA GPU.

    python3 perf/probe_torso_bg.py

Without the head field the composite's final sample is the torso colour at
the far plane, which carries the transmittance left before that sample, so
a pixel whose torso is clear along the ray is that one colour. The probe
runs chip_smoke.py's phases that hold <0,1,1> against its plain version
(phase_serve_kernels_vs_plain on the serving path's seeded weights,
phase_train then phase_reference_ckpt on the trained full-width state),
records the operands they give it, and on each set of operands splits the
composite into the part before the final sample and that sample's colour:

- ``ct_k``: the kernel's final-sample colour, (its composite minus the
  epilogue form's sums on the same rays, whose final sample is a no-op)
  over the epilogue form's transmittance; ``ct_p`` the same of the plain
  version;
- ``ct_fk``, ``ct_fr``: the far-plane torso kernel (far_torso) and its
  plain version on the same rays, weights and view bias;
- controls, each the plain version's arithmetic changed in one place:
  ``f32`` activations not rounded to bf16 (how far bf16 itself is from
  the field), ``lo`` every product's float32 result rounded to bf16 before
  its bias (one rounding more than the kernel makes), ``z-1`` the colour
  one sample short of the far plane.

Prints, for the pixels whose transmittance before the final sample is
0.05 or more, the largest, mean and 99.9th-percentile difference of each
pair, the number above 5e-4, and the worst pixels' values, beside the
card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the phases that give <0,1,1> its operands)
from dfanerf_torch.ops import fused_render  # noqa: E402
from dfanerf_torch.ops.far_eval import far_torso_kernel, far_torso_reference  # noqa: E402
from dfanerf_torch.ops.fused_render import (  # noqa: E402
    _deform, _mm_kernel, _slot_tables, _trunk, pe_replicate, render_rays_kernel,
)

FAR_CARRIED = 0.05
ROWS = 65536


def _mm_f32(x, w):
    return x.float() @ w.float()


def _mm_lo(x, w):
    return _mm_kernel(x, w).to(torch.bfloat16).float()


def _torso_colour(pw, o, d, z, vr, mm, round_pe=True):
    """The torso colour at depth z of rays o, d [n, 3] with view bias vr
    [n, 256], products through ``mm``; the PE rounded to bf16 as the kernel
    rounds it, or kept in float32."""
    freq, phase = _slot_tables(o.device)
    out = []
    for a in range(0, o.shape[0], ROWS):
        pts = o[a:a + ROWS] + d[a:a + ROWS] * z
        pe = torch.sin(pe_replicate(pts) * freq + phase)
        if round_pe:
            pe = pe.to(torch.bfloat16)
        sf = _trunk(pw, _deform(pw, pe, mm), mm)
        net = torch.relu(sf[:, 128:384] + vr[a:a + ROWS].float())
        out.append(torch.sigmoid(mm(net, pw["w_out"]) + pw["b_out"])[:, :3])
    return torch.cat(out)


def _row(name, diff, mask):
    e = diff.abs().amax(dim=-1)[mask]
    if not e.numel():
        return f"  {name:<28} no pixels"
    q = float(torch.quantile(e[torch.randperm(e.numel(), device=e.device)[:100000]], 0.999))
    return (f"  {name:<28} max {float(e.max()):.3e} mean {float(e.mean()):.3e} p99.9 {q:.3e} "
            f"above 5e-4 {int((e > 5e-4).sum())}")


@torch.no_grad()
def diagnose(label, ops, n, plain):
    got = render_rays_kernel(ops)
    ref = plain(ops)
    dists = [x.clone() for x in (ops.dists_h, ops.dists_t)]
    for x in dists:
        x[-1] = 0.0
    occ = ops.occ.clone()
    occ[:, -1] = 1  # the last slab runs, as the background form forces it
    epi = dataclasses.replace(ops, bg_epilogue=True, dists_h=dists[0], dists_t=dists[1],
                              occ=occ)
    ek, ep = render_rays_kernel(epi), plain(epi)
    torch.cuda.synchronize()
    t_p = ref[4][:n]
    mask = t_p >= FAR_CARRIED
    com_k, com_p = got[1][:n], ref[1][:n]
    ct_k = (com_k - ek[1][:n]) / ek[4][:n, None]
    ct_p = (com_p - ep[1][:n]) / ep[4][:n, None]
    pw, vr = ops.packed_t, ops.vr_t[:n]
    o, d = ops.rays_o_t[:n], ops.rays_d_t[:n]
    z = ops.z_vals[-1]
    ct_fk = far_torso_kernel(pw, o, d, float(z), vr, act=ops.act)
    ct_fr = far_torso_reference(pw, o, d, float(z), vr, ops.act)
    ct_32 = _torso_colour(pw, o, d, z, vr, _mm_f32, round_pe=False)
    ct_lo = _torso_colour(pw, o, d, z, vr, _mm_lo)
    ct_z1 = far_torso_reference(pw, o, d, float(ops.z_vals[-2]), vr, ops.act)
    torch.cuda.synchronize()
    print(f"[{label}] {n} pixels, {int(mask.sum())} with t_far >= {FAR_CARRIED} (max t_far "
          f"{float(t_p.max()):.4f}); before the final sample: epilogue sums kernel vs plain max "
          f"{float((ek[1][:n] - ep[1][:n]).abs().max()):.3e}, transmittance max "
          f"{float((ek[4][:n] - ep[4][:n]).abs().max()):.3e}, plain t_far vs plain epilogue "
          f"{'bit-equal' if torch.equal(t_p, ep[4][:n]) else 'DIFFERENT'}", flush=True)
    for name, diff in (("composite kernel - plain", com_k - com_p),
                       ("ct_k - ct_p", ct_k - ct_p), ("ct_fk - ct_fr", ct_fk - ct_fr),
                       ("ct_k - ct_fk", ct_k - ct_fk), ("ct_p - ct_fr", ct_p - ct_fr),
                       ("control f32: ct_fr - ct_32", ct_fr - ct_32),
                       ("control lo: ct_fr - ct_lo", ct_fr - ct_lo),
                       ("control z-1: ct_fr - ct_z1", ct_fr - ct_z1),
                       ("ct_k - ct_32", ct_k - ct_32)):
        print(_row(name, diff, mask), flush=True)
    err = (com_k - com_p).abs().amax(dim=-1)
    for i in err.argsort(descending=True)[:6].tolist():
        vals = {k: [round(float(v), 6) for v in x[i]] for k, x in (
            ("k", ct_k), ("p", ct_p), ("fk", ct_fk), ("fr", ct_fr), ("f32", ct_32))}
        print(f"  pixel {i}: com err {float(err[i]):.3e} t_far {float(t_p[i]):.4f} ct {vals}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torso_bg: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}", flush=True)
    plain = fused_render.fused_render_rays_reference
    seen = []

    def record(ops):
        if ops.fields == "torso" and not ops.bg_epilogue:
            seen.append(ops)
        return plain(ops)

    fused_render.fused_render_rays_reference = record
    try:
        chip_smoke.phase_build()
        for phase, args in ((chip_smoke.phase_serve_kernels_vs_plain, ()),
                            (chip_smoke.phase_reference_ckpt, None)):
            if args is None:
                _, ds, trained = chip_smoke.phase_train(card)
                args = (card, trained, ds)
            try:
                phase(*args)
            except SystemExit as e:  # the check this probe looks into
                print(f"[probe] {phase.__name__}: {e}", flush=True)
    finally:
        fused_render.fused_render_rays_reference = plain
    # the first: the serving path's flags case; the last: the reference ckpt's frame 0
    for label, ops in (("serving weights, flags with gaps", seen[0]),
                       ("trained, reference ckpt frame 0", seen[-1])):
        diagnose(label, ops, chip_smoke.H * chip_smoke.W, plain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
