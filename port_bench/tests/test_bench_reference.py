"""The plain reference against the program's own float32 paths on the CPU at a
small size (the decoder, the signals, the dense and hierarchical frames, the
training loss), its gradient against finite differences, and its isolation:
it loads nothing of the program."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL
from port_bench import reference, serve, train
from port_bench.clip import make_clip
from port_bench.weights import calibrate, make_weights

MODEL = json.loads((ROOT / "port_bench" / "configs" / "dfa_head_torso.json").read_text())
HIER = json.loads((ROOT / "port_bench" / "configs" / "dfa_head_hier.json").read_text())


def program_params(model, params):
    from dfanerf_torch.config import ExperimentConfig
    from dfanerf_torch.train.state import Params

    cfg = ExperimentConfig.from_dict({"decoder": model["decoder"], "signal": model["signal"]})
    with torch.device("meta"):
        module = Params(cfg)
    module = module.to_empty(device="cpu")
    module.load_state_dict(params, strict=True)
    return cfg, module.requires_grad_(False)


@pytest.fixture(scope="module")
def weights():
    return make_weights(MODEL, 7, "cpu")


@pytest.mark.parametrize("branch", ["head", "torso"])
def test_field_matches_the_decoder(weights, branch):
    params, zs, za = weights
    _, module = program_params(MODEL, params)
    g = torch.Generator().manual_seed(1)
    pts, dirs = torch.rand(500, 3, generator=g) - 0.5, torch.randn(500, 3, generator=g)
    sig = torch.randn(96 if branch == "head" else 42, generator=g)
    k = 0 if branch == "head" else 1
    feat, sigma = module.decoder(pts, dirs, zs[k], za[k], sig, branch)
    rgb, raw = reference.field(params, MODEL["decoder"], branch, pts, dirs, sig, zs[k], za[k])
    _, raw = reference.field(params, MODEL["decoder"], branch, pts, dirs, sig, zs[k], za[k],
                             raw_sigma=True)
    assert torch.allclose(rgb, feat, atol=1e-6) and torch.allclose(raw, sigma, atol=1e-5)


def test_signals_match(weights):
    from dfanerf_torch.render.renderer import encode_frame_signals

    params, _, _ = weights
    cfg, module = program_params(MODEL, params)
    clip = make_clip(5, 32, 32, 32)
    auds, exps, poses, _ = serve.clip_tensors(clip, "cpu")
    for c in (0, 1, 17, 31):
        sig, sig_t = encode_frame_signals(module, auds, exps, poses, c, 32, cfg, True)
        ref, ref_t = serve.reference_signals(params, MODEL, clip, c, "cpu")
        assert torch.allclose(sig, ref, atol=1e-6) and torch.allclose(sig_t, ref_t, atol=1e-6)


@pytest.mark.parametrize("model,mix", [(MODEL, "shipped_serve"), (HIER, "pair_serve")])
def test_frames_match_the_unfused_renderers(model, mix):
    """The no-skip reference frame against the program's unfused float32
    renderer of the same weights and inputs."""
    from dfanerf_torch.render import renderer

    mix = json.loads((ROOT / "port_bench" / "traffic" / f"{mix}.json").read_text())
    size = dict(SMALL, render=dict(SMALL["render"], n_importance=16 if model is HIER else 0))
    st = serve.prepare(model, mix, 11, "cpu", size)
    cfg, module = program_params(st.model, st.params)
    cfg = type(cfg).from_dict({"decoder": st.model["decoder"], "signal": st.model["signal"],
                               "render": {"n_samples": 16, "n_importance": size["render"]
                                          ["n_importance"], "use_fused_kernel": False}})
    make = (renderer.make_head_hierarchical_renderer if model is HIER
            else renderer.make_frame_renderer)
    render = make(cfg, st.clip.hwfcxy, st.clip.near, st.clip.far, device="cpu")
    auds, exps, poses, bc = serve.clip_tensors(st.clip, "cpu")
    refs = dict(zip((3, 9), serve.no_skip_frames(st, [(3, 3), (9, 9)])))
    for c in (3, 9):
        sig, sig_t = renderer.encode_frame_signals(module, auds, exps, poses, c, 32, cfg, True)
        if model is HIER:
            got = render(module, st.z_shape, st.z_app, poses[c], sig, bc)
        else:
            got = render(module, st.z_shape, st.z_app, poses[c], poses[0], sig, sig_t, bc)[1]
        err = (got - refs[c][0]).abs()
        # the resample's inverse CDF can take the neighbouring bin where a
        # draw meets a bin edge to float32 rounding (the two sides build
        # their depths and draws with other roundings): one fine sample
        # moves and a pixel by up to ~1e-3; every other pixel agrees to ulps
        assert float((err > 2e-5).float().mean()) < 0.01 and err.max() < 2e-3, err.max()


MID = dict(SMALL, frame={"H": 64, "W": 64}, render={"n_samples": 64, "occ_grid_res": 24})


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 23])
def test_decisions_bracket_the_programs_flags(seed):
    """The reference's sure flags lie inside the program's refresh flags and
    these inside its maybe flags, at 16 tiles, for both fields."""
    mix = json.loads((ROOT / "port_bench" / "traffic" / "shipped_serve.json").read_text())
    st = serve.prepare(MODEL, mix, seed, "cpu", MID)
    prog = serve.Program(st)
    c = prog.frame_of(0)
    sig, sig_t = prog.renderer.encode_frame_signals(prog.module, prog.auds, prog.exps,
                                                    prog.poses, c, prog.n, prog.cfg, True)
    inputs = prog.render.inputs_fn(prog.module, prog.z_shape, prog.z_app, prog.poses[c],
                                   prog.poses[0], sig, sig_t, prog.bc)
    got = prog.render.stages["flags"](inputs).bool()
    clip = st.clip
    with reference.strict_float32():
        d = reference.decisions(st.params, MODEL["decoder"], st.render, serve._frame_inputs(st, c),
                                (clip.H, clip.W, clip.focal),
                                serve.margin(st), serve.load_path(ROOT, "tile_classes").BOX_EPS)
    for k, f in enumerate(("head", "torso")):
        sure, _, maybe = d[f]
        assert not (sure & ~got[k]).any() and not (got[k] & ~maybe).any()
        assert 0 < int(got[k].sum()) < got[k].numel()


def test_skip_frames_with_every_block_on_are_the_no_skip_frames():
    """With every block flagged and no prune, the skip-aware frames equal the
    no-skip frames and their bound U is 0."""
    mix = json.loads((ROOT / "port_bench" / "traffic" / "shipped_serve.json").read_text())
    st = serve.prepare(MODEL, mix, 5, "cpu", SMALL)
    clip = st.clip
    hwf = (clip.H, clip.W, clip.focal)
    fr = serve._frame_inputs(st, 6)
    T, J = 4, st.render["n_samples"] // reference.SLAB
    on = torch.ones((T, J), dtype=torch.bool)
    with reference.strict_float32():
        want = reference.head_torso_frame(st.params, MODEL["decoder"], st.render, fr, hwf)[1]
        got, u = reference.head_torso_skip_frame(st.params, MODEL["decoder"], st.render, fr,
                                                 {f: (on, on, on) for f in ("head", "torso")},
                                                 hwf)
    assert torch.allclose(got, want, atol=1e-5) and float(u.abs().max()) == 0.0
    rcfg = dict(st.render, n_importance=16, occ_prune_trans=0.0, occ_prune_contrib=0.0,
                occ_grid_res=4)
    grid = reference.Grid(torch.ones((8, 8, 8)), 0.0, 0.5, torch.full((3,), -10.0),
                          torch.full((3,), 20.0), 4)
    on_f = torch.ones((T, 2 * J), dtype=torch.bool)
    hs = {"grid": grid, "eps": 0.0, "coarse": (on, on, on), "list": (on_f, on_f, on_f)}
    with reference.strict_float32():
        want = reference.head_hier_frame(st.params, MODEL["decoder"], rcfg, fr, hwf)
        got, u = reference.head_hier_skip_frame(st.params, MODEL["decoder"], rcfg, fr, hs, hwf)
    assert torch.allclose(got, want, atol=1e-5) and float(u.abs().max()) == 0.0


def test_training_loss_matches_the_float32_step():
    mix = json.loads((ROOT / "port_bench" / "traffic" / "train.json").read_text())
    ts = train.prepare(dict(MODEL, render=dict(MODEL["render"], compute_dtype="float32")), mix,
                       13, "cpu", SMALL)
    prog = train.TrainProgram(ts)
    batches, got = train.program_side(prog, train.Batches(ts, 13), ts)
    numbers = train.check_numbers(train.reference_side(ts, batches), got)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad1_gap"] < 1e-4
    assert numbers["delta3_gap"] < 1e-3


def test_reference_gradient_is_the_loss_derivative():
    """Central differences in float64 against the reference's autograd, on
    the serving field's calibrated weights: on the plain init many densities
    sit at relu's kink, where the composite's colour mix is not smooth."""
    mix = json.loads((ROOT / "port_bench" / "traffic" / "train.json").read_text())
    ts = train.prepare(MODEL, mix, 17, "cpu", SMALL)
    calibrate(ts.params, ts.z_shape, ts.z_app,
              serve.reference_signals(ts.params, MODEL, ts.clip, 0, "cpu"), MODEL, ts.clip,
              dict(MODEL["assumed"]["field"], **SMALL["field"]), 0.5)
    batch = train.Batches(ts, 17)()
    batch["z_vals"] = batch["z_vals"].double()
    data = {k: v.double() if k in ("auds", "exps", "poses") else v
            for k, v in train.reference_data(ts).items()}
    P = {k: v.double() for k, v in ts.params.items()}
    zs, za = ts.z_shape.double(), ts.z_app.double()
    for name in ("decoder.sigma_out.bias", "decoder.blocks.6.bias", "audnet.fc3.bias"):
        Pg = dict(P, **{name: P[name].clone().requires_grad_()})
        g, = torch.autograd.grad(reference.train_loss(Pg, ts.model, data, batch, zs, za), [Pg[name]])
        eps = 1e-6
        up, dn = P[name].clone(), P[name].clone()
        up.view(-1)[0] += eps
        dn.view(-1)[0] -= eps
        fd = (float(reference.train_loss(dict(P, **{name: up}), ts.model, data, batch, zs, za))
              - float(reference.train_loss(dict(P, **{name: dn}), ts.model, data, batch, zs, za))
              ) / (2 * eps)
        assert abs(fd - float(g.view(-1)[0])) <= 1e-6 + 1e-4 * abs(fd)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference, port_bench.clip, port_bench.weights, port_bench.counts\n"
            "bad = {k.split('.')[0] for k in sys.modules} & {'dfanerf_torch', 'dfanerf_tpu',"
            " 'jax', 'jaxlib', 'flax'}\n"
            "print(sorted(bad))\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
