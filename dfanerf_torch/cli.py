"""Command line of the port (counterpart of dfanerf_tpu/cli.py):

    python -m dfanerf_torch.cli process --id-dir dataset/obama --step N [--variant ba|nonba]
                                        [--assets assets.json] [--video v.mp4] [--dst-size 512]
    python -m dfanerf_torch.cli train  --datadir dataset/obama [--aud-file aud.pt]
                                       [--exp-file exp.pt] [--config cfg.json] [--n-iters N]
                                       [--legacy-config dataset/obama/HeadNeRF_config_ba.txt]
    python -m dfanerf_torch.cli render --datadir dataset/obama --ckpt runs/x/000100.npz
                                       [--test-file transforms_val.json] [--video]

``--synthetic`` instead of ``--datadir`` takes the built-in synthetic scene
(40 frames, 128x128). An identity directory loads through
data/dataset.py load_audface_dataset; ``render --test-file`` renders its
driving manifest (poses and audio features, no targets). Both run on CUDA
unless ``--device cpu`` is given. ``render`` writes the composite and the
head-only frames as binary PPM (``render_com/`` and ``render_head/``,
``test_{i:06d}.ppm``) and, with ``--video``, a YUV4MPEG2 video
``<expname>.y4m``: formats that numpy alone writes.

``process`` runs one step of the preprocessing DAG (pipeline/driver.py):
-1..11 of the BA variant or 0..6 of the non-BA one. ``--assets`` is a json
of ``PipelineAssets`` fields, each a checkpoint path or ``random:<seed>``;
steps -1, 0 and 1 need ``ffmpeg`` on the PATH. ``--legacy-config`` takes
near and far from the config txt that step 9 writes. ``bench`` waits for
the port's benchmark (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def _build_parser():
    p = argparse.ArgumentParser(prog="dfanerf_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("process", help="run one preprocessing step")
    pp.add_argument("--id-dir", required=True)
    pp.add_argument("--step", type=int, required=True,
                    help="-1..11 (ba variant) or 0..6 (nonba variant)")
    pp.add_argument("--video", default=None)
    pp.add_argument("--dst-size", type=int, default=512)
    pp.add_argument("--assets", default=None, help="json file of PipelineAssets fields")
    pp.add_argument("--variant", choices=("ba", "nonba"), default="ba",
                    help="ba = the 12-step process_data_ba.py DAG; nonba = the 7-step "
                         "AD-NeRF-style process_data.py DAG")
    pp.add_argument("--device", default=None, help="cuda (default) or cpu")

    tp = sub.add_parser("train", help="train the conditioned NeRF")
    tp.add_argument("--config", default=None, help="ExperimentConfig json")
    tp.add_argument("--datadir", default=None)
    tp.add_argument("--legacy-config", default=None,
                    help="pipeline-generated HeadNeRF_config_ba.txt (near/far)")
    tp.add_argument("--aud-file", default=None)
    tp.add_argument("--exp-file", default=None)
    tp.add_argument("--expname", default=None)
    tp.add_argument("--n-iters", type=int, default=None)
    tp.add_argument("--resume", default="auto")
    tp.add_argument("--synthetic", action="store_true",
                    help="train on the built-in synthetic scene (no assets)")
    tp.add_argument("--device", default=None, help="cuda (default) or cpu")

    rp = sub.add_parser("render", help="render frames and video from a checkpoint")
    rp.add_argument("--config", default=None)
    rp.add_argument("--datadir", default=None)
    rp.add_argument("--expname", default=None)
    rp.add_argument("--ckpt", required=True)
    rp.add_argument("--test-file", default=None,
                    help="driving manifest (the reference's --test_file mode)")
    rp.add_argument("--out", default="render_out")
    rp.add_argument("--video", action="store_true")
    rp.add_argument("--synthetic", action="store_true")
    rp.add_argument("--device", default=None, help="cuda (default) or cpu")

    sub.add_parser("bench", help="run the benchmark (not ported)")
    return p


def _load_cfg(args):
    from dfanerf_torch.config import ExperimentConfig, parse_legacy_config_file

    cfg = ExperimentConfig.from_json(args.config) if args.config else ExperimentConfig()
    updates = {k: getattr(args, k) for k in ("datadir", "expname", "aud_file", "exp_file")
               if getattr(args, k, None)}
    if getattr(args, "legacy_config", None):
        near, far = parse_legacy_config_file(args.legacy_config)
        updates["render"] = dataclasses.replace(cfg.render, near=near, far=far)
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _load_dataset(cfg, args, device):
    if args.synthetic:
        from dfanerf_torch.data.synthetic import make_synthetic_dataset

        return make_synthetic_dataset(n_frames=40, H=128, W=128, device=device)
    from dfanerf_torch.data.dataset import load_audface_dataset

    return load_audface_dataset(cfg.datadir, cfg.aud_file, cfg.exp_file, use_ba=cfg.use_ba,
                                testskip=cfg.testskip, all_speaker=cfg.all_speaker,
                                test_file=getattr(args, "test_file", None))


def cmd_process(args):
    from dfanerf_torch.pipeline.driver import PipelineAssets, PipelineDriver

    assets = PipelineAssets()
    if args.assets:
        with open(args.assets) as f:
            assets = PipelineAssets(**json.load(f))
    d = PipelineDriver(args.id_dir, assets, args.dst_size, device=args.device)
    video = args.video or os.path.join(args.id_dir, f"{d.id}_25fps.mp4")
    table = d.nonba_steps(video) if args.variant == "nonba" else d.ba_steps(video, args.video)
    print(f"[process:{args.variant}] step {args.step}")
    table[args.step]()
    print(f"[process:{args.variant}] step {args.step} done")


def cmd_train(args):
    from dfanerf_torch.device import resolve_device
    from dfanerf_torch.train.loop import train_loop

    dev = resolve_device(args.device)
    cfg = _load_cfg(args)
    ds = _load_dataset(cfg, args, dev)
    train_loop(cfg, ds, n_iters=args.n_iters, resume=args.resume, device=dev)


def cmd_render(args):
    from dfanerf_torch.device import resolve_device
    from dfanerf_torch.render.audio_video import write_ppm, write_y4m
    from dfanerf_torch.render.renderer import render_video_frames
    from dfanerf_torch.train.checkpoint import load_checkpoint
    from dfanerf_torch.train.state import init_train_state
    from dfanerf_torch.train.step import dataset_to_device

    dev = resolve_device(args.device)
    cfg = _load_cfg(args)
    ds = _load_dataset(cfg, args, dev)
    state = load_checkpoint(args.ckpt, init_train_state(cfg, seed=0, device=dev))
    data = dataset_to_device(ds, dev)
    frames, frames_head = render_video_frames(
        state, data, cfg, ds.hwfcxy, ds.near, ds.far, list(range(ds.n_frames)),
        use_smoothing=state["step"] >= cfg.signal.nosmo_iters, device=dev)
    # the composite and the head-only frames, as the reference's render writes them
    for sub, stack in (("render_com", frames), ("render_head", frames_head)):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
        for i, fr in enumerate(stack):
            write_ppm(os.path.join(args.out, sub, f"test_{i:06d}.ppm"), fr)
    if args.video:
        path = os.path.join(args.out, f"{cfg.expname}.y4m")
        write_y4m(path, frames, fps=25)
        print(f"[render] wrote {path}")
    print(f"[render] wrote {len(frames)} frames to {args.out}")


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.cmd == "train":
        cmd_train(args)
    elif args.cmd == "render":
        cmd_render(args)
    elif args.cmd == "process":
        cmd_process(args)
    else:
        raise NotImplementedError(
            "bench: the port's benchmark is not written yet (ROADMAP.md queue 1, item 3)")


if __name__ == "__main__":
    main()
