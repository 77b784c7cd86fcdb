"""Landmark nets to and from a flat npz deployment artifact (port of
tools/export_landmark_model.py, the counterpart of the reference's
tools/export_onnx_model.py): named arrays in the reference package's
parameter-tree layout plus a JSON header naming the architecture, loadable
with numpy alone.

    python -m dfanerf_torch.compat.landmark_export hrnet face_lms.pth out.npz
    python -m dfanerf_torch.compat.landmark_export eye eye_lms_6kpts.pth out.npz
    python -m dfanerf_torch.compat.landmark_export hrnet random:0 out.npz   # smoke

``export`` takes a checkpoint path or ``random:<seed>`` (the port's net,
``seeded_init_``) and writes the arrays and ``__header__`` the reference's
tool writes: from the same checkpoint, the same names and the same bits
(the state dict -> tree converters below are numpy mirrors of the
reference's ``*_from_torch``). ``load_exported`` reads such an npz,
whichever package wrote it, and returns (header, the port's net in eval
mode on its device): the tree goes back through the port's
``*_state_dict_from_jax``. Entries the reference stores as None (HRNet's
missing transitions and fuses, MobileNetV2's plan) are object arrays in the
npz; they are read as None from their headers, never unpickled.
"""

from __future__ import annotations

import json
import sys
import zipfile
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dfanerf_torch.device import resolve_device
from dfanerf_torch.models.perception import ghostnet_eye, ghostnet_face, hrnet, mobilenet
from dfanerf_torch.models.perception import shufflenet, u2net
from dfanerf_torch.models.perception.common import seeded_init_

Tree = Dict[str, Any]


# --- state dict -> the reference's tree (numpy) ----------------------------------------


def _np(sd: Mapping, name: str) -> np.ndarray:
    return np.array(sd[name].detach().cpu().numpy(), np.float32)


def _conv(sd: Mapping, name: str) -> Tree:
    p = {"w": np.ascontiguousarray(_np(sd, f"{name}.weight").transpose(2, 3, 1, 0))}
    if f"{name}.bias" in sd:
        p["b"] = _np(sd, f"{name}.bias")
    return p


def _bn(sd: Mapping, name: str) -> Tree:
    return {"gamma": _np(sd, f"{name}.weight"), "beta": _np(sd, f"{name}.bias"),
            "mean": _np(sd, f"{name}.running_mean"), "var": _np(sd, f"{name}.running_var")}


def _convbn(sd: Mapping, cname: str, bname: str) -> Tree:
    return {"conv": _conv(sd, cname), "bn": _bn(sd, bname)}


def _lin(sd: Mapping, name: str) -> Tree:
    return {"w": np.ascontiguousarray(_np(sd, f"{name}.weight").T), "b": _np(sd, f"{name}.bias")}


def hrnet_tree(sd: Mapping) -> Tree:
    """``hrnet_from_torch``: the stage layout and the head read off the keys."""
    cfg = hrnet.hrnet_config_from_state_dict(sd)

    def block(prefix, bottleneck=False):
        p = {"conv1": _conv(sd, f"{prefix}.conv1"), "bn1": _bn(sd, f"{prefix}.bn1"),
             "conv2": _conv(sd, f"{prefix}.conv2"), "bn2": _bn(sd, f"{prefix}.bn2")}
        if bottleneck:
            p["conv3"] = _conv(sd, f"{prefix}.conv3")
            p["bn3"] = _bn(sd, f"{prefix}.bn3")
        if f"{prefix}.downsample.0.weight" in sd:
            p["downsample"] = _convbn(sd, f"{prefix}.downsample.0", f"{prefix}.downsample.1")
        return p

    p: Tree = {"conv1": _conv(sd, "conv1"), "bn1": _bn(sd, "bn1"), "conv2": _conv(sd, "conv2"),
               "bn2": _bn(sd, "bn2"),
               "layer1": [block(f"layer1.{i}", bottleneck=True) for i in range(4)]}
    prev_n = 1
    for sname, (n_mod, n_br, n_blocks, _) in (("stage2", cfg.stage2), ("stage3", cfg.stage3),
                                              ("stage4", cfg.stage4)):
        tname = f"transition{int(sname[-1]) - 1}"
        trans = []
        for i in range(n_br):
            if i < prev_n:
                trans.append({"convbn": _convbn(sd, f"{tname}.{i}.0", f"{tname}.{i}.1")}
                             if f"{tname}.{i}.0.weight" in sd else None)
            else:
                seq, j = [], 0
                while f"{tname}.{i}.{j}.0.weight" in sd:
                    seq.append(_convbn(sd, f"{tname}.{i}.{j}.0", f"{tname}.{i}.{j}.1"))
                    j += 1
                trans.append({"down": seq})
        p[tname] = trans
        mods = []
        for m in range(n_mod):
            branches = [[block(f"{sname}.{m}.branches.{b}.{k}") for k in range(n_blocks[b])]
                        for b in range(n_br)]
            n_rows = sum(1 for i in range(n_br)
                         if any(k.startswith(f"{sname}.{m}.fuse_layers.{i}.") for k in sd))
            fuse = []
            for i in range(n_rows):
                row = []
                for j in range(n_br):
                    base = f"{sname}.{m}.fuse_layers.{i}.{j}"
                    if j == i:
                        row.append(None)
                    elif j > i:
                        row.append({"up": _convbn(sd, f"{base}.0", f"{base}.1")})
                    else:
                        row.append({"down": [_convbn(sd, f"{base}.{k}.0", f"{base}.{k}.1")
                                             for k in range(i - j)]})
                fuse.append(row)
            mods.append({"branches": branches, "fuse": fuse})
        p[sname] = mods
        prev_n = n_br
    if cfg.head == "pose":
        p["final"] = _conv(sd, "final_layer")
    else:
        p["head"] = {"conv1": _conv(sd, "head.0"), "bn1": _bn(sd, "head.1"),
                     "conv2": _conv(sd, "head.3")}
    return p


def ghost_tree(sd: Mapping) -> Tree:
    """``eye_net_from_torch`` / ``face_ghostnet_from_torch``: the eye
    net's layout, its depth read off the keys."""
    def ghost(prefix):
        return {"primary": _convbn(sd, f"{prefix}.primary_conv.0", f"{prefix}.primary_conv.1"),
                "cheap": _convbn(sd, f"{prefix}.cheap_operation.0",
                                 f"{prefix}.cheap_operation.1")}

    def bottleneck(prefix):
        p = {"ghost1": ghost(f"{prefix}.conv.0")}
        if f"{prefix}.conv.1.0.weight" in sd:
            p["dw"] = _convbn(sd, f"{prefix}.conv.1.0", f"{prefix}.conv.1.1")
        if f"{prefix}.conv.2.fc.0.weight" in sd:
            p["se"] = {"fc1": _lin(sd, f"{prefix}.conv.2.fc.0"),
                       "fc2": _lin(sd, f"{prefix}.conv.2.fc.2")}
        p["ghost2"] = ghost(f"{prefix}.conv.3")
        if f"{prefix}.shortcut.0.0.weight" in sd:
            p["shortcut"] = {"dw": _convbn(sd, f"{prefix}.shortcut.0.0", f"{prefix}.shortcut.0.1"),
                             "pw": _convbn(sd, f"{prefix}.shortcut.1", f"{prefix}.shortcut.2")}
        return p

    def count(prefix, step, start):
        n = 0
        while f"{prefix}.{start + step * n}.conv.0.primary_conv.0.weight" in sd:
            n += 1
        return n

    return {"stem": _convbn(sd, "features.0.0", "features.0.1"),
            "features": [bottleneck(f"features.{i + 1}") for i in range(count("features", 1, 1))],
            "head": [bottleneck(f"head.{2 * i + 1}") for i in range(count("head", 2, 1))],
            "final": _conv(sd, "final_layer")}


def mobilenet_tree(sd: Mapping, width_mult: float = 1.0) -> Tree:
    """``mobilenet_v2_from_torch`` (torchvision's ``features`` keys)."""
    plan, _ = mobilenet._block_plan(width_mult)
    blocks = []
    for fi, spec in enumerate(plan):
        base = f"features.{fi}"
        if spec[0] in ("stem", "last"):
            blocks.append({"kind": spec[0], "convbn": _convbn(sd, f"{base}.0", f"{base}.1")})
            continue
        b: Tree = {"kind": "ir"}
        ci = 0
        if spec[4] != 1:
            b["expand"] = _convbn(sd, f"{base}.conv.0.0", f"{base}.conv.0.1")
            ci = 1
        b["dw"] = _convbn(sd, f"{base}.conv.{ci}.0", f"{base}.conv.{ci}.1")
        b["project"] = _convbn(sd, f"{base}.conv.{ci + 1}", f"{base}.conv.{ci + 2}")
        blocks.append(b)
    return {"blocks": blocks, "plan": None}


def u2net_tree(sd: Mapping, out_ch: int = 68, small: bool = False) -> Tree:
    """``u2net_from_torch``."""
    stages = u2net.U2NETP_S5_STAGES if small else u2net.U2NET_STAGES
    decode = u2net.U2NETP_S5_DECODE if small else u2net.U2NET_DECODE

    def reb(prefix):
        return {"conv": _conv(sd, f"{prefix}.conv_s1"), "bn": _bn(sd, f"{prefix}.bn_s1")}

    def rsu(prefix, depth):
        n_enc = 4 if depth == "F" else depth
        return {"in": reb(f"{prefix}.rebnconvin"),
                "enc": [reb(f"{prefix}.rebnconv{i + 1}") for i in range(n_enc)],
                "dec": [reb(f"{prefix}.rebnconv{n_enc - 1 - i}d") for i in range(n_enc - 1)]}

    n = len(stages)
    return {"stages": [rsu(f"stage{i + 1}", d) for i, (d, *_r) in enumerate(stages)],
            "decode": [rsu(f"stage{n - 1 - i}d", d) for i, (d, *_r) in enumerate(decode)],
            "sides": [_conv(sd, f"side{i + 1}") for i in range(n)],
            "fuse": _conv(sd, "outconv")}


def shufflenet_tree(sd: Mapping, preset: str = "x1.0") -> Tree:
    """``shufflenet_v2_from_torch``."""
    repeats, _ = shufflenet.PRESETS[preset]

    def convbn(base, ci, bi):
        return _convbn(sd, f"{base}.{ci}", f"{base}.{bi}")

    def block(prefix, stride):
        p = {}
        if stride > 1:
            p["branch1"] = {"dw": convbn(f"{prefix}.branch1", 0, 1),
                            "pw": convbn(f"{prefix}.branch1", 2, 3)}
        p["branch2"] = {"pw1": convbn(f"{prefix}.branch2", 0, 1),
                        "dw": convbn(f"{prefix}.branch2", 3, 4),
                        "pw2": convbn(f"{prefix}.branch2", 5, 6)}
        return p

    p: Tree = {"conv1": convbn("conv1", 0, 1)}
    for si, rep in enumerate(repeats):
        p[f"stage{si + 2}"] = [block(f"stage{si + 2}.{bi}", 2 if bi == 0 else 1)
                               for bi in range(rep)]
    p["conv5"] = convbn("conv5", 0, 1)
    p["fc"] = _lin(sd, "fc")
    return p


# --- the architectures ------------------------------------------------------------------


def _shape(sd, name, dim=0):
    return int(sd[name].shape[dim])


class Arch(NamedTuple):
    module: str                                   # the reference's module, for the header
    build: Callable[[Mapping, dict], torch.nn.Module]  # (state dict, kwargs) -> the port's net
    seeded: Callable[[dict], torch.nn.Module]     # kwargs -> the net a random: export seeds
    tree: Callable[..., Tree]                     # (state dict, **kwargs) -> the reference's tree
    state_dict: Callable[..., dict]               # (tree, **kwargs) -> the port's state dict


_REF = "dfanerf_tpu.models.perception."
ARCHS: Dict[str, Arch] = {
    "hrnet": Arch(_REF + "hrnet", lambda sd, kw: hrnet.HRNet(hrnet.hrnet_config_from_state_dict(sd)),
                  lambda kw: hrnet.HRNet(hrnet.HRNetConfig()), lambda sd, **kw: hrnet_tree(sd),
                  lambda t, **kw: hrnet.hrnet_state_dict_from_jax(t)),
    "pose_hrnet": Arch(_REF + "hrnet",
                       lambda sd, kw: hrnet.HRNet(hrnet.hrnet_config_from_state_dict(sd)),
                       lambda kw: hrnet.HRNet(hrnet.pose_hrnet_config()),
                       lambda sd, **kw: hrnet_tree(sd),
                       lambda t, **kw: hrnet.hrnet_state_dict_from_jax(t)),
    "eye": Arch(_REF + "ghostnet_eye", lambda sd, kw: ghostnet_eye.EyeNet(),
                lambda kw: ghostnet_eye.EyeNet(), lambda sd, **kw: ghost_tree(sd),
                lambda t, **kw: ghostnet_eye.eye_net_state_dict_from_jax(t)),
    "mobilenet": Arch(_REF + "mobilenet",
                      lambda sd, kw: mobilenet.MobileNetV2(kw.get("width_mult", 1.0)),
                      lambda kw: mobilenet.MobileNetV2(kw.get("width_mult", 1.0)),
                      lambda sd, width_mult=1.0, **kw: mobilenet_tree(sd, width_mult),
                      lambda t, width_mult=1.0, **kw:
                      mobilenet.mobilenet_v2_state_dict_from_jax(t, width_mult)),
    "u2net": Arch(_REF + "u2net",
                  lambda sd, kw: u2net.U2Net(_shape(sd, "outconv.weight"), kw.get("small", False)),
                  lambda kw: u2net.U2Net(kw.get("out_ch", 68), kw.get("small", False)),
                  u2net_tree, lambda t, **kw: u2net.u2net_state_dict_from_jax(t)),
    "face_ghostnet": Arch(
        _REF + "ghostnet_face",
        lambda sd, kw: ghostnet_face.FaceGhostNet(_shape(sd, "final_layer.weight"),
                                                  kw.get("addition_encoder"),
                                                  kw.get("addition_decoder", False)),
        lambda kw: ghostnet_face.FaceGhostNet(kw.get("num_joints", 68), kw.get("addition_encoder"),
                                              kw.get("addition_decoder", False)),
        lambda sd, **kw: ghost_tree(sd),
        lambda t, **kw: ghostnet_face.face_ghostnet_state_dict_from_jax(t)),
    "shufflenet": Arch(
        _REF + "shufflenet",
        lambda sd, kw: shufflenet.ShuffleNetV2(kw.get("preset", "x1.0"), _shape(sd, "fc.weight")),
        lambda kw: shufflenet.ShuffleNetV2(kw.get("preset", "x1.0"), kw.get("num_classes", 1000)),
        lambda sd, preset="x1.0", **kw: shufflenet_tree(sd, preset),
        lambda t, **kw: shufflenet.shufflenet_v2_state_dict_from_jax(t)),
}


# --- the npz ------------------------------------------------------------------------------


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _unflatten(flat: Mapping[str, Any]) -> Tree:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def export(arch: str, src: str, out_path: str, **kwargs) -> None:
    """Write ``arch``'s net from a checkpoint path or ``random:<seed>`` to
    ``out_path`` as the reference's tool does."""
    a = ARCHS[arch]
    if src.startswith("random:"):
        net = seeded_init_(a.seeded(kwargs), int(src.split(":", 1)[1] or 0))
        sd = net.state_dict()
    else:
        sd = torch.load(src, map_location="cpu")
    flat = _flatten(a.tree(sd, **kwargs))
    header = json.dumps({"arch": arch, "module": a.module, "n_arrays": len(flat),
                         "kwargs": kwargs})
    np.savez(out_path, __header__=np.frombuffer(header.encode(), np.uint8), **flat)
    print(f"exported {len(flat)} arrays -> {out_path}")


def _holds_objects(zf: zipfile.ZipFile, member: str) -> bool:
    """Whether an npz member is an object array (read from its .npy header)."""
    with zf.open(member) as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return read(f)[2].hasobject


def read_npz(path: str) -> Tuple[dict, Tree]:
    """(header, tree of numpy arrays; object entries as None)."""
    flat = {}
    with zipfile.ZipFile(path) as zf, np.load(path, allow_pickle=False) as data:
        for name in data.files:
            flat[name] = None if _holds_objects(zf, f"{name}.npy") else data[name]
    header = json.loads(bytes(flat.pop("__header__")).decode())
    return header, _unflatten(flat)


def load_exported(path: str, device=None) -> Tuple[dict, torch.nn.Module]:
    """An exported npz -> (header, the port's net with its arrays, in eval mode
    on ``device``, default CUDA)."""
    dev = resolve_device(device)
    header, tree = read_npz(path)
    a, kwargs = ARCHS[header["arch"]], header.get("kwargs", {})
    sd = a.state_dict(tree, **kwargs)
    net = a.build(sd, kwargs)
    net.load_state_dict(sd)
    return header, net.eval().to(dev)


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    export(argv[0], argv[1], argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
