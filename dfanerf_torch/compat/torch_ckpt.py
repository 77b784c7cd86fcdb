"""Read the PyTorch reference's checkpoints into the port (port of
dfanerf_tpu/compat/torch_ckpt.py).

The reference saves a 10-entry dict ``{:06d}.tar`` every ``--i_weights``
iterations (run_nerf_com_trainExpLater.py:1099-1115): the state dicts of
the Decoder, AudioNet_W2L, ExpressionEnc and the two AudioAttNets, the
fixed latents z_shape and z_app [1, 2 * n_obj, z], and global_step. The
port's modules keep torch's weight layouts (Linear [out, in], Conv1d
[out, in, k]), and its decoder's submodules carry the reference's names,
so each converter maps key names only. Every tensor is a copy in float32:
a converted tensor never shares storage with the state dict it came from,
so a later in-place update of the source cannot reach it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dfanerf_torch.device import resolve_device

StateDict = Dict[str, torch.Tensor]


def _copy(x) -> torch.Tensor:
    """A float32 CPU copy of a tensor or array, never a view of it."""
    if torch.is_tensor(x):
        return x.detach().to(device="cpu", dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(sd: Mapping[str, Any], name: str, to: str = None) -> StateDict:
    """Linear or Conv1d ``name`` of a reference state dict, as ``to``'s keys
    (torch's Conv1d layout [out, in, k] is the port's too)."""
    to = name if to is None else to
    return {f"{to}.weight": _copy(sd[f"{name}.weight"]), f"{to}.bias": _copy(sd[f"{name}.bias"])}


def _seq_lin(sd: Mapping[str, Any], prefix: str) -> StateDict:
    """Every Linear of a ModuleList ``prefix.{i}``, in index order."""
    idxs = sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in sd
                   if k.startswith(prefix + ".")})
    out: StateDict = {}
    for i in idxs:
        out.update(_lin(sd, f"{prefix}.{i}"))
    return out


def deformation_field_from_torch(sd: Mapping[str, Any], prefix: str = "deform_net") -> StateDict:
    """The reference's DeformationField_ori entries under ``prefix``."""
    out: StateDict = {}
    for name in ("blocks_embed", "blocks_signal", "fc_embed_skips", "fc_signal_skips"):
        out.update(_seq_lin(sd, f"{prefix}.{name}"))
    for name in ("out_embed", "out_signal"):
        out.update(_lin(sd, f"{prefix}.{name}"))
    return out


def decoder_from_torch(sd: Mapping[str, Any]) -> StateDict:
    """The reference ``Decoder``'s state dict -> models/decoder.py Decoder's.
    fc_z, the skip lists, blocks_view, the deformation net, expnet and
    w2lnet are taken where the checkpoint holds them (reference :70-100)."""
    out: StateDict = {}
    for name in ("fc_in", "fc_in_listener", "fc_in_torso", "sigma_out", "fc_z_view", "feat_view",
                 "fc_view", "feat_out"):
        out.update(_lin(sd, name))
    out.update(_seq_lin(sd, "blocks"))
    if "fc_z.weight" in sd:
        out.update(_lin(sd, "fc_z"))
    for name in ("fc_z_skips", "fc_p_skips", "fc_p_skips_listener", "fc_p_skips_torso",
                 "blocks_view"):
        if f"{name}.0.weight" in sd:
            out.update(_seq_lin(sd, name))
    if "deform_net.blocks_embed.0.weight" in sd:
        out.update(deformation_field_from_torch(sd))
    for name in ("expnet", "w2lnet"):
        if f"{name}.weight" in sd:
            out.update(_lin(sd, name))
    return out


def audionet_w2l_from_torch(sd: Mapping[str, Any]) -> StateDict:
    """AudioNet_W2L's ``encoder.{0,2,4}`` -> AudioNetW2L's fc1-fc3."""
    return {**_lin(sd, "encoder.0", "fc1"), **_lin(sd, "encoder.2", "fc2"),
            **_lin(sd, "encoder.4", "fc3")}


def expression_enc_from_torch(sd: Mapping[str, Any]) -> StateDict:
    """ExpressionEnc's ``encoder.{0,2}`` -> fc1, fc2."""
    return {**_lin(sd, "encoder.0", "fc1"), **_lin(sd, "encoder.2", "fc2")}


def audionet_ds_from_torch(sd: Mapping[str, Any]) -> StateDict:
    """The DeepSpeech AudioNet's ``encoder_conv.{0,2,4,6}`` and
    ``encoder_fc1.{0,2}`` -> AudioNet's conv1-conv4, fc1, fc2."""
    out: StateDict = {}
    for i, k in enumerate((0, 2, 4, 6)):
        out.update(_lin(sd, f"encoder_conv.{k}", f"conv{i + 1}"))
    return {**out, **_lin(sd, "encoder_fc1.0", "fc1"), **_lin(sd, "encoder_fc1.2", "fc2")}


def audio_attnet_from_torch(sd: Mapping[str, Any]) -> StateDict:
    """AudioAttNet's ``attentionConvNet.{0,2,4,6,8}`` and ``attentionNet.0``
    -> conv1-conv5, att_fc."""
    out: StateDict = {}
    for i, k in enumerate((0, 2, 4, 6, 8)):
        out.update(_lin(sd, f"attentionConvNet.{k}", f"conv{i + 1}"))
    return {**out, **_lin(sd, "attentionNet.0", "att_fc")}


# the checkpoint's entries of each optional net: (params key, converter)
_NETS = {"network_AudNet_state_dict": ("audnet", audionet_w2l_from_torch),
         "network_ExpNet_state_dict": ("expnet", expression_enc_from_torch),
         "network_AudAttNet_state_dict": ("audattnet", audio_attnet_from_torch),
         "network_PoseAttNet_state_dict": ("poseattnet", audio_attnet_from_torch)}


def load_reference_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """A reference ``{:06d}.tar`` with every network converted, on ``device``
    (default CUDA): global_step (int), z_shape and z_app [1, 2 * n_obj, z],
    and the state dicts decoder, audnet, expnet, audattnet, poseattnet. A net
    the checkpoint lacks is left out, as the reference's tolerant resume
    (:553-580) leaves it. The file holds tensors and ints only, so it loads
    with ``weights_only=True``."""
    dev = resolve_device(device)
    state = torch.load(path, map_location="cpu", weights_only=True)

    def put(sd):
        return {k: v.to(dev) for k, v in sd.items()}

    out: Dict[str, Any] = {
        "global_step": int(state["global_step"]),
        "z_shape": _copy(state["z_shape"]).to(dev),
        "z_app": _copy(state["z_app"]).to(dev),
        "decoder": put(decoder_from_torch(state["network_decoder_state_dict"])),
    }
    for entry, (key, convert) in _NETS.items():
        if entry in state:
            out[key] = put(convert(state[entry]))
    return out


def reference_train_state(ckpt: Dict[str, Any], cfg, seed: int = 0, device=None):
    """A port train state (train/state.py) holding a loaded reference
    checkpoint, for the renderers: each net the checkpoint holds replaces
    the seeded one (its keys must be the configuration's), the others keep
    ``init_train_state``'s seeded weights; the latents drop the checkpoint's
    leading axis, [2 * n_obj, z] as the train state keeps them; the step is
    the checkpoint's."""
    from dfanerf_torch.train.state import init_train_state

    dev = resolve_device(device)
    state = init_train_state(cfg, seed=seed, device=dev)
    for key in ("decoder", "audnet", "expnet", "audattnet", "poseattnet"):
        if key in ckpt:
            getattr(state["params"], key).load_state_dict(ckpt[key], strict=True)
    for key in ("z_shape", "z_app"):
        state[key] = ckpt[key][0].to(dev).clone()
    state["step"] = int(ckpt["global_step"])
    return state
