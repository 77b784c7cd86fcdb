"""Carry the reference package's parameters across to the port.

The reference keeps parameters as nested dicts and lists of arrays
({"w", "b"} leaves); the port keeps them in ``nn.Module``s whose submodule
names are the same keys. Conversion, given the tree as numpy arrays:

- a path of dict keys and list indices becomes a state-dict key joined by
  '.': ["decoder"]["blocks"][3]["w"] -> "decoder.blocks.3.weight";
- a Linear ``w`` [in, out] becomes ``weight`` [out, in];
- a conv1d ``w`` [k, c_in, c_out] (HIO) becomes ``weight`` [c_out, c_in, k];
- a conv2d ``w`` [kh, kw, c_in, c_out] (HWIO) becomes ``weight``
  [c_out, c_in, kh, kw] (OIHW);
- ``b`` becomes ``bias``.

The wav2exp encoder's tree (``{"blocks": [{"w", "b", "bn": {"gamma", "beta",
"mean", "var"}}]}``) converts with ``audio_encoder_state_dict`` to the
reference's ``audio_encoder.pth`` keys.

The conversion is exact (a transpose), so the inverse recovers the tree
bit for bit. The optimizer moments of a group are trees of the same layout
as its parameters (``opt/<group>/m/...``), converted the same way, and the
counters ``t`` and ``step`` are int32 scalars in the reference's tree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.device import resolve_device
from dfanerf_torch.train.optim import adam_init
from dfanerf_torch.train.state import OPT_GROUPS, Params, TrainState

_LEAF = {"w": "weight", "b": "bias"}
_LEAF_INV = {v: k for k, v in _LEAF.items()}


# weight axes, reference layout -> torch layout, by rank
_WEIGHT_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
# BatchNorm2d leaves, reference -> torch
_BN_LEAF = {"gamma": "weight", "beta": "bias", "mean": "running_mean", "var": "running_var"}


def _to_torch_weight(w: np.ndarray) -> np.ndarray:
    if w.ndim not in _WEIGHT_AXES:
        raise ValueError(f"unexpected weight rank {w.ndim}")
    return w.transpose(_WEIGHT_AXES[w.ndim])


def _to_jax_weight(w: np.ndarray) -> np.ndarray:
    return w.transpose(np.argsort(_WEIGHT_AXES[w.ndim]))


def params_to_state_dict(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict/list tree of numpy arrays -> flat state dict of tensors."""
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        key = str(key)
        if isinstance(val, (dict, list, tuple)):
            out.update(params_to_state_dict(val, f"{prefix}{key}."))
        elif key in _LEAF:
            arr = np.asarray(val)
            if key == "w":
                arr = _to_torch_weight(arr)
            out[prefix + _LEAF[key]] = torch.tensor(arr)
        else:
            raise ValueError(f"unexpected leaf {prefix}{key}")
    return out


def state_dict_to_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of params_to_state_dict: numbered path parts become lists."""
    tree: Dict[str, Any] = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            arr = _to_jax_weight(arr)
        node[_LEAF_INV[leaf]] = np.ascontiguousarray(arr)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def audio_encoder_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference package's wav2exp encoder params (numpy) -> the state
    dict of pipeline/audio/wav2exp.py AudioEncoder, which is the
    reference's ``audio_encoder.pth`` layout."""
    sd: Dict[str, torch.Tensor] = {}
    for i, block in enumerate(tree["blocks"]):
        pre = f"audio_encoder.{i}.conv_block"
        sd[f"{pre}.0.weight"] = torch.tensor(_to_torch_weight(np.asarray(block["w"])))
        sd[f"{pre}.0.bias"] = torch.tensor(np.asarray(block["b"]))
        for leaf, name in _BN_LEAF.items():
            sd[f"{pre}.1.{name}"] = torch.tensor(np.asarray(block["bn"][leaf]))
        sd[f"{pre}.1.num_batches_tracked"] = torch.tensor(0)
    return sd


def state_from_jax(jax_state: Dict[str, Any], cfg: ExperimentConfig, device=None) -> TrainState:
    """A reference-package train state (as numpy arrays) -> the port's state
    on ``device`` (default CUDA; see device.resolve_device), the optimizer
    moments included; a state without ``opt`` gets fresh ones."""
    device = resolve_device(device)
    with torch.device("meta"):
        params = Params(cfg)
    return load_state_tree(jax_state, params.to_empty(device="cpu"), device)


def load_state_tree(tree: Dict[str, Any], params: Params, device) -> TrainState:
    """A reference-layout state tree loaded into ``params`` (in place, every
    key required) and moved to ``device``, with its moments, latents and
    step."""
    params.load_state_dict(params_to_state_dict(tree["params"]), strict=True)
    params = params.to(device)
    opt = {}
    for name, _, _ in OPT_GROUPS:
        group = getattr(params, name)
        if name not in tree.get("opt", {}):
            opt[name] = adam_init(group)
            continue
        o = tree["opt"][name]
        names = [n for n, _ in group.named_parameters()]
        moments = {}
        for k in ("m", "v"):
            sd = params_to_state_dict(o[k])
            if sorted(sd) != sorted(names):
                raise ValueError(f"opt/{name}/{k}: keys {sorted(set(sd) ^ set(names))} differ "
                                 "from the group's parameters")
            moments[k] = {n: sd[n].to(device) for n in names}
        opt[name] = {**moments, "t": int(np.asarray(o["t"]))}
    return {
        "params": params,
        "opt": opt,
        "z_shape": torch.from_numpy(np.array(tree["z_shape"], np.float32)).to(device),
        "z_app": torch.from_numpy(np.array(tree["z_app"], np.float32)).to(device),
        "step": int(np.asarray(tree["step"])),
    }


def state_to_jax(state: TrainState) -> Dict[str, Any]:
    """The inverse of state_from_jax: the reference package's state tree as
    numpy arrays (params and moments float32, t and step int32)."""
    return {
        "params": state_dict_to_params(state["params"].state_dict()),
        "opt": {name: {"m": state_dict_to_params(o["m"]), "v": state_dict_to_params(o["v"]),
                       "t": np.asarray(o["t"], np.int32)}
                for name, o in state["opt"].items()},
        "z_shape": state["z_shape"].detach().cpu().numpy(),
        "z_app": state["z_app"].detach().cpu().numpy(),
        "step": np.asarray(state["step"], np.int32),
    }
