"""Carry the reference package's parameters across to the port.

The reference keeps parameters as nested dicts and lists of arrays
({"w", "b"} leaves); the port keeps them in ``nn.Module``s whose submodule
names are the same keys. Conversion, given the tree as numpy arrays:

- a path of dict keys and list indices becomes a state-dict key joined by
  '.': ["decoder"]["blocks"][3]["w"] -> "decoder.blocks.3.weight";
- a Linear ``w`` [in, out] becomes ``weight`` [out, in];
- a conv1d ``w`` [k, c_in, c_out] (HIO) becomes ``weight`` [c_out, c_in, k];
- ``b`` becomes ``bias``.

The conversion is exact (a transpose), so the inverse recovers the tree
bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.device import resolve_device
from dfanerf_torch.train.state import Params, TrainState

_LEAF = {"w": "weight", "b": "bias"}
_LEAF_INV = {v: k for k, v in _LEAF.items()}


def _to_torch_weight(w: np.ndarray) -> np.ndarray:
    if w.ndim == 2:
        return w.T
    if w.ndim == 3:
        return w.transpose(2, 1, 0)
    raise ValueError(f"unexpected weight rank {w.ndim}")


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
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
        node[_LEAF_INV[leaf]] = np.ascontiguousarray(arr)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def state_from_jax(jax_state: Dict[str, Any], cfg: ExperimentConfig, device=None) -> TrainState:
    """A reference-package train state (as numpy arrays) -> the port's state
    on ``device`` (default CUDA; see device.resolve_device). The optimizer
    moments are not carried across."""
    device = resolve_device(device)
    with torch.device("meta"):
        params = Params(cfg)
    params = params.to_empty(device="cpu")
    params.load_state_dict(params_to_state_dict(jax_state["params"]), strict=True)
    return {
        "params": params.to(device),
        "z_shape": torch.from_numpy(np.array(jax_state["z_shape"], np.float32)).to(device),
        "z_app": torch.from_numpy(np.array(jax_state["z_app"], np.float32)).to(device),
        "step": int(np.asarray(jax_state["step"])),
    }
