"""Checkpoints (port of dfanerf_tpu/train/checkpoint.py): the whole train
state as a compressed npz of the reference package's flat keys and layouts
(``params/decoder/blocks/0/w`` as [in, out], ``opt/<group>/m/...``,
``opt/<group>/t``, ``z_shape``, ``z_app``, ``step``), so that each package
loads the other's files. Loading is tolerant as the reference's is: a key
missing from the file keeps the template's value, a key the template lacks
is ignored.
"""

from __future__ import annotations

import copy
import glob
import os
import re
from typing import Any, Dict, Optional

import numpy as np

from dfanerf_torch.compat.from_jax import load_state_tree, state_to_jax
from dfanerf_torch.train.state import TrainState


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _restore(tree: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    """``tree`` with each leaf whose key is in ``flat`` replaced by its value."""
    if isinstance(tree, dict):
        return {k: _restore(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_restore(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return flat.get(prefix[:-1], tree)


def save_checkpoint(path: str, state: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_flatten(state_to_jax(state)))


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """A new state of ``template``'s shape and device with the file's values."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"  # np.savez appends .npz to a path without it
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = _restore(state_to_jax(template), flat)
    params = copy.deepcopy(template["params"])
    return load_state_tree(tree, params, template["z_shape"].device)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``{step:06d}.npz`` in a run directory, or None."""
    best, best_step = None, -1
    for p in glob.glob(os.path.join(ckpt_dir, "*.npz")):
        m = re.match(r"(\d+)\.npz$", os.path.basename(p))
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best
