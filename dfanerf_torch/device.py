"""Where the port's entry points run: CUDA unless the caller asks otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, which must then be available; no silent CPU path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the plain version")
        return torch.device("cuda")
    return torch.device(device)
