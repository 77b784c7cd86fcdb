"""Test settings of the benchmark: the repository root on the path, a small
CPU size for whole runs, and the card fixture of tests marked ``card``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A whole run on the CPU: 32x32 frames (4 tiles), 16 samples, a 16-node grid,
# the probe every 4th pixel, two warm frames, 256 rays a training step.
SMALL = {"frame": {"H": 32, "W": 32}, "render": {"n_samples": 16, "occ_grid_res": 16},
         "field": {"probe_stride": 4}, "warm_frames": 2, "warm_steps": 1, "n_rand": 256}
SMALL_HIER = dict(SMALL, render={"n_samples": 16, "n_importance": 16, "occ_grid_res": 16})


@pytest.fixture
def card():
    """The CUDA device of a test marked ``card``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    """Few intra-op threads: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
