"""The last two instantiations of the render kernel, one field with the
background in the kernel (``fused_render_rays(fields="head" | "torso")``
without ``bg_epilogue``): the port's plain version on the CPU against the
reference package's fused_render_rays in Pallas interpret mode, on the
setup of tests/test_torch_fused_render.py (full-width decoder, 300 rays).

The left-out field counts as sigma 0 and rgb 0, and the background rules of
the final sample still apply (reference fused_render.py:297-306): the head
colour there is the background pixel, the head stack's density gets its
1e-6 bump and the composite's torso density becomes 1e-6. So without the
head the head stack's last sample is the background, whose alpha is ~1 at
the 1e10 last distance: the head output is the background pixel times a
transmittance that only the 1e-6 bumps decay. The last slab always runs.

Measured against the reference here: head-only max 9.4e-6 and mean
3.8e-7 on both outputs (as fields="both"); torso-only, head max 1.4e-6,
composite max 1.09e-4 and mean 1.87e-6. Without the head the composite's
last sample is the torso's far-plane colour, which carries most of each
ray, so a bf16 rounding that flips in the torso trunk shows undiluted, as
in that file's saturating case. Bars: max 2e-4 (that file's) and mean 4e-6
(about twice the torso composite's), and tests/test_ops.py:97-99's (head
max 2e-2, head mean 2e-3, composite mean 5e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_render import _packs, _run_both, _to_torch, setup  # noqa: F401

from dfanerf_torch.ops.fused_render import (
    RENDER_VARIANTS, fused_render_rays_reference, prepare_render_operands,
)


MAX_ERR, MEAN_ERR = 2e-4, 4e-6
OPS_BARS = {"head_max": 2e-2, "head_mean": 2e-3, "com_mean": 5e-3}  # tests/test_ops.py:97-99


def _check(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        err = np.abs(g - r)
        assert err.max() < MAX_ERR and err.mean() < MEAN_ERR, (err.max(), err.mean())
    head_err, com_err = (np.abs(g - r) for g, r in zip(got, ref))
    assert head_err.max() < OPS_BARS["head_max"] and head_err.mean() < OPS_BARS["head_mean"]
    assert com_err.mean() < OPS_BARS["com_mean"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module, as the other render files are
    in the six-worker suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fields", ["head", "torso"])
def test_single_field_with_background_matches_interpret_kernel(setup, fields):  # noqa: F811
    got, ref = _run_both(setup, jnp.bfloat16, 300, 16, fields=fields)
    _check(got, ref)
    if fields == "torso":
        # the head stack is the background pixel, decayed only by the bumps
        np.testing.assert_allclose(got[0], setup["bc"][:300], atol=1e-3)


@pytest.mark.parametrize("fields", ["head", "torso"])
def test_single_field_flags_and_termination(setup, fields):  # noqa: F811
    """Flags with a clear tile-slab and early termination at ert_eps 1e-4:
    the same slabs skipped on both sides, the last slab forced."""
    occ = np.array([[1, 0, 1, 1], [0, 0, 1, 0]], np.int32)
    got, ref = _run_both(setup, jnp.bfloat16, 300, 32, occupancy=occ, ert_eps=1e-4,
                         fields=fields)
    _check(got, ref)
    pw_h, pw_t = (_to_torch(p) for p in _packs(setup["params"], setup["vecs"], jnp.bfloat16))
    rays = [torch.from_numpy(r) for r in setup["rays"]]
    ops = prepare_render_operands(pw_h, pw_t, *rays, torch.linspace(0.3, 0.9, 32),
                                  torch.from_numpy(setup["bc"]), ert_eps=1e-4,
                                  occupancy=torch.from_numpy(occ), fields=fields)
    assert RENDER_VARIANTS[(fields, False)] == f"render_rays_{fields}_bg"
    _, _, slabs, sigma_last, _ = fused_render_rays_reference(ops)
    # tile 0 runs its three flagged slabs, tile 1 its flagged one and the last
    assert slabs.tolist() == [3, 2]
    if fields == "torso":  # no head field: its density at the final sample is 0
        assert float(sigma_last.abs().max()) == 0.0
    else:
        assert float(sigma_last[:300].max()) > 0.0


@pytest.mark.parametrize("fields", ["head", "torso"])
def test_transmittance_before_final_sample(setup, fields):  # noqa: F811
    """The plain version's fifth output is the composite's transmittance
    before the final sample: the epilogue form of the same render, whose
    final sample is a no-op (last distance 0), ends on it bit for bit."""
    pw_h, pw_t = (_to_torch(p) for p in _packs(setup["params"], setup["vecs"], jnp.bfloat16))
    rays = [torch.from_numpy(r) for r in setup["rays"]]
    args = (pw_h, pw_t, *rays, torch.linspace(0.3, 0.9, 16), torch.from_numpy(setup["bc"]))
    *_, t_far = fused_render_rays_reference(prepare_render_operands(*args, fields=fields))
    *_, t_com = fused_render_rays_reference(prepare_render_operands(*args, bg_epilogue=True,
                                                                    fields=fields))
    assert torch.equal(t_far, t_com)
    assert 0.0 < float(t_far[:300].min()) and float(t_far.max()) <= 1.0
