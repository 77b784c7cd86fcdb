"""The port's fused_far_eval_split (its plain PyTorch version, on the CPU)
against the reference package's, run in Pallas interpret mode, on the same
packed weights and a ragged ray count (300: not a multiple of the kernels'
128-ray chunks, nor of the reference's blocks).

Both sides round the PE and every activation to bf16 at the same points;
the rest differs in the last bits and now and then flips one bf16
activation. Bars, with the largest values measured over these cases: the
head's far-plane density sh max 3e-4 (measured 6.8e-5, on densities of
about 1e-2 under relu and 0.7 under softplus) and mean 2e-6 (measured
4.4e-7); the torso colour ct max 3e-4 (measured 8.3e-5) and mean 2e-6
(measured 4.3e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_tpu.ops.pack import pack_field_weights as j_pack
from dfanerf_torch.ops.far_eval import far_head_kernel, far_torso_kernel, fused_far_eval_split

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
BARS = {"sh": (3e-4, 2e-6), "ct": (3e-4, 2e-6)}
N = 300


def _to_torch(pw):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda k: init_decoder(k, JDecoderConfig()))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    sh, st, zs, za = (jnp.asarray(rng.randn(k).astype(np.float32)) for k in (96, 42, 256, 256))
    pw_h = j_pack(params, JDecoderConfig(), sh, zs, za, "head", jnp.bfloat16)
    pw_t = j_pack(params, JDecoderConfig(), st, zs, za, "torso", jnp.bfloat16)

    def rays():
        return ((rng.randn(N, 3) * 0.05).astype(np.float32),
                (rng.randn(N, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32))

    return pw_h, pw_t, (*rays(), *rays()), float(np.asarray(jnp.linspace(0.3, 0.9, 16))[-1])


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_matches_interpret_kernels(setup, act):
    pw_h, pw_t, rays, far = setup
    ref = jf.fused_far_eval_split(pw_h, pw_t, *(jnp.asarray(r) for r in rays), jnp.float32(far),
                                  interpret=True, act=act)
    got = fused_far_eval_split(_to_torch(pw_h), _to_torch(pw_t),
                               *(torch.from_numpy(r) for r in rays), far, act)
    for name, g, r in zip(("sh", "ct"), got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape == ((N, 1) if name == "sh" else (N, 3))
        err = np.abs(g.numpy() - r)
        assert err.max() < BARS[name][0] and err.mean() < BARS[name][1], (name, err.max(),
                                                                          err.mean())


def test_kernel_wrappers_refuse_cpu_tensors(setup):
    pw_h, pw_t, rays, far = setup
    o, d = torch.from_numpy(rays[0]), torch.from_numpy(rays[1])
    with pytest.raises(ValueError, match="CUDA"):
        far_head_kernel(_to_torch(pw_h), o, d, far)
    with pytest.raises(ValueError, match="CUDA"):
        far_torso_kernel(_to_torch(pw_t), o, d, far, torch.zeros(N, 256, dtype=torch.bfloat16))
    assert far_head_kernel.launches == far_torso_kernel.launches == 0
