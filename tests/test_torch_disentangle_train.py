"""The distangler's training in the port (pipeline/disentangle.py: the
concatenater, the mouth-keypoint net, the checkpoint converters and the
mouth-swap + cycle train step) on the CPU against the reference package,
with the reference's seeded nets converted and its synthetic 64-point 3DMM
copied.

Bars: converters bit for bit; the nets' outputs (the keypoint net in both
BatchNorm modes, with the population variance in train mode and the
running statistics left as they were) within 1e-5; train steps compared
one at a time from the reference's state (ROADMAP queue 3, "Adam's sign
noise"), the losses and every parameter and moment after the step within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dfanerf_tpu.pipeline import disentangle as jd
from dfanerf_tpu.pipeline.face3dmm import make_synthetic_3dmm
from dfanerf_tpu.train.optim import adam_init as j_adam_init
from dfanerf_torch.compat.from_jax import params_to_state_dict
from dfanerf_torch.pipeline import disentangle as td
from dfanerf_torch.pipeline.face3dmm import Face3DMM
from dfanerf_torch.train.optim import adam_init

TOL = 1e-5
EXP_DIM, DIM_O, DIM_M = 12, 16, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: small tensors, six suite workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, float(np.abs(ref).max())), rtol=0,
                               err_msg=what)


def _port_nets(jparams):
    nets = nn.ModuleDict({"dis": td.Distangler(EXP_DIM, DIM_O, DIM_M),
                          "cat": td.Concatenater(DIM_O, DIM_M, EXP_DIM)})
    nets["dis"].load_state_dict(td.distangler_state_dict_from_jax(jparams["dis"]))
    nets["cat"].load_state_dict(td.concatenater_state_dict_from_jax(jparams["cat"]))
    return nets


def test_nets_and_converters_match_reference():
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    dis = jax.tree.map(np.asarray, jd.init_distangler(k[0]))
    cat = jax.tree.map(np.asarray, jd.init_concatenater(k[1]))
    for tree, to_torch, from_torch in ((dis, td.distangler_from_torch, jd.distangler_from_torch),
                                       (cat, td.concatenater_from_torch,
                                        jd.concatenater_from_torch)):
        sd = params_to_state_dict(tree)  # the reference network.py's keys and layouts
        got = to_torch(sd)
        assert sorted(got) == sorted(sd)
        for key, v in sd.items():
            assert torch.equal(got[key], v) and got[key].data_ptr() != v.data_ptr()
        assert jax.tree.all(jax.tree.map(np.array_equal, from_torch(sd), tree))
    rng = np.random.RandomState(1)
    x = rng.randn(6, 79).astype(np.float32)
    t_dis, t_cat = td.Distangler(), td.Concatenater()
    t_dis.load_state_dict(td.distangler_state_dict_from_jax(dis))
    t_cat.load_state_dict(td.concatenater_state_dict_from_jax(cat))
    with torch.no_grad():
        o, m = t_dis(torch.from_numpy(x))
        back = t_cat(o, m)
    r_o, r_m = jd.apply_distangler(dis, jnp.asarray(x))
    _close(o.numpy(), r_o, "exp_o")
    _close(m.numpy(), r_m, "exp_m")
    _close(back.numpy(), jd.apply_concatenater(cat, r_o, r_m), "concatenated")


@pytest.mark.parametrize("hidden", [0, 2])
def test_mouth_exp2kpts_both_modes_match_reference(hidden):
    params = jax.tree.map(np.asarray, jd.init_mouth_exp2kpts(jax.random.PRNGKey(2),
                                                             num_hidden_layers=hidden))
    rng = np.random.RandomState(3)
    # running statistics that are not the identity, so a mode mix-up shows
    for bn in [params["input_bn"], *params["hidden_bn"]]:
        bn["mean"] = rng.randn(64).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    net = td.MouthExp2KptsNet(num_hidden_layers=hidden)
    net.load_state_dict(td.mouth_exp2kpts_state_dict_from_jax(params))
    stats = {k: v.clone() for k, v in net.state_dict().items()}
    x = rng.randn(10, 32).astype(np.float32)
    with torch.no_grad():
        for train in (False, True):
            _close(net(torch.from_numpy(x), train=train).numpy(),
                   jd.apply_mouth_exp2kpts(params, jnp.asarray(x), train=train), f"train={train}")
    assert all(torch.equal(v, stats[k]) for k, v in net.state_dict().items())


def _model():
    m = make_synthetic_3dmm(jax.random.PRNGKey(3), point_num=64)
    t = Face3DMM(**{k: torch.from_numpy(np.array(getattr(m, k))) for k in (
        "base_id", "base_exp", "mu", "base_tex", "mu_tex", "sig_id", "sig_exp", "sig_tex")},
        lands_info=np.asarray(m.lands_info))
    return m, t


@pytest.mark.parametrize("kw", [dict(), dict(swap_weight=0.0, use_vec_loss=True,
                                             use_exp_loss=True, coord_dim=3)],
                         ids=["default", "cycle-only-vec-exp"])
def test_train_steps_match_reference(kw):
    jm, tm = _model()
    id_dim = jm.base_id.shape[0]
    lands = np.arange(51, dtype=np.int32)
    _, j_step = jd.make_disentangle_train_step(jm, jnp.asarray(lands), id_dim=id_dim, **kw)
    _, t_step = td.make_disentangle_train_step(tm, lands, id_dim=id_dim, **kw)
    k = jax.random.split(jax.random.PRNGKey(4), 2)
    jparams = {"dis": jd.init_distangler(k[0], input_dim=EXP_DIM, dim_o=DIM_O, dim_m=DIM_M),
               "cat": jd.init_concatenater(k[1], dim_o=DIM_O, dim_m=DIM_M, output_dim=EXP_DIM)}
    jopt = j_adam_init(jparams)
    rng = np.random.RandomState(5)
    for i in range(2):  # the second step from the reference's state after the first
        batch = rng.randn(16, EXP_DIM).astype(np.float32) * 0.3
        nets = _port_nets(jax.tree.map(np.asarray, jparams))
        opt = adam_init(nets)
        for key in ("m", "v"):
            sd = {**{f"dis.{n}": v for n, v in td.distangler_state_dict_from_jax(
                jax.tree.map(np.asarray, jopt[key]["dis"])).items()},
                  **{f"cat.{n}": v for n, v in td.concatenater_state_dict_from_jax(
                      jax.tree.map(np.asarray, jopt[key]["cat"])).items()}}
            opt[key] = {n: sd[n] for n in opt[key]}
        opt["t"] = int(jopt["t"])
        aux = t_step(nets, opt, torch.from_numpy(batch), 1e-3)
        jparams, jopt, jaux = j_step(jparams, jopt, jnp.asarray(batch), jnp.float32(1e-3))
        for name in ("swap", "cycle", "total"):
            _close(float(aux[name]), float(jaux[name]), f"step {i} {name}")
        assert float(aux["cycle"]) > 0 and (float(aux["swap"]) > 0)
        want = {**{f"dis.{n}": v for n, v in td.distangler_state_dict_from_jax(
            jax.tree.map(np.asarray, jparams["dis"])).items()},
                **{f"cat.{n}": v for n, v in td.concatenater_state_dict_from_jax(
                    jax.tree.map(np.asarray, jparams["cat"])).items()}}
        for n, p in nets.named_parameters():
            _close(p.detach().numpy(), want[n].numpy(), f"step {i} {n}")
        assert opt["t"] == int(jopt["t"]) == i + 1
