"""Port parity for the TecoGAN train step: two ``tecogan_train_step``s of
tecogan_tpu_torch against ``jax.jit(tecogan_train_step)`` of the JAX
package from the same weights and batches (CPU), in the variants of
``test_torch_gan._variant``: the logs, the EMA log, the vote and D's update
count, G's and D's Adam updates, D's BatchNorm running stats. Kept apart
from test_torch_gan.py so that the four JAX compiles run on a worker of
their own."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tecogan_tpu.models import convert as jconvert
from tecogan_tpu.models import schedules as jsched
from tecogan_tpu.models import steps as jsteps
from tecogan_tpu.models.networks import SNetConfig as JSNet
from tecogan_tpu.models.networks import STNetConfig as JSTNet
from tecogan_tpu_torch.models import convert, schedules, steps
from tecogan_tpu_torch.models.networks import VGG19, SNetConfig, STNetConfig

from test_torch_gan import (_HR, _LR, _NB, _S, _TE, _VARIANTS, _gen_nets,
                            _jax_d, _port_d, _variant)
from torch_oracles import rand_vgg19_sd


def _gan_batches(rng, form):
    out = []
    for _ in range(2):
        if form == "bd":
            out.append({"gt": (rng.random((2, _TE, _HR + 8, _HR + 8, 3))
                               * 255).astype(np.uint8)})
        else:
            out.append({"gt": rng.random((2, _TE, _HR, _HR, 3))
                        .astype(np.float32),
                        "lr": rng.random((2, _TE, _HR // _S, _HR // _S, 3))
                        .astype(np.float32)})
    return out


@pytest.fixture(scope="module", params=_VARIANTS)
def gan_runs(request):
    """Two GAN steps of the JAX package (jitted) and of the port from the
    same weights and batches."""
    kw, kind, form = _variant(request.param)
    rng = np.random.default_rng(11)
    degradation = kw["degradation"]
    jcfg_g, params_g, cfg_g, net_g = _gen_nets(9, degradation)
    if kind == "stnet":
        jcfg_d = JSTNet(spatial_size=_HR, degradation=degradation, scale=_S)
        cfg_d = STNetConfig(spatial_size=_HR)
    else:
        jcfg_d = JSNet(spatial_size=_HR, use_cond=True)
        cfg_d = SNetConfig(spatial_size=_HR, use_cond=True)
    params_d = _jax_d(cfg_d, key=5)
    net_d = _port_d(params_d, cfg_d)
    vgg_sd = rand_vgg19_sd(rng)
    opt_g = {"lr": _LR, "betas": [0.9, 0.999]}
    opt_d = {"lr": _LR, "betas": [0.5, 0.999],
             "lr_schedule": {"type": "MultiStepLR", "milestones": [1],
                             "gamma": 0.5}}

    jt = jsteps.TrainConfig(**kw)
    tx_g, _ = jsched.make_adam(opt_g)
    tx_d, sched_d = jsched.make_adam(opt_d, external_lr=True)
    jstate = jsteps.tecogan_init_state(
        jax.tree.map(jnp.asarray, params_g),
        jax.tree.map(jnp.asarray, params_d), tx_g, tx_d)
    jstep = jax.jit(functools.partial(
        jsteps.tecogan_train_step, cfg_g=jcfg_g, cfg_d=jcfg_d, tcfg=jt,
        tx_g=tx_g, tx_d=tx_d, sched_d=sched_d))
    jvgg = jax.tree.map(jnp.asarray, jconvert.convert_vgg19(vgg_sd))

    tt = steps.TrainConfig(**kw)
    og, sg = schedules.make_adam(opt_g, net_g.parameters())
    od, sd = schedules.make_adam(opt_d, net_d.parameters())
    state = steps.tecogan_init_state(net_g, net_d, og, od)
    vgg = VGG19.from_state_dict(vgg_sd)
    d0 = {k: v.clone() for k, v in net_d.state_dict().items()}
    w0 = (params_g, params_d)

    jlogs, tlogs = [], []
    for batch in _gan_batches(rng, form):
        jstate, lj = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           vgg_params=jvgg)
        state, lt = steps.tecogan_train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()},
            cfg_g=cfg_g, cfg_d=cfg_d, tcfg=tt, sched_g=sg, sched_d=sd,
            vgg=vgg)
        jlogs.append({k: float(v) for k, v in lj.items()})
        tlogs.append(lt)
    return request.param, jstate, jlogs, state, tlogs, d0, w0


def _log_tols(name, key):
    """(rtol, atol) of a log: the losses within rtol 1e-4 (bf16: 2e-2),
    the raw-logit means and the distance, which can be near 0, also
    within atol 1e-6; in bf16 those pass through the five bf16 layers of
    the trunk (and the JAX gather warp's bf16 weights, where the port's are
    fp32), so they are held to 0.1 absolute, against logits of 1-3."""
    if name != "bf16":
        return 1e-4, 1e-6
    return (2e-2, 1e-4) if key.startswith("l_") else (2e-2, 0.1)


def test_gan_step_logs_match_jax(gan_runs):
    name, jstate, jlogs, state, tlogs, _, _ = gan_runs
    assert state["step"] == int(jstate["step"]) == 2
    for i, (lj, lt) in enumerate(zip(jlogs, tlogs)):
        assert set(lt) == set(steps.TECOGAN_LOG_KEYS)
        for k in steps.TECOGAN_LOG_KEYS:
            assert lt[k].dtype == torch.float32 and lt[k].dim() == 0
            rtol, atol = _log_tols(name, k)
            np.testing.assert_allclose(float(lt[k]), lj[k], rtol=rtol,
                                       atol=atol, err_msg=f"step {i} {k}")
        # the vote and the update count exactly
        assert float(lt["n_upd_D"]) == lj["n_upd_D"]
    for k in steps.TECOGAN_LOG_KEYS:
        rtol, atol = _log_tols(name, k)
        np.testing.assert_allclose(float(state["running_log"][k]),
                                   float(jstate["running_log"][k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert float(state["cnt_upd_d"]) == float(jstate["cnt_upd_d"])
    want_upd = {"no_pp_skip": 0.0}.get(name, 2.0)
    assert float(state["cnt_upd_d"]) == want_upd
    if name == "no_pp_skip":
        assert all(float(lt["l_gan_D"]) == 0.0 for lt in tlogs)
    expect_zero = {"l_fm_G": name != "snet_bi_fm",
                   "l_feat_G": name != "stnet_pp",
                   "l_pp_G": name == "no_pp_skip",
                   "l_warp_G": name == "snet_bi_fm"}
    for k, zero in expect_zero.items():
        assert (float(tlogs[0][k]) == 0.0) == zero, k


def _assert_adam_close(got, want, start, what):
    """The two Adam updates (weights minus their start) within 5% of lr
    of each other, but for Adam's sign flips: an element whose gradient is
    at fp32's noise level takes its +-lr step either way, so a few
    elements (at most 2, or 0.1% of the tensor) may be off by up to two
    flipped steps of the two updates. The updates are about lr an element,
    so the bulk is held to 1/20 of them."""
    d = np.abs((got - start) - (want - start))
    off = int((d > 0.05 * _LR).sum())
    assert off <= max(2, 1e-3 * d.size) and d.max() <= 4.2 * _LR, (
        what, off, d.size, d.max())


def test_gan_step_weights_match_jax(gan_runs):
    """G and D after two Adam steps, D's BatchNorm running stats after six
    forwards; the masters and moments stay fp32."""
    name, jstate, _, state, _, d0, (g_start, d_start) = gan_runs
    net_d = state["d"]
    if name == "no_pp_skip":
        # a skipped vote leaves D's weights (not its BN stats) and Adam
        # state as they were
        for k, v in net_d.state_dict().items():
            if "running" not in k and "num_batches" not in k:
                assert torch.equal(v, d0[k]), k
        assert not state["opt_d"].state
    else:
        assert not torch.equal(net_d.dense.weight, d0["dense.weight"])
    assert all(int(v) == 6 for k, v in net_d.state_dict().items()
               if k.endswith("num_batches_tracked"))
    assert all(p.dtype == torch.float32 for p in net_d.parameters())
    assert all(v.dtype == torch.float32
               for s in state["opt_g"].state.values()
               for k, v in s.items() if k != "step")
    if name == "bf16":
        # bf16 gradients: parameters near Adam's sign flip move either way
        return
    got_g = convert.jax_from_state_dict(state["g"].state_dict(), _NB, _S)
    want_g = jax.device_get(jstate["g"])
    assert jax.tree.structure(got_g) == jax.tree.structure(want_g)
    for (path, a), b, a0 in zip(jax.tree_util.tree_leaves_with_path(got_g),
                                jax.tree.leaves(want_g),
                                jax.tree.leaves(g_start)):
        _assert_adam_close(a, b, a0, str(path))
    got_d = convert.jax_from_d_state_dict(net_d.state_dict(), _HR)
    want_d = jax.device_get(jstate["d"])
    assert jax.tree.structure(got_d) == jax.tree.structure(want_d)
    for (path, a), b, a0 in zip(jax.tree_util.tree_leaves_with_path(got_d),
                                jax.tree.leaves(want_d),
                                jax.tree.leaves(d_start)):
        if path[-1].key in ("mean", "var"):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=str(path))
        elif name == "no_pp_skip":
            np.testing.assert_array_equal(b, a0, err_msg=str(path))
        else:
            _assert_adam_close(a, b, a0, str(path))


