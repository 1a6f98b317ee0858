"""Port parity for the TecoGAN training slice: the discriminator trunk, the
STNet flow merge and input assembly, SNet's input, VGG19's taps, the weight
bridges, the GAN train step and VSRGANModel's training entry points of
tecogan_tpu_torch, against the JAX package on the same inputs and weights
(CPU; the JAX warps take their gather path). Weights are drawn by the port
and bridged to the JAX layout, and the JAX functions run jitted: the JAX
initialisers and eager calls cost tens of seconds of compiles a process."""

import functools
import logging
import os

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

from tecogan_tpu.models import convert as jconvert
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import SNetConfig as JSNet
from tecogan_tpu.models.networks import STNetConfig as JSTNet
from tecogan_tpu.models.networks import (build_d_input, build_flow_merge,
                                         trunk_apply, vgg19_features)
from tecogan_tpu.models.networks.discriminators import build_stnet_input
from tecogan_tpu.utils import ckpt as jckpt
from tecogan_tpu_torch.models import VSRGANModel, schedules, steps
from tecogan_tpu_torch.models import convert
from tecogan_tpu_torch.models.networks import (VGG19, DTrunk, FRNet,
                                               FRNetConfig, SNetConfig,
                                               STNetConfig,
                                               define_discriminator)
from tecogan_tpu_torch.models.networks import discriminators as tdisc
from tecogan_tpu_torch.ops import warp_vjp

from torch_oracles import TorchDTrunk, rand_vgg19_sd
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_NF, _NB, _S = 16, 2, 4
_HR = 32  # the D's spatial size: the HR training crop
_TE = 3  # tempo_extent: 5 frames after ping-pong doubling
_CB = {"type": "CB", "weight": 1, "reduction": "mean"}
_GAN = {"type": "GAN", "weight": 0.01, "reduction": "mean"}
# two taps, so VGG19 stops after conv3_4: its 512-channel blocks would
# dominate these tiny steps (the shipped four taps run in chip_smoke.py)
_FEAT = {"type": "CosineSimilarity", "weight": 0.2,
         "feature_layers": [8, 17]}
# the step tests' Adam lr: small enough that an update whose sign fp32
# cannot fix moves the later logs by less than their band
_LR = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.array, tree)  # writable copies


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return t.detach().movedim(-3, -1).numpy()


def _jax_d(cfg, key=1):
    """A D's weights in the JAX layout (torch's default init from a seed)."""
    net = DTrunk.random(cfg, torch.Generator().manual_seed(key))
    return convert.jax_from_d_state_dict(net.state_dict(), cfg.spatial_size)


def _port_d(params, cfg):
    return DTrunk.from_state_dict(
        cfg, convert.d_state_dict_from_jax(params, cfg.spatial_size))


_jtrunk = jax.jit(trunk_apply, static_argnames="train")


# ------------------------------------------------------------------- trunk

@pytest.mark.parametrize("kind", ["stnet", "snet", "snet_nocond"])
def test_trunk_matches_jax(rng, kind):
    """Logits, the four block outputs and the BatchNorm running stats of
    one training-mode forward (from non-trivial running stats)."""
    if kind == "stnet":
        cfg = STNetConfig(spatial_size=_HR)
    else:
        cfg = SNetConfig(spatial_size=_HR, use_cond=kind == "snet")
    params = _jax_d(cfg)
    for bi in range(4):
        bn = params[f"block{bi}"]["bn"]
        c = bn["mean"].shape[0]
        bn["mean"] = rng.standard_normal(c).astype(np.float32)
        bn["var"] = rng.random(c).astype(np.float32) + 0.5
        bn["scale"] = rng.random(c).astype(np.float32) + 0.5
        bn["bias"] = rng.standard_normal(c).astype(np.float32)
    x = rng.standard_normal((3, _HR, _HR, cfg.in_channels)).astype(np.float32)
    want_l, want_f, want_p = _jtrunk(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x), train=True)
    net = _port_d(params, cfg)
    got_l, got_f = net(_nchw(x))
    assert tuple(got_l.shape) == want_l.shape == (3, 1)
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(want_l),
                               atol=1e-5)
    for g, w in zip(got_f, want_f):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-5)
    got_p = convert.jax_from_d_state_dict(net.state_dict(), _HR)
    for bi in range(4):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                got_p[f"block{bi}"]["bn"][k],
                np.asarray(want_p[f"block{bi}"]["bn"][k]), atol=1e-5,
                err_msg=f"block{bi} {k}")
    assert all(int(v) == 1 for k, v in net.state_dict().items()
               if k.endswith("num_batches_tracked"))


def test_trunk_bf16_keeps_fp32_batch_norm(rng):
    """Mixed precision's D: bf16 conv and dense weights, fp32 BatchNorm
    scale, bias and statistics; the blocks' outputs stay bf16."""
    cfg = STNetConfig(spatial_size=_HR)
    net = DTrunk.random(cfg, torch.Generator().manual_seed(0))
    params = steps._d_params(net, torch.bfloat16, mixed=True)
    bn = net.bn_parameter_names()
    assert len(bn) == 8
    assert all((v.dtype == torch.float32) == (k in bn)
               for k, v in params.items())
    x = torch.from_numpy(rng.standard_normal(
        (2, 27, _HR, _HR)).astype(np.float32)).bfloat16()
    logits, feats = functional_call(net, params, (x,))
    assert logits.dtype == torch.bfloat16
    assert all(f.dtype == torch.bfloat16 for f in feats)
    assert all(v.dtype == torch.float32 for k, v in net.state_dict().items()
               if "running" in k)


def test_trunk_float64_reference(rng):
    """The trunk in float64 (chip_smoke.py's reference for D's fp32
    gradient): BatchNorm computes in float64 there, and the fp32 trunk
    agrees with it."""
    cfg = STNetConfig(spatial_size=_HR)
    net = DTrunk.random(cfg, torch.Generator().manual_seed(0))
    net64 = DTrunk.from_state_dict(cfg, net.state_dict()).double()
    x = torch.from_numpy(rng.standard_normal(
        (3, 27, _HR, _HR)).astype(np.float32))
    got, feats = net64(x.double())
    assert got.dtype == torch.float64
    assert all(f.dtype == torch.float64 for f in feats)
    assert net64.discriminator_block.block1[1].running_mean.dtype == (
        torch.float64)
    want, _ = net(x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-5)


# ------------------------------------------------------- STNet assembly

def _gen_nets(key=3, degradation="BD"):
    jcfg = JCfg(nf=_NF, nb=_NB, scale=_S, degradation=degradation)
    cfg = FRNetConfig(nf=_NF, nb=_NB, scale=_S, degradation=degradation)
    net = FRNet.random(cfg, torch.Generator().manual_seed(key))
    return jcfg, convert.jax_from_state_dict(net.state_dict(), _NB, _S), cfg, net


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jflow_merge(hr_flow, lr, fnet_params, cfg, use_pp):
    return build_flow_merge(hr_flow, lr, fnet_params, cfg, use_pp)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jassembly_vjp(data, bi, merge, ct, crop, cfg):
    out, vjp = jax.vjp(lambda d: build_stnet_input(d, bi, merge, crop, cfg),
                       data)
    return out, vjp(ct)[0]


@pytest.mark.parametrize("use_pp", [True, False], ids=["pp", "no_pp"])
@pytest.mark.parametrize("crop", [1.0, 0.75])
def test_stnet_assembly_matches_jax(rng, use_pp, crop):
    """build_flow_merge (the forward flow sliced from the ping-pong half,
    or an extra FNet pass) and build_stnet_input, values and the image
    adjoint through the end slots' warp."""
    _, gparams, _, net = _gen_nets()
    n, t, lr_s = 2, 5, _HR // _S
    hr_flow = (rng.standard_normal((n, t - 1, _HR, _HR, 2)) * 3).astype(
        np.float32)
    lr = rng.random((n, t, lr_s, lr_s, 3)).astype(np.float32)
    data = rng.random((n, t, _HR, _HR, 3)).astype(np.float32)
    bi = rng.random((n, t, _HR, _HR, 3)).astype(np.float32)
    jcfg = JSTNet(spatial_size=_HR, degradation="BD", scale=_S)
    want_m = _jflow_merge(jnp.asarray(hr_flow), jnp.asarray(lr),
                          jax.tree.map(jnp.asarray, gparams["fnet"]), jcfg,
                          use_pp)
    got_m = tdisc.build_flow_merge(
        torch.from_numpy(hr_flow), torch.from_numpy(lr), net,
        dict(net.named_parameters()), use_pp)
    assert tuple(got_m.shape) == want_m.shape == (n * 3, _HR, _HR, 2)
    assert not got_m.requires_grad
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               atol=1e-6 if use_pp else 1e-4)

    merge = np.asarray(want_m)
    ct = rng.standard_normal((n * (t // 3), _HR, _HR, 27)).astype(np.float32)
    want, want_grad = _jassembly_vjp(jnp.asarray(data), jnp.asarray(bi),
                                     jnp.asarray(merge), jnp.asarray(ct),
                                     crop, jcfg)
    data_t = torch.from_numpy(np.moveaxis(data, -1, 2).copy()).requires_grad_()
    got = tdisc.build_stnet_input(
        data_t, torch.from_numpy(np.moveaxis(bi, -1, 2).copy()),
        torch.from_numpy(merge.copy()), crop, STNetConfig(spatial_size=_HR))
    assert tuple(got.shape) == (n * (t // 3), 27, _HR, _HR)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6)
    got.backward(_nchw(ct))
    np.testing.assert_allclose(np.moveaxis(data_t.grad.numpy(), 2, -1),
                               np.asarray(want_grad),
                               atol=1e-5)


@pytest.mark.parametrize("use_cond", [True, False])
def test_snet_input_matches_jax(rng, use_cond):
    data = rng.random((2, 3, _HR, _HR, 3)).astype(np.float32)
    bi = rng.random((2, 3, _HR, _HR, 3)).astype(np.float32)
    want = build_d_input(jnp.asarray(data), {"bi_data": jnp.asarray(bi)},
                         JSNet(spatial_size=_HR, use_cond=use_cond))
    got = tdisc.build_d_input(
        torch.from_numpy(np.moveaxis(data, -1, 2).copy()),
        {"bi_data": torch.from_numpy(np.moveaxis(bi, -1, 2).copy())},
        SNetConfig(spatial_size=_HR, use_cond=use_cond))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


# ---------------------------------------------------------------- VGG19

def test_vgg19_taps_match_jax(rng):
    """torchvision-named weights load as they are; the default taps and a
    pre-ReLU one (a conv's index) against vgg19_features."""
    sd = rand_vgg19_sd(rng)
    net = VGG19.from_state_dict(sd)
    assert not any(p.requires_grad for p in net.parameters())
    params = jax.tree.map(jnp.asarray, jconvert.convert_vgg19(sd))
    x = rng.random((2, 40, 40, 3)).astype(np.float32)
    jvgg = jax.jit(vgg19_features, static_argnums=2)
    for layers in ((8, 17, 26, 35), (7, 17)):
        want = jvgg(params, jnp.asarray(x), layers)
        got = net(_nchw(x), layers)
        assert len(got) == len(want) == len(layers)
        for g, w in zip(got, want):
            assert _nhwc(g).shape == w.shape
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-4)
    with pytest.raises(ValueError, match="pooling"):
        net(_nchw(x), (4,))


# -------------------------------------------------------------- bridges

@pytest.mark.parametrize("size", [32, 128])
@pytest.mark.parametrize("kind", ["stnet", "snet"])
def test_d_bridge_round_trip(kind, size):
    cfg = (STNetConfig(spatial_size=size) if kind == "stnet"
           else SNetConfig(spatial_size=size))
    params = jax.tree.map(np.array, _jax_d(cfg, key=size))
    sd = convert.d_state_dict_from_jax(params, size)
    # the port's state dict is the reference's: the JAX converter reads it
    want = jconvert.convert_stnet({k: v.numpy() for k, v in sd.items()},
                                  size)
    back = convert.jax_from_d_state_dict(sd, size)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b, c in zip(jax.tree.leaves(back), jax.tree.leaves(params),
                       jax.tree.leaves(want)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert list(DTrunk.from_state_dict(cfg, sd).state_dict()) == list(sd)


def test_vgg19_bridge_round_trip(rng):
    params = jconvert.convert_vgg19(rand_vgg19_sd(rng))
    sd = convert.vgg19_state_dict_from_jax(params)
    want = jconvert.convert_vgg19({k: v.numpy() for k, v in sd.items()})
    back = convert.vgg19_jax_from_state_dict(sd)
    for tree in (params, want):
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    assert list(VGG19.from_state_dict(sd).state_dict()) == list(sd)


def test_reference_named_d_loads_by_name(rng):
    """A reference D state dict (the torch oracle's names) loads by name,
    and gives the logits the JAX package gives on its conversion."""
    torch.manual_seed(0)
    ref = TorchDTrunk(27, _HR)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 1.5)
    sd = ref.state_dict()
    net = DTrunk.from_state_dict(STNetConfig(spatial_size=_HR), sd)
    params = jconvert.convert_stnet({k: v.numpy() for k, v in sd.items()},
                                    _HR)
    x = rng.standard_normal((3, _HR, _HR, 27)).astype(np.float32)
    want, _, _ = _jtrunk(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                         train=True)
    got, _ = net(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    ref_logits, _ = ref.train()(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               ref_logits.detach().numpy(), atol=1e-5)


# ------------------------------------------------------------ train step

def _variant(name):
    """(tcfg kwargs, D kind, batch form) of each step variant
    (test_torch_gan_step.py). Each variant is one JAX compile (about 10 s),
    so the six cases share four:
    STNet with ping-pong, VGG19 and uint8 BD under ``always``; STNet
    without ping-pong (the extra FNet pass) with the adaptive vote forced
    to skip; SNet conditioned on BI gt+lr, with feature matching and LSGAN,
    the adaptive vote forced to pass; and the first in bf16 without VGG19
    (bf16 convolutions are slow on the CPU; VGG19's bf16 cast runs in
    test_torch_slice.py's jax-blocked step and on the card)."""
    base = dict(scale=_S, sigma=1.5, tempo_extent=_TE, pixel_crit=_CB,
                warping_crit=_CB, pingpong_crit={**_CB, "weight": 0.5},
                gan_crit=_GAN, update_policy="always",
                crop_border_ratio=0.75, degradation="BD")
    if name == "stnet_pp":
        return {**base, "feature_crit": _FEAT}, "stnet", "bd"
    if name == "no_pp_skip":
        return ({**base, "pingpong_crit": None, "update_policy": "adaptive",
                 "update_threshold": -1e9}, "stnet", "bd")
    if name == "snet_bi_fm":
        return ({**base, "degradation": "BI", "warping_crit": None,
                 "feature_matching_crit": {"type": "L1", "weight": 1,
                                           "reduction": "mean"},
                 "gan_crit": {**_GAN, "type": "LSGAN"},
                 "update_policy": "adaptive", "update_threshold": 1e9},
                "snet", "gt_lr")
    if name == "bf16":
        return {**base, "mixed_precision": True}, "stnet", "bd"
    raise ValueError(name)


_VARIANTS = ["stnet_pp", "no_pp_skip", "snet_bi_fm", "bf16"]


@pytest.mark.parametrize("remat", [True, False])
def test_gan_step_warp_counts(rng, monkeypatch, remat):
    """The structure chip_smoke.py's GAN launch counts rest on, for T
    frames after ping-pong doubling: K2 once per forward warp (T HR warps,
    each again under remat, the warping loss's, and the real and the fake
    assembly's); the fused image and flow adjoint for the HR warps of
    frames 1 to T-1; the image adjoint alone for the fake assembly (its
    flow merge is gradient-stopped); the flow adjoint alone for the
    warping loss."""
    counts = {"fwd": 0, "dimage": 0, "dflow": 0, "dimage_dflow": 0}

    def counting(key, fn):
        def wrapped(*a):
            counts[key] += 1
            return fn(*a)
        return wrapped

    for key, name in (("fwd", "warp_rgb"), ("dimage", "warp_dimage"),
                      ("dflow", "warp_dflow"),
                      ("dimage_dflow", "warp_dimage_dflow")):
        monkeypatch.setattr(warp_vjp, name,
                            counting(key, getattr(warp_vjp, name)))
    _, _, _, net_g = _gen_nets()
    cfg_g = FRNetConfig(nf=_NF, nb=_NB, scale=_S, remat=remat)
    cfg_d = STNetConfig(spatial_size=_HR)
    net_d = DTrunk.random(cfg_d, torch.Generator().manual_seed(1))
    kw, _, _ = _variant("stnet_pp")
    tcfg = steps.TrainConfig(**kw)
    og, sg = schedules.make_adam({"lr": 1e-4}, net_g.parameters())
    od, sd = schedules.make_adam({"lr": 1e-4}, net_d.parameters())
    state = steps.tecogan_init_state(net_g, net_d, og, od)
    gt = torch.from_numpy((rng.random((1, _TE, _HR + 8, _HR + 8, 3)) * 255)
                          .astype(np.uint8))
    steps.tecogan_train_step(state, {"gt": gt}, cfg_g=cfg_g, cfg_d=cfg_d,
                             tcfg=tcfg, sched_g=sg, sched_d=sd,
                             vgg=VGG19.random(torch.Generator()))
    t = 2 * _TE - 1
    assert counts == {"fwd": 2 * t + 3 if remat else t + 3,
                      "dimage_dflow": t - 1, "dimage": 1, "dflow": 1}


def test_gan_step_config_errors(rng):
    _, _, cfg_g, net_g = _gen_nets()
    cfg_d = STNetConfig(spatial_size=_HR)
    net_d = DTrunk.random(cfg_d, torch.Generator().manual_seed(1))
    og, sg = schedules.make_adam({"lr": 1e-4}, net_g.parameters())
    od, sd = schedules.make_adam({"lr": 1e-4}, net_d.parameters())
    state = steps.tecogan_init_state(net_g, net_d, og, od)
    kw, _, _ = _variant("stnet_pp")
    gt = {"gt": torch.from_numpy((rng.random((1, _TE, _HR + 8, _HR + 8, 3))
                                  * 255).astype(np.uint8))}
    run = functools.partial(steps.tecogan_train_step, state, gt, cfg_g=cfg_g,
                            cfg_d=cfg_d, sched_g=sg, sched_d=sd)
    with pytest.raises(ValueError, match="gan_crit"):
        run(tcfg=steps.TrainConfig(**{**kw, "gan_crit": None}), vgg=None)
    with pytest.raises(ValueError, match="VGG19"):
        run(tcfg=steps.TrainConfig(**kw), vgg=None)


# --------------------------------------------------------------- the model

def _gan_opt(tmp_path, **train):
    return {
        "scale": _S, "manual_seed": 0, "device_ids": [], "is_train": True,
        "dataset": {"degradation": {"type": "BD", "sigma": 1.5},
                    "train": {"crop_size": _HR}},
        "model": {"name": "TecoGAN",
                  "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": _NF, "nb": _NB},
                  "discriminator": {"name": "STNet", "in_nc": 3,
                                    "tempo_range": 3}},
        "train": {"tempo_extent": _TE, "ckpt_dir": str(tmp_path / "ckpt"),
                  "mixed_precision": False, "pixel_crit": _CB,
                  "warping_crit": _CB,
                  "feature_crit": {**_FEAT, "allow_random_weights": True,
                                   "weights_path":
                                       str(tmp_path / "vgg19.npz")},
                  "pingpong_crit": {**_CB, "weight": 0.5}, "gan_crit": _GAN,
                  "generator": {"lr": 5e-5},
                  "discriminator": {"lr": 5e-5, "update_policy": "adaptive",
                                    "update_threshold": 0.4,
                                    "crop_border_ratio": 0.75,
                                    "lr_schedule": {"type": "MultiStepLR",
                                                    "milestones": [1],
                                                    "gamma": 0.5}},
                  **train},
        "logger": {"decay": 0.9},
    }


def _model_batch(model, rng):
    return model.prepare_training_data(
        {"gt": (rng.random((2, _TE, _HR + 8, _HR + 8, 3)) * 255)
         .astype(np.uint8)})


def _same_adam(a, b):
    a, b = a.state_dict(), b.state_dict()
    return a["param_groups"] == b["param_groups"] and all(
        torch.equal(b["state"][i][k], v)
        for i, s in a["state"].items() for k, v in s.items())


def test_vsrgan_model_train_save_and_resume(tmp_path, rng):
    """VSRGANModel's training entry points on the CPU: two steps, the JAX
    layout G_iter and D_iter files, the full-state file and a fresh model's
    resume, which then takes the same step."""
    opt = _gan_opt(tmp_path)
    model = VSRGANModel(opt)
    assert model.device == torch.device("cpu")
    assert model.get_learning_rate() == {"lr_G": 5e-5, "lr_D": 5e-5}
    # D and VGG from the seed + 1 and + 2
    want_d = define_discriminator(opt)[1](torch.Generator().manual_seed(1))
    for k, v in want_d.state_dict().items():
        assert torch.equal(model.net_d.state_dict()[k], v), k
    want_v = VGG19.random(torch.Generator().manual_seed(2))
    assert all(torch.equal(model.vgg.state_dict()[k], v)
               for k, v in want_v.state_dict().items())
    v0 = {k: v.clone() for k, v in model.vgg.state_dict().items()}
    for _ in range(2):
        logs = model.train(_model_batch(model, rng))
    assert set(logs) == set(steps.TECOGAN_LOG_KEYS)
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert model.state["step"] == 2
    assert model.get_learning_rate() == {"lr_G": 5e-5, "lr_D": 2.5e-5}
    assert all(torch.equal(v0[k], v)
               for k, v in model.vgg.state_dict().items())
    running = model.get_running_log(model.state)

    model.save(2)
    model.save_training_state_now(2)
    ckpt = tmp_path / "ckpt"
    g = jckpt.load_pytree(str(ckpt / "G_iter2.npz"))
    d = jckpt.load_pytree(str(ckpt / "D_iter2.npz"))
    for tree, want in ((g, convert.jax_from_state_dict(
            model.net_g.state_dict(), _NB, _S)),
            (d, convert.jax_from_d_state_dict(model.net_d.state_dict(),
                                              _HR))):
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)

    fresh = VSRGANModel(opt)
    state, resumed = fresh.try_resume(fresh.state)
    assert resumed and state["step"] == 2
    for net in ("g", "d"):
        live = model.state[net].state_dict()
        for k, v in state[net].state_dict().items():
            assert torch.equal(live[k], v), (net, k)
    assert _same_adam(model.state["opt_g"], state["opt_g"])
    assert _same_adam(model.state["opt_d"], state["opt_d"])
    assert torch.equal(state["cnt_upd_d"], model.state["cnt_upd_d"])
    assert fresh.get_running_log(state) == running
    batch = _model_batch(model, rng)
    la, lb = model.train(batch), fresh.train(batch)
    for k in la:
        assert torch.equal(la[k], lb[k]), k

    # a FRVSR state file does not resume a TecoGAN model
    frvsr = {"step": 1, "g": model.net_g.state_dict(),
             "opt_g": model.state["opt_g"].state_dict(),
             "running_log": {}}
    torch.save(frvsr, ckpt / "state_iter9.pth")
    with pytest.raises(ValueError, match="does not match"):
        fresh.try_resume(fresh.state)


def test_vsrgan_model_loads_d_and_vgg(tmp_path, rng):
    """D from a JAX-layout .npz or a reference .pth; VGG19 from a
    JAX-layout .npz at feature_crit.weights_path."""
    params = _jax_d(STNetConfig(spatial_size=_HR), key=4)
    jckpt.save_pytree(params, str(tmp_path / "D.npz"))
    torch.save(convert.d_state_dict_from_jax(params, _HR),
               tmp_path / "D.pth")
    vgg = jconvert.convert_vgg19(rand_vgg19_sd(rng))
    jckpt.save_pytree(vgg, str(tmp_path / "vgg19.npz"))
    for path in ("D.npz", "D.pth"):
        opt = _gan_opt(tmp_path)
        opt["model"]["discriminator"]["load_path"] = str(tmp_path / path)
        model = VSRGANModel(opt)
        got = convert.jax_from_d_state_dict(model.net_d.state_dict(), _HR)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        got = convert.vgg19_jax_from_state_dict(model.vgg.state_dict())
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(vgg)):
            np.testing.assert_array_equal(a, b)


def test_vsrgan_model_vgg_gate(tmp_path, caplog):
    """No VGG19 weights: a FileNotFoundError unless
    feature_crit.allow_random_weights, then one WARNING."""
    opt = _gan_opt(tmp_path)
    del opt["train"]["feature_crit"]["allow_random_weights"]
    with pytest.raises(FileNotFoundError, match="vgg19.npz"):
        VSRGANModel(opt)
    with caplog.at_level(logging.WARNING):
        VSRGANModel(_gan_opt(tmp_path))
    warns = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warns) == 1 and "RANDOM features" in warns[0].getMessage()
    # without a perceptual loss there is no VGG at all
    opt = _gan_opt(tmp_path)
    del opt["train"]["feature_crit"]
    assert VSRGANModel(opt).vgg is None
    assert not os.listdir(tmp_path)
