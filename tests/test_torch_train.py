"""Port parity for the FRVSR training slice: losses, schedules, Adam, the
training unroll, the whole train step, the weight bridge back to the JAX
layout and the checkpoints of tecogan_tpu_torch, against the JAX package
on the same inputs and weights (CPU)."""

import functools
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tecogan_tpu.models import convert as jconvert
from tecogan_tpu.models import losses as jlosses
from tecogan_tpu.models import schedules as jsched
from tecogan_tpu.models import steps as jsteps
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import forward_sequence as jforward
from tecogan_tpu.models.networks import init_frnet
from tecogan_tpu.utils import ckpt as jckpt
from tecogan_tpu_torch.models import VSRModel
from tecogan_tpu_torch.models import losses, schedules, steps
from tecogan_tpu_torch.models.convert import (jax_from_state_dict,
                                              state_dict_from_jax)
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               forward_sequence,
                                               infer_sequence)
from tecogan_tpu_torch.ops import resize, warp_vjp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_NF, _NB, _S = 16, 2, 4
_CB = {"type": "CB", "weight": 1, "reduction": "mean"}


def _nets(seed=3, remat=True):
    params = jax.tree.map(np.array, init_frnet(
        jax.random.PRNGKey(seed), JCfg(nf=_NF, nb=_NB, scale=_S)))
    cfg = FRNetConfig(nf=_NF, nb=_NB, scale=_S, remat=remat)
    return params, cfg, FRNet.from_state_dict(
        cfg, state_dict_from_jax(params, _NB, _S))


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("crit", [
    {"type": "MSE"}, {"type": "L1"}, {"type": "CB"},
    {"type": "CB", "reduction": "sum"}, {"type": "MSE", "reduction": "sum"},
    {"type": "CosineSimilarity"}])
def test_criterion_matches_jax(rng, crit):
    x = rng.random((2, 6, 5, 3)).astype(np.float32)
    y = rng.random((2, 6, 5, 3)).astype(np.float32)
    want = float(jlosses.define_criterion(crit)(jnp.asarray(x),
                                                jnp.asarray(y)))
    got = losses.define_criterion(crit)(torch.from_numpy(x),
                                        torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("ctype", ["GAN", "LSGAN"])
@pytest.mark.parametrize("is_real", [True, False])
def test_gan_criterion_matches_jax(rng, ctype, is_real):
    logits = (rng.standard_normal((4, 1)) * 5).astype(np.float32)
    crit = {"type": ctype}
    want = float(jlosses.define_criterion(crit)(jnp.asarray(logits), is_real))
    got = float(losses.define_criterion(crit)(torch.from_numpy(logits),
                                              is_real))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_criterion_none_and_unknown():
    assert losses.define_criterion(None) is None
    with pytest.raises(ValueError, match="criterion"):
        losses.define_criterion({"type": "Huber"})


def test_charbonnier_accumulates_bf16_in_fp32(rng):
    x = rng.random((3, 8, 8, 3)).astype(np.float32)
    y = rng.random((3, 8, 8, 3)).astype(np.float32)
    want = jlosses.charbonnier(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(y, jnp.bfloat16))
    got = losses.charbonnier(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------- schedules

_SCHEDULES = [
    (None, [0, 1, 5]),
    ({"type": "FixedLR"}, [0, 7]),
    ({"type": "MultiStepLR", "milestones": [150, 300], "gamma": 0.5},
     [0, 1, 149, 150, 151, 299, 300, 301, 10 ** 6]),
    ({"type": "CosineAnnealingRestartLR", "periods": [10, 20],
      "restart_weights": [1.0, 0.5], "eta_min": 1e-7},
     [0, 1, 9, 10, 11, 29, 30, 31, 45]),
]


@pytest.mark.parametrize("sched,steps_", _SCHEDULES)
def test_schedule_matches_jax(sched, steps_):
    want = jsched.define_lr_schedule(sched, 1e-4)
    got = schedules.define_lr_schedule(sched, 1e-4)
    for k in steps_:
        # the JAX schedules evaluate in fp32, the port's in double: a few
        # fp32 ulps of the base lr apart
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-6,
                                   atol=1e-11, err_msg=f"step {k}")


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        schedules.define_lr_schedule({"type": "Poly"}, 1e-4)


@pytest.mark.parametrize("wd", [0, 0.05])
def test_adam_matches_optax(rng, wd):
    """Two updates with a schedule whose lr drops after update 0."""
    train_opt = {"lr": 1e-2, "betas": [0.8, 0.99], "weight_decay": wd,
                 "lr_schedule": {"type": "MultiStepLR", "milestones": [1],
                                 "gamma": 0.5}}
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(2)]

    tx, _ = jsched.make_adam(train_opt)
    pj = jax.tree.map(jnp.asarray, p0)
    st = tx.init(pj)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, pj)
        pj = optax.apply_updates(pj, upd)

    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, sched = schedules.make_adam(train_opt, list(pt.values()))
    for k, g in enumerate(grads):
        for name, p in pt.items():
            p.grad = torch.from_numpy(g[name])
        for group in opt.param_groups:
            group["lr"] = sched(k)
        opt.step()
    for name in p0:
        np.testing.assert_allclose(pt[name].detach().numpy(),
                                   np.asarray(pj[name]), rtol=1e-5,
                                   atol=1e-7)


# --------------------------------------------------------- training unroll

@pytest.mark.parametrize("remat", [True, False])
def test_forward_sequence_matches_jax(rng, remat):
    params, cfg, net = _nets(remat=remat)
    lr = rng.random((2, 3, 8, 16, 3)).astype(np.float32)
    want = jforward(jax.tree.map(jnp.asarray, params), jnp.asarray(lr),
                    JCfg(nf=_NF, nb=_NB, scale=_S, remat=remat))
    got = forward_sequence(net, torch.from_numpy(lr), cfg)
    for k, shape in (("hr_data", (2, 3, 32, 64, 3)),
                     ("hr_flow", (2, 2, 32, 64, 2)),
                     ("lr_flow", (4, 8, 16, 2)),
                     ("lr_prev", (4, 8, 16, 3)),
                     ("lr_curr", (4, 8, 16, 3))):
        assert tuple(got[k].shape) == shape == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4,
                                   err_msg=k)
    # gradients reach every parameter through the recurrence
    got["hr_data"].float().square().mean().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in net.parameters())


def test_training_after_inference_in_one_process(rng):
    """Inference first caches the resize matrices under inference mode;
    a training step on the same sizes must still differentiate through
    them."""
    _, cfg, net = _nets()
    resize._device_matrix.cache_clear()
    lr = torch.from_numpy(rng.random((1, 2, 8, 8, 3)).astype(np.float32))
    infer_sequence(net, lr[0], cfg, chunk=2)
    forward_sequence(net, lr, cfg)["hr_data"].square().mean().backward()
    assert net.fnet.encoder1[0].weight.grad is not None


@pytest.mark.parametrize("remat", [True, False])
def test_unroll_warp_counts(rng, monkeypatch, remat):
    """The structure chip_smoke.py's launch counts rest on: one forward
    warp per frame and one for the warping loss, each HR warp recomputed
    under remat; the image adjoint for every warp whose image needs a
    gradient (not frame 0's zero carry, not the loss's LR data), the flow
    adjoint for every flow that does (not frame 0's zero flow): both in
    one fused call for the HR warps of frames 1 to t-1, the flow's alone
    for the loss's warp."""
    counts = {"fwd": 0, "dimage": 0, "dflow": 0, "dimage_dflow": 0}

    def counting(key, fn):
        def wrapped(*a):
            counts[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(warp_vjp, "warp_rgb",
                        counting("fwd", warp_vjp.warp_rgb))
    monkeypatch.setattr(warp_vjp, "warp_dimage",
                        counting("dimage", warp_vjp.warp_dimage))
    monkeypatch.setattr(warp_vjp, "warp_dflow",
                        counting("dflow", warp_vjp.warp_dflow))
    monkeypatch.setattr(warp_vjp, "warp_dimage_dflow",
                        counting("dimage_dflow",
                                 warp_vjp.warp_dimage_dflow))
    _, cfg, net = _nets(remat=remat)
    tcfg = steps.TrainConfig(scale=_S, degradation="BD", sigma=1.5,
                             pixel_crit=_CB, warping_crit=_CB)
    opt, sched = schedules.make_adam({"lr": 1e-4}, net.parameters())
    state = steps.frvsr_init_state(net, opt)
    t = 4
    gt = torch.from_numpy(
        (rng.random((1, t, 40, 40, 3)) * 255).astype(np.uint8))
    steps.frvsr_train_step(state, {"gt": gt}, cfg_g=cfg, tcfg=tcfg,
                           sched_g=sched)
    assert counts == {"fwd": (t + 1) + (t if remat else 0),
                      "dimage_dflow": t - 1, "dimage": 0, "dflow": 1}


# -------------------------------------------------------------- train step

def _tcfgs(mixed):
    kw = dict(scale=_S, degradation="BD", sigma=1.5, pixel_crit=_CB,
              warping_crit=_CB, mixed_precision=mixed)
    # the clip length comes from the batch; only the JAX config records it
    return jsteps.TrainConfig(**kw, tempo_extent=3), steps.TrainConfig(**kw)


def _batches(rng, form):
    """Two steps' batches: uint8 GT clips for on-device BD, or float
    GT + LR clips."""
    out = []
    for _ in range(2):
        if form == "bd":
            out.append({"gt": (rng.random((2, 3, 40, 40, 3)) * 255)
                        .astype(np.uint8)})
        else:
            out.append({"gt": rng.random((2, 3, 32, 32, 3))
                        .astype(np.float32),
                        "lr": rng.random((2, 3, 8, 8, 3)).astype(np.float32)})
    return out


def _run_both(rng, form, mixed):
    params, cfg, net = _nets(seed=9, remat=True)
    jt, tt = _tcfgs(mixed)
    train_opt = {"lr": 1e-3, "betas": [0.9, 0.999]}

    tx, _ = jsched.make_adam(train_opt)
    jstate = jsteps.frvsr_init_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jax.jit(functools.partial(
        jsteps.frvsr_train_step, cfg_g=JCfg(nf=_NF, nb=_NB, scale=_S),
        tcfg=jt, tx_g=tx))
    opt, sched = schedules.make_adam(train_opt, net.parameters())
    state = steps.frvsr_init_state(net, opt)

    jlogs, tlogs = [], []
    for batch in _batches(rng, form):
        jstate, lj = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, lt = steps.frvsr_train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()},
            cfg_g=cfg, tcfg=tt, sched_g=sched)
        jlogs.append(lj)
        tlogs.append(lt)
    return jstate, jlogs, state, tlogs


@pytest.mark.parametrize("form", ["bd", "gt_lr"])
def test_train_step_fp32_matches_jax(rng, form):
    jstate, jlogs, state, tlogs = _run_both(rng, form, mixed=False)
    assert state["step"] == int(jstate["step"]) == 2
    for lj, lt in zip(jlogs, tlogs):
        for k in steps.FRVSR_LOG_KEYS:
            assert lt[k].dtype == torch.float32 and lt[k].dim() == 0
            np.testing.assert_allclose(float(lt[k]), float(lj[k]),
                                       rtol=1e-4, err_msg=k)
    for k in steps.FRVSR_LOG_KEYS:
        np.testing.assert_allclose(float(state["running_log"][k]),
                                   float(jstate["running_log"][k]),
                                   rtol=1e-4, err_msg=k)
    got = jax_from_state_dict(state["g"].state_dict(), _NB, _S)
    want = jax.device_get(jstate["g"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        # Adam normalises gradients, so updates are ~lr in magnitude;
        # the tolerance covers fp32 accumulation order
        np.testing.assert_allclose(a, b, atol=2e-4)


@pytest.mark.parametrize("form", ["bd", "gt_lr"])
def test_train_step_mixed_precision_matches_jax(rng, form):
    jstate, jlogs, state, tlogs = _run_both(rng, form, mixed=True)
    for lj, lt in zip(jlogs, tlogs):
        for k in steps.FRVSR_LOG_KEYS:
            np.testing.assert_allclose(float(lt[k]), float(lj[k]),
                                       rtol=2e-2, err_msg=k)
    # the masters stay fp32; the optimizer's moments too
    net = state["g"]
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(v.dtype == torch.float32
               for s in state["opt_g"].state.values()
               for k, v in s.items() if k != "step")


def test_train_step_config_errors(rng):
    _, cfg, net = _nets()
    opt, sched = schedules.make_adam({"lr": 1e-4}, net.parameters())
    state = steps.frvsr_init_state(net, opt)
    _, tcfg = _tcfgs(False)
    bad = {"gt": torch.from_numpy((rng.random((1, 3, 44, 44, 3)) * 255)
                                  .astype(np.uint8))}  # LR 9x9
    with pytest.raises(ValueError, match="multiple of 8"):
        steps.frvsr_train_step(state, bad, cfg_g=cfg, tcfg=tcfg,
                               sched_g=sched)
    ok = {"gt": torch.from_numpy((rng.random((1, 3, 40, 40, 3)) * 255)
                                 .astype(np.uint8))}
    with pytest.raises(ValueError, match="pixel_crit"):
        steps.frvsr_train_step(state, ok, cfg_g=cfg,
                               tcfg=tcfg._replace(pixel_crit=None),
                               sched_g=sched)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("model", ["frvsr", "tecogan"])
def test_train_step_numerics(rng, model, mixed):
    """An fp32 step runs its convolutions with TF32 off and restores the
    caller's setting after it; a mixed step leaves the setting as it was.
    A forward pre-hook on a generator conv records
    ``torch.backends.cudnn.allow_tf32`` where the step's convolutions run."""
    from tecogan_tpu_torch.models.networks import (VGG19, DTrunk,
                                                   STNetConfig)

    _, cfg, net = _nets()
    tcfg = _tcfgs(mixed)[1]
    opt, sched = schedules.make_adam({"lr": 1e-4}, net.parameters())
    gt = torch.from_numpy(
        (rng.random((1, 2, 40, 40, 3)) * 255).astype(np.uint8))
    if model == "frvsr":
        state = steps.frvsr_init_state(net, opt)
        run = functools.partial(steps.frvsr_train_step, state, {"gt": gt},
                                cfg_g=cfg, tcfg=tcfg, sched_g=sched)
    else:
        cfg_d = STNetConfig(spatial_size=32)
        net_d = DTrunk.random(cfg_d, torch.Generator().manual_seed(1))
        opt_d, sched_d = schedules.make_adam({"lr": 1e-4},
                                             net_d.parameters())
        state = steps.tecogan_init_state(net, net_d, opt, opt_d)
        gan = tcfg._replace(tempo_extent=2, crop_border_ratio=0.75,
                            pingpong_crit=_CB,
                            gan_crit={"type": "GAN", "weight": 0.01})
        run = functools.partial(
            steps.tecogan_train_step, state, {"gt": gt}, cfg_g=cfg,
            cfg_d=cfg_d, tcfg=gan, sched_g=sched, sched_d=sched_d,
            vgg=VGG19.random(torch.Generator().manual_seed(2)))
    conv = next(m for m in net.modules()
                if isinstance(m, torch.nn.Conv2d))
    seen = []
    hook = conv.register_forward_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        run()
        assert seen and set(seen) == {mixed}, seen
        assert cudnn.allow_tf32 is True
    finally:
        hook.remove()
        cudnn.allow_tf32 = saved


def test_prepare_bd_batch_matches_jax(rng):
    gt = rng.random((2, 3, 40, 44, 3)).astype(np.float32)
    jg, jl = jsteps.prepare_bd_batch(jnp.asarray(gt), 4, 1.5)
    tg, tl = steps.prepare_bd_batch(torch.from_numpy(gt), 4, 1.5)
    assert tuple(tl.shape) == jl.shape == (2, 3, 8, 9, 3)
    assert tuple(tg.shape) == jg.shape == (2, 3, 32, 36, 3)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)


# ------------------------------------------------------ weights and files

@pytest.mark.parametrize("scale", [4, 2])
def test_jax_from_state_dict_matches_convert_frnet(scale):
    params = jax.tree.map(np.array, init_frnet(
        jax.random.PRNGKey(4), JCfg(nf=_NF, nb=_NB, scale=scale)))
    sd = state_dict_from_jax(params, _NB, scale)
    want = jconvert.convert_frnet({k: v.numpy() for k, v in sd.items()},
                                  _NB, scale)
    got = jax_from_state_dict(sd, _NB, scale)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert a.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    back = state_dict_from_jax(got, _NB, scale)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_from_state_dict_copies_the_weights():
    """Training a net built from a state dict leaves the dict as it was."""
    _, cfg, net = _nets()
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    trained = FRNet.from_state_dict(cfg, sd)
    with torch.no_grad():
        for p in trained.parameters():
            p.add_(1.0)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k


def _train_opt(tmp_path, nf=_NF):
    return {
        "scale": _S, "manual_seed": 0, "device_ids": [], "is_train": True,
        "dataset": {"degradation": {"type": "BD", "sigma": 1.5}},
        "model": {"name": "FRVSR", "generator": {
            "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": nf, "nb": _NB}},
        "train": {"tempo_extent": 3, "ckpt_dir": str(tmp_path),
                  "mixed_precision": False, "pixel_crit": _CB,
                  "warping_crit": _CB,
                  "generator": {"lr": 1e-3, "betas": [0.9, 0.999],
                                "lr_schedule": {"type": "MultiStepLR",
                                                "milestones": [1],
                                                "gamma": 0.5}}},
        "logger": {"decay": 0.9},
    }


def test_vsr_model_train_save_and_resume(tmp_path, rng):
    """VSRModel's training entry points on the CPU: two steps, the JAX
    layout G_iter file, the full-state file and a fresh model's resume."""
    opt = _train_opt(tmp_path)
    model = VSRModel(opt)
    w0 = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    assert model.get_learning_rate() == {"lr_G": 1e-3}
    for _ in range(2):
        batch = model.prepare_training_data(
            {"gt": (rng.random((2, 3, 40, 40, 3)) * 255).astype(np.uint8)})
        logs = model.train(batch)
    assert set(logs) == set(steps.FRVSR_LOG_KEYS)
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert model.state["step"] == 2
    assert model.get_learning_rate() == {"lr_G": 5e-4}
    assert any(not torch.equal(w0[k], v)
               for k, v in model.net_g.state_dict().items())
    running = model.get_running_log(model.state)
    assert set(running) == set(steps.FRVSR_LOG_KEYS)

    model.save(2)
    model.save_training_state_now(2)
    tree = jckpt.load_pytree(os.path.join(tmp_path, "G_iter2.npz"))
    want = jax_from_state_dict(model.net_g.state_dict(), _NB, _S)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)

    fresh = VSRModel(opt)
    state, resumed = fresh.try_resume(fresh.state)
    assert resumed and state["step"] == 2
    for k, v in model.net_g.state_dict().items():
        assert torch.equal(fresh.net_g.state_dict()[k], v), k
    a, b = model.state["opt_g"].state_dict(), state["opt_g"].state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in a["state"].items():
        for k, v in s.items():
            assert torch.equal(b["state"][i][k], v), (i, k)
    assert fresh.get_running_log(state) == running
    # the resumed model takes the same next step as the original
    batch = model.prepare_training_data(
        {"gt": (rng.random((2, 3, 40, 40, 3)) * 255).astype(np.uint8)})
    la, lb = model.train(batch), fresh.train(batch)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_try_resume_rejects_other_widths(tmp_path, rng):
    model = VSRModel(_train_opt(tmp_path))
    model.save_training_state_now(1)
    wider = VSRModel(_train_opt(tmp_path, nf=_NF * 2))
    with pytest.raises(ValueError, match="does not match"):
        wider.try_resume(wider.state)
    # nothing to resume from: the state comes back untouched
    empty = VSRModel(_train_opt(tmp_path / "none"))
    state, resumed = empty.try_resume(empty.state)
    assert not resumed and state is empty.state
