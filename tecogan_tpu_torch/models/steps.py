"""The training steps: FRVSR's pixel-loss step and TecoGAN's GAN step (port
of ``tecogan_tpu/models/steps.py``).

One step ``frvsr_train_step(state, batch)`` normalises the uint8 batch on
the device, applies the BD degradation with its GT border crop, runs the
training unroll (``networks.forward_sequence``), takes the Charbonnier
pixel and warping losses, backpropagates through the recurrence and every
warp (K3/K4), takes one Adam step and updates the EMA log. It reads nothing
back to the host: the logs stay 0-d fp32 tensors on the device.

Mixed precision (``train.mixed_precision``, on by default in the YAML) is
the JAX package's: every floating parameter is cast to bf16 for the forward
and the inputs are bf16, while the master weights, the optimizer state and
the loss accumulation stay fp32. It is not ``torch.autocast``, which would
keep some ops in fp32 and cast op by op. An fp32 step
(``mixed_precision: false``) runs with TF32 off (``nn.training_numerics``,
entered by the steps themselves, so every caller gets it) and restores the
caller's settings after.

``tecogan_train_step`` follows `vsrgan_model.py:98-286` in the JAX
package's order: the generator runs once; the D inputs are assembled once
(the real one without a graph, the fake one with it); the discriminator
runs on the real input, then on the fake one (two forwards, each with its
own BatchNorm statistics) and updates first, and only when the adaptive
vote passes; the generator's losses are then taken against the updated
discriminator, whose third forward moves the BatchNorm running stats a
third time.

While a profiler records, each step is the span ``tecogan.train.step``
(its args: the step index) over the spans of its phases, in order:
``train.g_forward`` (the batch's normalisation and degradation, the
generator's unroll, and TecoGAN's bicubic frames, flow merge and D inputs),
TecoGAN's ``train.d_forward`` (D's two forwards and the vote's reductions),
``train.vote`` (the vote's host read alone) and ``train.d_update`` (D's
backward and Adam, when the vote passes), then ``train.g_losses`` (for
TecoGAN VGG19 and D's third forward among them), ``train.g_backward`` and
``train.g_update`` (the learning rate, Adam and the logs); see
``utils/tracing.py``.

In a data-parallel run (``parallel.dist``, one process per device) each
rank runs the step on its rows of the global batch, and the step keeps the
JAX package's global semantics: each backward's gradients are averaged
over the ranks before the optimizer step (one all-reduce of a flat buffer,
``dist.average_gradients``), D's BatchNorm takes the global batch's
statistics (``nn.batch_norm``), the vote reads the distance of the
all-reduced means, so every rank takes the same branch, and every logged
value is the global mean before the running log's decay. In one process
none of this runs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.func import functional_call

from ..nn import cast_params, conv_format, training_numerics
from ..ops.degrade import bd_border_size, downsample_bd
from ..ops.warp_vjp import backward_warp_diff
from ..parallel import dist
from ..utils import tracing
from .losses import define_criterion
from .networks import (STNetConfig, build_d_input, build_flow_merge,
                       forward_sequence)

__all__ = ["TrainConfig", "make_train_config", "normalize_batch",
           "prepare_bd_batch", "FRVSR_LOG_KEYS", "frvsr_train_step",
           "frvsr_init_state", "TECOGAN_LOG_KEYS", "tecogan_train_step",
           "tecogan_init_state"]


class TrainConfig(NamedTuple):
    """Static training configuration distilled from the YAML opt."""
    scale: int
    degradation: str  # 'BD' | 'BI'
    sigma: float
    # criterion configs (None = disabled), as plain dicts from the YAML
    pixel_crit: dict | None
    warping_crit: dict | None
    # bf16 forward/backward with fp32 master weights; the YAML default
    # (make_train_config) is on, a directly built config is fp32
    mixed_precision: bool = False
    # the GAN step's: the clip length before ping-pong doubling, the
    # remaining criteria, the discriminator's update policy and the STNet
    # input's border crop (1.0: none), with the JAX package's defaults
    tempo_extent: int = 10
    feature_crit: dict | None = None
    pingpong_crit: dict | None = None
    feature_matching_crit: dict | None = None
    gan_crit: dict | None = None
    update_policy: str = "adaptive"
    update_threshold: float = 0.4
    crop_border_ratio: float = 1.0


def make_train_config(opt) -> TrainConfig:
    t = opt["train"]
    d_opt = t.get("discriminator", {})

    def crit(name):
        c = t.get(name)
        return dict(c) if c else None

    return TrainConfig(
        scale=opt["scale"],
        degradation=opt["dataset"]["degradation"]["type"],
        sigma=opt["dataset"]["degradation"].get("sigma", 1.5),
        pixel_crit=crit("pixel_crit"),
        warping_crit=crit("warping_crit"),
        mixed_precision=t.get("mixed_precision", True),
        tempo_extent=t.get("tempo_extent", 10),
        feature_crit=crit("feature_crit"),
        pingpong_crit=crit("pingpong_crit"),
        feature_matching_crit=crit("feature_matching_crit"),
        gan_crit=crit("gan_crit"),
        update_policy=d_opt.get("update_policy", "adaptive"),
        update_threshold=d_opt.get("update_threshold", 0.4),
        crop_border_ratio=d_opt.get("crop_border_ratio", 1.0),
    )


def normalize_batch(batch, compute_dtype=torch.float32):
    """uint8 batches are normalised on the device (a quarter of the
    host-to-device bytes); the division runs in the compute dtype."""
    def norm(x):
        if x.dtype == torch.uint8:
            return x.to(compute_dtype) / 255.0
        return x.to(compute_dtype)

    return {k: norm(v) for k, v in batch.items()}


def prepare_bd_batch(gt: torch.Tensor, scale: int, sigma: float):
    """On-device BD degradation of a (n, t, Hb, Wb, c) GT batch.

    Returns (gt_cropped, lr), both (n, t, ., ., c): the Gaussian blur +
    stride-s downsample is a valid convolution, and the GT border it
    consumed is cropped away (`base_model.py:55-85`).
    """
    b = bd_border_size(sigma)
    lr = downsample_bd(gt.movedim(-1, -3), scale, sigma=sigma,
                       pad_data=False).movedim(-3, -1)
    lh, lw = lr.shape[-3], lr.shape[-2]
    gt = gt[..., b:b + scale * lh, b:b + scale * lw, :]
    return gt, lr


def _check_train_crop(lh: int, lw: int):
    """Training LR crops must be multiples of 8: FNet's pooling floors
    other sizes, and the warping loss's shapes would then disagree deep
    inside the step. Fail at the step boundary, naming the knob."""
    if lh % 8 or lw % 8:
        raise ValueError(
            f"training LR crop {lh}x{lw} is not a multiple of 8; pick a "
            f"dataset crop_size whose LR (crop/scale, after the BD border "
            f"for on-the-fly BD) is divisible by 8 — e.g. the reference's "
            f"128")


def _warp_loss(crit, out):
    """The previous LR frame (data: no image gradient) warped along the LR
    flow, against the current frame."""
    lr_warp = backward_warp_diff(out["lr_prev"].permute(0, 3, 1, 2),
                                 out["lr_flow"])
    return crit(lr_warp, out["lr_curr"].permute(0, 3, 1, 2))


def _global_logs(logs: dict) -> dict:
    """Each 0-d log value as its mean over the ranks, in one all-reduce
    (the values as they are in one process)."""
    if dist.world() == 1:
        return logs
    keys = list(logs)
    means = dist.all_reduce_mean(torch.stack([logs[k].float()
                                              for k in keys]))
    return dict(zip(keys, means.unbind()))


def _ema_update(running, current, decay: float, step: int):
    """EMA of the log dict on the device (reference
    `base_model.py:170-183`); step 0 takes the current values."""
    if step == 0:
        return {k: current[k].float() for k in running}
    return {k: decay * running[k] + (1.0 - decay) * current[k].float()
            for k in running}


FRVSR_LOG_KEYS = ("l_pix_G", "l_warp_G")


def _under_training_numerics(step):
    """Run ``step`` (forward, backward and optimizer step) under
    ``training_numerics`` for its ``tcfg.mixed_precision``."""
    @functools.wraps(step)
    def run(state, batch, *, tcfg, **kw):
        with training_numerics(tcfg.mixed_precision), tracing.span(
                "train.step", {"step": state["step"]}):
            return step(state, batch, tcfg=tcfg, **kw)
    return run


@_under_training_numerics
def frvsr_train_step(state, batch, *, cfg_g, tcfg: TrainConfig, sched_g,
                     log_decay: float = 0.99):
    """One FRVSR iteration (`vsr_model.py:61-95`): pixel + warping loss.

    ``state`` is ``frvsr_init_state``'s dict; its net and optimizer are
    updated in place and its step and running log replaced. ``batch``
    holds device tensors {'gt': (n, t, H, W, c)[, 'lr': (n, t, h, w, c)]},
    uint8 or float. Update k uses the lr ``sched_g(k)``. Returns (state,
    logs), the logs 0-d fp32 device tensors.
    """
    with tracing.span("train.g_forward"):
        dt = torch.bfloat16 if tcfg.mixed_precision else torch.float32
        batch = normalize_batch(batch, dt)
        if tcfg.degradation == "BD" and "lr" not in batch:
            gt, lr = prepare_bd_batch(batch["gt"], tcfg.scale, tcfg.sigma)
        else:
            gt, lr = batch["gt"], batch["lr"]
        _check_train_crop(lr.shape[-3], lr.shape[-2])

        pix_crit = define_criterion(tcfg.pixel_crit)
        if pix_crit is None:
            # FRVSR without a pixel loss has no training signal at all
            raise ValueError(
                "FRVSR training requires train.pixel_crit (reference "
                "vsr_model.py:61-95 always defines it)")
        warp_crit = define_criterion(tcfg.warping_crit)
        pix_w = tcfg.pixel_crit.get("weight", 1.0)
        warp_w = (tcfg.warping_crit.get("weight", 1.0) if tcfg.warping_crit
                  else 0.0)

        net, opt = state["g"], state["opt_g"]
        params = dict(net.named_parameters())
        if tcfg.mixed_precision:
            params = cast_params(params, dt, conv_format(dt))
        out = forward_sequence(net, lr, cfg_g, params)
    with tracing.span("train.g_losses"):
        l_pix = pix_w * pix_crit(out["hr_data"], gt)
        logs = {"l_pix_G": l_pix}
        loss = l_pix
        if warp_crit is not None:
            l_warp = warp_w * _warp_loss(warp_crit, out)
            loss = loss + l_warp
            logs["l_warp_G"] = l_warp
    with tracing.span("train.g_backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        dist.average_gradients(net.parameters())
    with tracing.span("train.g_update"):
        step = state["step"]
        for group in opt.param_groups:
            group["lr"] = sched_g(step)
        opt.step()

        logs = {k: v.detach() for k, v in logs.items()}
        for k in FRVSR_LOG_KEYS:
            logs.setdefault(k, torch.zeros((), dtype=torch.float32,
                                           device=l_pix.device))
        logs = _global_logs(logs)
        state["step"] = step + 1
        state["running_log"] = _ema_update(state["running_log"], logs,
                                           log_decay, step)
    return state, logs


def frvsr_init_state(net, opt_g) -> dict:
    """Training state: the fp32 net, its optimizer, the host step count
    and the device-side EMA log."""
    device = next(net.parameters()).device
    return {
        "g": net,
        "opt_g": opt_g,
        "step": 0,
        "running_log": {k: torch.zeros((), dtype=torch.float32,
                                       device=device)
                        for k in FRVSR_LOG_KEYS},
    }


# --------------------------------------------------------------------------
# TecoGAN step
# --------------------------------------------------------------------------

TECOGAN_LOG_KEYS = (
    "l_gan_D", "p_real_D", "p_fake_D", "distance", "n_upd_D",
    "l_pix_G", "l_warp_G", "l_feat_G", "l_pp_G", "l_fm_G", "l_gan_G",
    "p_fake_G",
)


def _dbl(x: torch.Tensor) -> torch.Tensor:
    """Ping-pong doubling along the time axis: frames 0..t-1, t-2..0
    (`vsrgan_model.py:112-119`)."""
    return torch.cat([x, x.flip(1)[:, 1:]], dim=1)


def _d_params(net_d, dt: torch.dtype, mixed: bool, detach: bool = False):
    """D's parameters for a forward: under mixed precision the conv and
    dense weights in the compute dtype and BatchNorm's scale and bias in
    fp32 (the JAX package's ``_cast_d``); ``detach``: without a graph to
    the masters."""
    bn = net_d.bn_parameter_names()
    params = {}
    for k, v in net_d.named_parameters():
        v = v.detach() if detach else v
        params[k] = v.to(dt) if mixed and k not in bn else v
    return params


@_under_training_numerics
def tecogan_train_step(state, batch, *, cfg_g, cfg_d, tcfg: TrainConfig,
                       sched_g, sched_d, vgg=None, log_decay: float = 0.99):
    """One TecoGAN iteration (`vsrgan_model.py:98-286`).

    ``state`` is ``tecogan_init_state``'s dict: its nets and optimizers are
    updated in place, its step, update count and running log replaced.
    ``batch`` as ``frvsr_train_step``'s. ``vgg``: the frozen ``VGG19`` of
    the perceptual loss (required when ``tcfg.feature_crit`` is set).
    G's update k uses the lr ``sched_g(k)``; D's update in step k uses
    ``sched_d(k)``, the global step, however many updates the vote skipped.
    Under ``update_policy: adaptive`` the vote is read back to the host (one
    device sync a step) to decide whether D's backward and Adam step run;
    a skipped step leaves D's weights and Adam state as they were. Returns
    (state, logs), the logs 0-d fp32 device tensors.
    """
    with tracing.span("train.g_forward"):
        dt = torch.bfloat16 if tcfg.mixed_precision else torch.float32
        mixed = tcfg.mixed_precision
        batch = normalize_batch(batch, dt)
        if tcfg.degradation == "BD" and "lr" not in batch:
            gt, lr = prepare_bd_batch(batch["gt"], tcfg.scale, tcfg.sigma)
        else:
            gt, lr = batch["gt"], batch["lr"]
        n, t, lh, lw, c = lr.shape
        _check_train_crop(lh, lw)
        gh, gw = gt.shape[2], gt.shape[3]

        pix_crit = define_criterion(tcfg.pixel_crit)
        warp_crit = define_criterion(tcfg.warping_crit)
        feat_crit = define_criterion(tcfg.feature_crit)
        pp_crit = define_criterion(tcfg.pingpong_crit)
        fm_crit = define_criterion(tcfg.feature_matching_crit)
        gan_crit = define_criterion(tcfg.gan_crit)
        if gan_crit is None:
            raise ValueError(
                "TecoGAN training requires train.gan_crit (reference "
                "vsrgan_model.py:147-198 always defines it); train without a "
                "discriminator by using model.name: FRVSR instead")
        if feat_crit is not None and vgg is None:
            raise ValueError("train.feature_crit needs the VGG19 (vgg=)")
        use_pp = pp_crit is not None
        net_g, net_d = state["g"], state["d"]
        opt_g, opt_d = state["opt_g"], state["opt_d"]
        step = state["step"]

        # the bicubic-conditioned frames for D (`vsrgan_model.py:105-108`),
        # (n, t, c, H, W)
        with torch.no_grad():
            bi = net_g.srnet.upsample(
                lr.permute(0, 1, 4, 2, 3).reshape(n * t, c, lh, lw)).reshape(
                    n, t, c, gh, gw)
        if use_pp:
            lr, gt, bi = _dbl(lr), _dbl(gt), _dbl(bi)

        # === G forward, once: the D phase and the G losses share it ===
        params_g = dict(net_g.named_parameters())
        if mixed:
            params_g = cast_params(params_g, dt, conv_format(dt))
        out = forward_sequence(net_g, lr, cfg_g, params_g)
        hr = out["hr_data"]
        hr_c, gt_c = hr.permute(0, 1, 4, 2, 3), gt.permute(0, 1, 4, 2, 3)
        ctx = {"bi_data": bi, "crop_border_ratio": tcfg.crop_border_ratio}
        if isinstance(cfg_d, STNetConfig):
            ctx["flow_merge"] = build_flow_merge(out["hr_flow"], lr, net_g,
                                                 params_g, use_pp)

        # the D inputs, each assembled once: the real one without a graph, the
        # fake one with it (detached for the D phase, whole for the G phase)
        with torch.no_grad():
            x_real = build_d_input(gt_c, ctx, cfg_d)
        x_fake_g = build_d_input(hr_c, ctx, cfg_d)

    # === D phase: two forwards, the vote, then the update if it passes ===
    with tracing.span("train.d_forward"):
        pd = _d_params(net_d, dt, mixed)
        real_logits, real_feats = functional_call(net_d, pd, (x_real,))
        fake_logits, _ = functional_call(net_d, pd, (x_fake_g.detach(),))
        loss_d = gan_crit(real_logits, True) + gan_crit(fake_logits, False)
        with torch.no_grad():
            # the vote reads the global means, so every rank takes one branch
            rl32, fl32 = real_logits.float(), fake_logits.float()
            logged = dist.all_reduce_mean(torch.stack([
                torch.log(torch.sigmoid(rl32) + 1e-8).mean(),
                torch.log(torch.sigmoid(fl32) + 1e-8).mean()]))
            distance = logged[0] - logged[1]
    with tracing.span("train.vote"):
        upd_d = (tcfg.update_policy != "adaptive"
                 or bool(distance < tcfg.update_threshold))
    if upd_d:
        with tracing.span("train.d_update"):
            opt_d.zero_grad(set_to_none=True)
            loss_d.backward()
            dist.average_gradients(net_d.parameters())
            for group in opt_d.param_groups:
                group["lr"] = sched_d(step)
            opt_d.step()
            l_gan_d = loss_d.detach()
            state["cnt_upd_d"] = state["cnt_upd_d"] + 1.0
    else:
        l_gan_d = torch.zeros((), dtype=torch.float32, device=hr.device)
    real_feats = [f.detach() for f in real_feats]
    del loss_d, real_logits, fake_logits, pd

    # === G phase: the losses against the UPDATED discriminator ===
    with tracing.span("train.g_losses"):
        logs = {}
        loss = 0.0
        if pix_crit is not None:
            logs["l_pix_G"] = tcfg.pixel_crit.get("weight", 1) * pix_crit(
                hr, gt)
            loss = loss + logs["l_pix_G"]
        if warp_crit is not None:
            logs["l_warp_G"] = tcfg.warping_crit.get("weight", 1) * _warp_loss(
                warp_crit, out)
            loss = loss + logs["l_warp_G"]
        if feat_crit is not None:
            layers = tuple(tcfg.feature_crit.get("feature_layers",
                                                 [8, 17, 26, 35]))
            t_all = hr.shape[1]
            params_v = dict(vgg.named_parameters())
            if mixed:
                params_v = cast_params(params_v, dt)
            hr_f = functional_call(vgg, params_v, (
                hr_c.reshape(n * t_all, c, gh, gw), layers))
            with torch.no_grad():
                if use_pp:
                    # the doubled gt repeats its first te frames mirrored: VGG
                    # runs on the unique ones and their features are doubled
                    te = tcfg.tempo_extent
                    gt_f = [_dbl(f.unflatten(0, (n, te))).flatten(0, 1)
                            for f in functional_call(vgg, params_v, (
                                gt_c[:, :te].reshape(n * te, c, gh, gw),
                                layers))]
                else:
                    gt_f = functional_call(vgg, params_v, (
                        gt_c.reshape(n * t_all, c, gh, gw), layers))
            # the cosine similarity reduces the last axis: the channels
            l_feat = sum(feat_crit(hf.movedim(1, -1), gf.movedim(1, -1))
                         for hf, gf in zip(hr_f, gt_f))
            logs["l_feat_G"] = tcfg.feature_crit.get("weight", 1) * l_feat
            loss = loss + logs["l_feat_G"]
        if pp_crit is not None:
            te = tcfg.tempo_extent
            logs["l_pp_G"] = tcfg.pingpong_crit.get("weight", 1) * pp_crit(
                hr[:, :te - 1], hr[:, te:].flip(1))
            loss = loss + logs["l_pp_G"]
        # D's third forward (its BatchNorm running stats move a third time), on
        # the shared fake input; D's parameters take no gradient
        fake_g_logits, fake_g_feats = functional_call(
            net_d, _d_params(net_d, dt, mixed, detach=True), (x_fake_g,))
        if fm_crit is not None:
            layer_norm = tcfg.feature_matching_crit.get(
                "layer_norm", [12.0, 14.0, 24.0, 100.0])
            l_fm = sum(fm_crit(ff, rf) / ln for ff, rf, ln in
                       zip(fake_g_feats, real_feats, layer_norm))
            logs["l_fm_G"] = tcfg.feature_matching_crit.get("weight", 1) * l_fm
            loss = loss + logs["l_fm_G"]
        logs["l_gan_G"] = tcfg.gan_crit.get("weight", 1) * gan_crit(
            fake_g_logits, True)
        loss = loss + logs["l_gan_G"]
        logs["p_fake_G"] = fake_g_logits.mean()
    with tracing.span("train.g_backward"):
        opt_g.zero_grad(set_to_none=True)
        loss.backward()
        dist.average_gradients(net_g.parameters())
    with tracing.span("train.g_update"):
        for group in opt_g.param_groups:
            group["lr"] = sched_g(step)
        opt_g.step()

        logs = {
            "l_gan_D": l_gan_d,
            # despite the p_ names these are mean raw logits, as the reference
            # logs them (`vsrgan_model.py:194-195`)
            "p_real_D": rl32.mean(),
            "p_fake_D": fl32.mean(),
            "distance": distance,
            "n_upd_D": state["cnt_upd_d"],
            **logs,
        }
        logs = {k: v.detach().float() for k, v in logs.items()}
        for k in TECOGAN_LOG_KEYS:
            logs.setdefault(k, torch.zeros((), dtype=torch.float32,
                                           device=hr.device))
        logs = _global_logs(logs)
        state["step"] = step + 1
        state["running_log"] = _ema_update(state["running_log"], logs,
                                           log_decay, step)
    return state, logs


def tecogan_init_state(net_g, net_d, opt_g, opt_d) -> dict:
    """Training state: the fp32 nets and their optimizers, the host step
    count, D's update count and the EMA log on the device."""
    device = next(net_g.parameters()).device

    def zero():
        return torch.zeros((), dtype=torch.float32, device=device)

    return {
        "g": net_g,
        "d": net_d,
        "opt_g": opt_g,
        "opt_d": opt_d,
        "step": 0,
        "cnt_upd_d": zero(),
        "running_log": {k: zero() for k in TECOGAN_LOG_KEYS},
    }
