"""The FRVSR training step (port of ``tecogan_tpu/models/steps.py``'s FRVSR
half).

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
keep some ops in fp32 and cast op by op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..nn import cast_params
from ..ops.degrade import bd_border_size, downsample_bd
from ..ops.warp_vjp import backward_warp_diff
from .losses import define_criterion
from .networks import forward_sequence

__all__ = ["TrainConfig", "make_train_config", "normalize_batch",
           "prepare_bd_batch", "FRVSR_LOG_KEYS", "frvsr_train_step",
           "frvsr_init_state"]


class TrainConfig(NamedTuple):
    """Static FRVSR training configuration distilled from the YAML opt."""
    scale: int
    degradation: str  # 'BD' | 'BI'
    sigma: float
    # criterion configs (None = disabled), as plain dicts from the YAML
    pixel_crit: dict | None
    warping_crit: dict | None
    # bf16 forward/backward with fp32 master weights; the YAML default
    # (make_train_config) is on, a directly built config is fp32
    mixed_precision: bool = False


def make_train_config(opt) -> TrainConfig:
    t = opt["train"]

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


def _ema_update(running, current, decay: float, step: int):
    """EMA of the log dict on the device (reference
    `base_model.py:170-183`); step 0 takes the current values."""
    if step == 0:
        return {k: current[k].float() for k in running}
    return {k: decay * running[k] + (1.0 - decay) * current[k].float()
            for k in running}


FRVSR_LOG_KEYS = ("l_pix_G", "l_warp_G")


def frvsr_train_step(state, batch, *, cfg_g, tcfg: TrainConfig, sched_g,
                     log_decay: float = 0.99):
    """One FRVSR iteration (`vsr_model.py:61-95`): pixel + warping loss.

    ``state`` is ``frvsr_init_state``'s dict; its net and optimizer are
    updated in place and its step and running log replaced. ``batch``
    holds device tensors {'gt': (n, t, H, W, c)[, 'lr': (n, t, h, w, c)]},
    uint8 or float. Update k uses the lr ``sched_g(k)``. Returns (state,
    logs), the logs 0-d fp32 device tensors.
    """
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
    warp_w = tcfg.warping_crit.get("weight", 1.0) if tcfg.warping_crit else 0.0

    net, opt = state["g"], state["opt_g"]
    params = dict(net.named_parameters())
    if tcfg.mixed_precision:
        params = cast_params(params, dt)
    out = forward_sequence(net, lr, cfg_g, params)
    l_pix = pix_w * pix_crit(out["hr_data"], gt)
    logs = {"l_pix_G": l_pix}
    loss = l_pix
    if warp_crit is not None:
        l_warp = warp_w * _warp_loss(warp_crit, out)
        loss = loss + l_warp
        logs["l_warp_G"] = l_warp

    opt.zero_grad(set_to_none=True)
    loss.backward()
    step = state["step"]
    for group in opt.param_groups:
        group["lr"] = sched_g(step)
    opt.step()

    logs = {k: v.detach() for k, v in logs.items()}
    for k in FRVSR_LOG_KEYS:
        logs.setdefault(k, torch.zeros((), dtype=torch.float32,
                                       device=l_pix.device))
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
