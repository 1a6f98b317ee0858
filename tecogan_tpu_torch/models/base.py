"""Model wrapper base, inference half (port of
``tecogan_tpu/models/base.py``): device selection, inference data staging
and temporal front padding."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.degrade import downsample_bd


def select_device(opt) -> torch.device:
    """The one device ``opt['device_ids']`` names.

    ``[]`` is an explicit CPU run; ids map to ``cuda:<id>`` and must exist;
    no ids means ``cuda:0``. Without CUDA and without an explicit ``[]``
    this raises rather than running on the CPU.
    """
    ids = opt.get("device_ids")
    if ids is not None and len(ids) == 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; set device_ids: [] to run on "
                           "the CPU explicitly")
    if not ids:
        return torch.device("cuda", 0)
    count = torch.cuda.device_count()
    bad = [i for i in ids if i >= count or i < 0]
    if bad:
        raise ValueError(f"device ids {bad} out of range: only {count} "
                         f"devices available")
    if len(ids) > 1:
        raise NotImplementedError(
            f"multi-device inference is not ported yet; got device_ids {ids}")
    return torch.device("cuda", ids[0])


class BaseVSRModel:
    def __init__(self, opt, device: torch.device | None = None):
        self.opt = opt
        self.scale = opt["scale"]
        self.device = select_device(opt) if device is None else device

    def prepare_inference_data(self, data) -> torch.Tensor:
        """Sequence dict -> LR float32 (t, h, w, c) on the model's device.

        'lr' frames are taken as they are (float in [0, 1]); BD without an
        LR stream degrades the uint8 'gt' frames on the device with reflect
        padding (`base_model.py:96-119`).
        """
        if "lr" in data:
            return torch.as_tensor(np.asarray(data["lr"], np.float32),
                                   device=self.device)
        degradation = self.opt["dataset"]["degradation"]
        if degradation["type"] != "BD":
            raise ValueError("lr data is required for BI mode")
        gt = torch.as_tensor(np.asarray(data["gt"]), device=self.device)
        gt = gt.float().div_(255.0).permute(0, 3, 1, 2)  # (t, c, H, W)
        lr = downsample_bd(gt, self.scale, sigma=degradation.get("sigma", 1.5),
                           pad_data=True)
        return lr.permute(0, 2, 3, 1).contiguous()

    def pad_sequence(self, lr_data: torch.Tensor):
        """Front-pad (t, h, w, c) frames to warm up the recurrence:
        'reflect' mirrors frames 1..n_pad, 'replicate' repeats frame 0.
        Returns (padded, n_pad)."""
        mode = self.opt["test"].get("padding_mode", "reflect")
        n_pad = self.opt["test"].get("num_pad_front", 0)
        if n_pad >= len(lr_data):
            raise ValueError(f"num_pad_front={n_pad} needs more than "
                             f"{len(lr_data)} frames")
        if n_pad == 0:
            return lr_data, 0
        if mode == "reflect":
            pad = lr_data[1:1 + n_pad].flip(0)
        elif mode == "replicate":
            pad = lr_data[:1].expand(n_pad, *lr_data.shape[1:])
        else:
            raise ValueError(f"Unrecognized padding mode: {mode}")
        return torch.cat([pad, lr_data], dim=0), n_pad
