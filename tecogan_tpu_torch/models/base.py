"""Model wrapper base (port of ``tecogan_tpu/models/base.py``): device
selection, training and inference data staging, temporal front padding,
the running log and checkpoints.

A model lives on one device. In a data-parallel run that is this rank's
(``parallel.dist``); in one process ``device_ids`` may list several, which
only row-sharded inference (``test.spatial_partition``) spreads over:
training on several devices takes one process each (``main.py`` spawns
them for ``--gpu_ids 0,1``, or torchrun starts them).

Checkpoints: generator weights go to ``G_iter{N}.npz`` in the JAX
package's layout; the full training state (weights, Adam state, step,
running log; for TecoGAN also the discriminator, its Adam state and its
update count) to ``state_iter{N}.pth`` with ``torch.save``, and
``try_resume`` reloads the newest one with ``weights_only=True``.
"""

from __future__ import annotations

import logging
import os
import os.path as osp

import numpy as np
import torch

from ..nn import inference_numerics, select_devices
from ..ops.degrade import downsample_bd
from ..parallel import dist
from ..utils import ckpt as ckpt_io
from ..utils.logging_utils import format_train_msg

# the CLI's logger: the checkpoint and resume lines go to its log, as the
# JAX package's log_info puts them (tecogan_tpu/models/base.py:146,178)
_log = logging.getLogger("base")


class BaseVSRModel:
    def __init__(self, opt, device: torch.device | None = None):
        self.opt = opt
        self.scale = opt["scale"]
        self.devices = (select_devices(opt) if device is None
                        else [torch.device(device)])
        self.device = self.devices[0]
        self.is_train = opt.get("is_train", False)
        if self.is_train and len(self.devices) > 1:
            raise ValueError(
                f"training on device_ids {opt['device_ids']} takes one "
                f"process per device: launch through tecogan_tpu_torch.main "
                f"(--gpu_ids spawns them) or torchrun")
        self.log_decay = opt.get("logger", {}).get("decay", 0.99)
        if self.is_train:
            self.ckpt_dir = opt["train"]["ckpt_dir"]

    def prepare_training_data(self, batch) -> dict:
        """Batch {'gt': (n, t, H, W, c)[, 'lr']}, uint8 as the loaders ship
        it (or float) -> tensors on the model's device. Tensors already
        there (the device-resident loader's) pass through untouched; host
        arrays go to a card from pinned memory without blocking the host.
        Normalisation happens on the device, inside the step."""
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.asarray(v))
            if t.device != self.device:
                if self.device.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            out[k] = t
        return out

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
        with inference_numerics("float32"):
            lr = downsample_bd(gt, self.scale,
                               sigma=degradation.get("sigma", 1.5),
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

    # ------------------------------------------------------------------ logs
    def get_running_log(self, state) -> dict:
        """The EMA log as host floats (one device read per key)."""
        return {k: float(v) for k, v in state["running_log"].items()}

    def get_learning_rate(self) -> dict:
        return {}

    def get_format_msg(self, state, epoch, it) -> str:
        """The JAX package's log line ``[epoch: E | iter: I | lr_G: x(|
        lr_D: y)] l_pix_G: ...`` from ``state``'s running log and the lrs
        the next update uses."""
        return format_train_msg(epoch, it, self.get_learning_rate(),
                                self.get_running_log(state))

    # ----------------------------------------------------------- checkpoints
    def save_pytree(self, tree, filename):
        path = osp.join(self.ckpt_dir, filename)
        ckpt_io.save_pytree(tree, path)
        _log.info("Saved checkpoint: %s", path)

    # the nets a training state may hold, each with its optimizer
    _NETS = (("g", "opt_g"), ("d", "opt_d"))

    def sync_replicas(self, state):
        """Rank 0's weights (and BatchNorm stats) in every net of ``state``
        on every rank: replicas start identical whatever each built or
        loaded. A no-op in one process."""
        for net, _ in self._NETS:
            if net in state:
                dist.broadcast_module(state[net])

    def save_training_state(self, state, current_iter):
        """Full-state checkpoint: weights (with the discriminator's
        BatchNorm stats), optimizers, step, D's update count, running
        log."""
        path = osp.join(self.ckpt_dir, f"state_iter{current_iter}.pth")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        saved = {"step": state["step"],
                 "running_log": dict(state["running_log"])}
        for net, opt in self._NETS:
            if net in state:
                saved[net] = state[net].state_dict()
                saved[opt] = state[opt].state_dict()
        if "cnt_upd_d" in state:
            saved["cnt_upd_d"] = state["cnt_upd_d"]
        torch.save(saved, tmp)
        os.replace(tmp, path)
        _log.info("Saved checkpoint: %s", path)

    def try_resume(self, state):
        """Resume from the newest ``state_iter{N}.pth`` in ckpt_dir, if any.
        Returns (state, resumed). A checkpoint whose nets do not match the
        configured ones (other widths or depth, a missing discriminator)
        raises ValueError."""
        path = ckpt_io.latest_training_state(self.ckpt_dir)
        if path is None:
            return state, False
        # to the host first: the loads below place each tensor (Adam keeps
        # its step counters on the host, so that a step reads no device
        # value back)
        saved = torch.load(path, map_location="cpu", weights_only=True)
        nets = [(net, opt) for net, opt in self._NETS if net in state]
        for net, _ in nets:
            live = state[net].state_dict()
            theirs = saved.get(net, {})
            if set(theirs) != set(live):
                raise ValueError(
                    f"checkpoint {path} does not match the configured "
                    f"model: {net} keys "
                    f"{sorted(set(theirs) ^ set(live))} differ")
            for k, v in live.items():
                if tuple(theirs[k].shape) != tuple(v.shape):
                    raise ValueError(
                        f"checkpoint {path} does not match the configured "
                        f"model: {net} {k} has shape "
                        f"{tuple(theirs[k].shape)}, expected "
                        f"{tuple(v.shape)}")
        for net, opt in nets:
            state[net].load_state_dict(saved[net])
            state[opt].load_state_dict(saved[opt])
        state["step"] = int(saved["step"])
        if "cnt_upd_d" in state:
            state["cnt_upd_d"] = saved["cnt_upd_d"].to(self.device,
                                                       torch.float32)
        state["running_log"] = {
            k: saved["running_log"][k].to(self.device, torch.float32)
            for k in state["running_log"]}
        _log.info("Resumed training state from %s", path)
        return state, True
