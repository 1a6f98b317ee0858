"""VSRModel — FRVSR trainer and inferencer (port of
``tecogan_tpu/models/vsr_model.py``). Training runs on one device a
process (data parallelism: ``parallel.dist``, the step's reductions in
``steps.py``); inference on one device or, under
``test.spatial_partition: true``, with one stream's rows sharded over the
model's devices (``networks.infer_sequence_sp``)."""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from ..utils import ckpt as ckpt_io
from .base import BaseVSRModel, inference_numerics
from .convert import jax_from_state_dict
from ..parallel import dist
from .networks import (BasicVSRPPConfig, define_generator, infer_clip_batch,
                       infer_sequence, infer_sequence_sp)
from .networks.basicvsrpp import read_state_dict
from .schedules import make_adam
from .steps import frvsr_init_state, frvsr_train_step, make_train_config

_log = logging.getLogger(__name__)


class VSRModel(BaseVSRModel):
    """FRVSR's trainer and inferencer; in test mode also the inferencer of
    BasicVSR++ (generator ``BasicVSRPP``), which cannot be trained here
    yet."""

    def __init__(self, opt, device: torch.device | None = None):
        super().__init__(opt, device)
        self.cfg_g, build = define_generator(opt)
        self.whole_clip = isinstance(self.cfg_g, BasicVSRPPConfig)
        if self.whole_clip and self.is_train:
            raise NotImplementedError(
                "training BasicVSR++ (generator BasicVSRPP) is not supported "
                "yet: its DCN has no backward; use --mode test")
        gen = torch.Generator().manual_seed(opt.get("manual_seed", 2021))
        self.net_g = build(gen, self.device)
        if not self.is_train:
            self.net_g = self.net_g.to(self.cfg_g.dtype)
        load_path = opt["model"]["generator"].get("load_path")
        if load_path:
            self.load_generator(load_path)
        if self.is_train:
            # the net stays fp32: its parameters are the master weights
            # that mixed precision casts to bf16 for each forward
            self.tcfg = make_train_config(opt)
            self._init_training(opt)

    def _init_training(self, opt):
        """The FRVSR step's optimizer, state and step function."""
        opt_g, self.sched_g = make_adam(opt["train"]["generator"],
                                        self.net_g.parameters())
        self.state = frvsr_init_state(self.net_g, opt_g)
        self.sync_replicas(self.state)
        self._train_step = functools.partial(
            frvsr_train_step, cfg_g=self.cfg_g, tcfg=self.tcfg,
            sched_g=self.sched_g, log_decay=self.log_decay)

    def load_generator(self, load_path: str):
        """Swap in another generator checkpoint (``.npz`` or ``.pth``);
        keys or shapes that do not match the configured net raise."""
        if self.whole_clip:
            sd = self.net_g.port_state_dict(read_state_dict(load_path))
        else:
            sd = ckpt_io.load_generator_params(load_path, self.cfg_g.nb,
                                               self.cfg_g.scale)
        self.net_g.load_state_dict(sd, strict=True)
        _log.info("Load generator from: %s", load_path)

    # ------------------------------------------------------------------ train
    def train(self, batch) -> dict:
        """One optimisation step on a device batch
        (``prepare_training_data``); returns the log dict of 0-d device
        tensors."""
        self.state, logs = self._train_step(self.state, batch)
        return logs

    def get_learning_rate(self) -> dict:
        """The lr the next update uses."""
        return {"lr_G": float(self.sched_g(self.state["step"]))}

    # ------------------------------------------------------------------ infer
    def sp_devices(self, h: int) -> list | None:
        """The devices to shard an h-row LR frame's rows over, or None.

        Opt-in via ``test.spatial_partition: true``
        (``tecogan_tpu/models/vsr_model.py:66-91``): the largest k of the
        model's devices with ``h % k == 0`` and ``(h / k) % 8 == 0``; with
        none, a log line and the one-device path. Single-process only: a
        data-parallel test run gives each rank whole sequences.
        """
        if not self.opt.get("test", {}).get("spatial_partition", False):
            return None
        if dist.world() > 1 or len(self.devices) < 2:
            return None
        for k in range(len(self.devices), 1, -1):
            if h % k == 0 and (h // k) % 8 == 0:
                return self.devices[:k]
        _log.info("spatial_partition: no device count in [2, %d] divides "
                  "h=%d into /8 row blocks; using one device",
                  len(self.devices), h)
        return None

    def infer(self, lr_data, chunk: int = 16) -> np.ndarray:
        """LR sequence (t, h, w, c) float -> SR uint8 (t, sh, sw, c).

        Front-pads the sequence to warm up the recurrent state, then trims
        (`vsr_model.py:97-113`). A float32 generator runs with TF32 off and
        cuDNN's deterministic algorithms (``inference_numerics``). Under
        ``test.spatial_partition`` the rows are sharded (``sp_devices``).
        BasicVSR++ runs the (padded) sequence whole
        (``infer_clip_batch``).
        """
        lr = torch.as_tensor(lr_data, device=self.device)
        lr, n_pad = self.pad_sequence(lr)
        devices = None if self.whole_clip else self.sp_devices(lr.shape[1])
        with inference_numerics(self.cfg_g.compute_dtype):
            if self.whole_clip:
                hr = infer_clip_batch(self.net_g, lr[None], self.cfg_g)[0]
            elif devices is not None:
                hr = infer_sequence_sp(self.net_g, lr, self.cfg_g, devices,
                                       chunk)
            else:
                hr = infer_sequence(self.net_g, lr, self.cfg_g, chunk)
            return hr[n_pad:].cpu().numpy()

    # ------------------------------------------------------------------- save
    def save(self, current_iter):
        """Generator weights -> ``G_iter{N}.npz`` in the JAX package's
        layout."""
        params = jax_from_state_dict(self.net_g.state_dict(),
                                     self.cfg_g.nb, self.cfg_g.scale)
        self.save_pytree(params, f"G_iter{current_iter}.npz")

    def save_training_state_now(self, current_iter):
        self.save_training_state(self.state, current_iter)
