"""VSRModel — FRVSR trainer and inferencer (port of
``tecogan_tpu/models/vsr_model.py``). One device; spatial partitioning and
multi-process runs are not ported yet and raise."""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from ..utils import ckpt as ckpt_io
from .base import BaseVSRModel, inference_numerics
from .convert import jax_from_state_dict
from .networks import define_generator, infer_sequence
from .schedules import make_adam
from .steps import frvsr_init_state, frvsr_train_step, make_train_config

_log = logging.getLogger(__name__)


class VSRModel(BaseVSRModel):
    def __init__(self, opt, device: torch.device | None = None):
        if opt.get("test", {}).get("spatial_partition", False):
            raise NotImplementedError(
                "test.spatial_partition is not ported yet")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "multi-process runs are not ported yet")
        super().__init__(opt, device)
        self.cfg_g, build = define_generator(opt)
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
            opt_g, self.sched_g = make_adam(opt["train"]["generator"],
                                            self.net_g.parameters())
            self.state = frvsr_init_state(self.net_g, opt_g)
            self._train_step = functools.partial(
                frvsr_train_step, cfg_g=self.cfg_g, tcfg=self.tcfg,
                sched_g=self.sched_g, log_decay=self.log_decay)

    def load_generator(self, load_path: str):
        """Swap in another generator checkpoint (``.npz`` or ``.pth``);
        keys or shapes that do not match the configured net raise."""
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
    def infer(self, lr_data, chunk: int = 16) -> np.ndarray:
        """LR sequence (t, h, w, c) float -> SR uint8 (t, sh, sw, c).

        Front-pads the sequence to warm up the recurrent state, then trims
        (`vsr_model.py:97-113`). A float32 generator runs with TF32 off and
        cuDNN's deterministic algorithms (``inference_numerics``).
        """
        lr = torch.as_tensor(lr_data, device=self.device)
        lr, n_pad = self.pad_sequence(lr)
        with inference_numerics(self.cfg_g.compute_dtype):
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
