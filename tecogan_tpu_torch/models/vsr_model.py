"""VSRModel — FRVSR inference (port of the test-mode half of
``tecogan_tpu/models/vsr_model.py``). One device; training, spatial
partitioning and multi-process runs are not ported yet and raise."""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..utils import ckpt as ckpt_io
from .base import BaseVSRModel
from .networks import define_generator, infer_sequence

_log = logging.getLogger(__name__)


class VSRModel(BaseVSRModel):
    def __init__(self, opt, device: torch.device | None = None):
        if opt.get("is_train", False):
            raise NotImplementedError("training is not ported yet")
        if opt.get("test", {}).get("spatial_partition", False):
            raise NotImplementedError(
                "test.spatial_partition is not ported yet")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "multi-process inference is not ported yet")
        super().__init__(opt, device)
        self.cfg_g, build = define_generator(opt)
        gen = torch.Generator().manual_seed(opt.get("manual_seed", 2021))
        self.net_g = build(gen, self.device).to(self.cfg_g.dtype)
        load_path = opt["model"]["generator"].get("load_path")
        if load_path:
            self.load_generator(load_path)

    def load_generator(self, load_path: str):
        """Swap in another generator checkpoint (``.npz`` or ``.pth``);
        keys or shapes that do not match the configured net raise."""
        sd = ckpt_io.load_generator_params(load_path, self.cfg_g.nb,
                                           self.cfg_g.scale)
        self.net_g.load_state_dict(sd, strict=True)
        _log.info("Load generator from: %s", load_path)

    def infer(self, lr_data, chunk: int = 16) -> np.ndarray:
        """LR sequence (t, h, w, c) float -> SR uint8 (t, sh, sw, c).

        Front-pads the sequence to warm up the recurrent state, then trims
        (`vsr_model.py:97-113`).
        """
        lr = torch.as_tensor(lr_data, device=self.device)
        lr, n_pad = self.pad_sequence(lr)
        hr = infer_sequence(self.net_g, lr, self.cfg_g, chunk)
        return hr[n_pad:].cpu().numpy()
