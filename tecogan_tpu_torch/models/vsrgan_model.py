"""VSRGANModel — TecoGAN (port of ``tecogan_tpu/models/vsrgan_model.py``).

In test mode a TecoGAN model is its generator only, so it is a
``VSRModel``; the GAN training step (STNet, VGG19, the adaptive D update)
is ROADMAP Queue 1 item 3 and not ported yet.
"""

from __future__ import annotations

import torch

from .vsr_model import VSRModel

__all__ = ["VSRGANModel"]


class VSRGANModel(VSRModel):
    def __init__(self, opt, device: torch.device | None = None):
        if opt.get("is_train", False):
            raise NotImplementedError(
                "TecoGAN training is not ported yet (ROADMAP Queue 1 item "
                "3); test mode runs the generator")
        super().__init__(opt, device)
