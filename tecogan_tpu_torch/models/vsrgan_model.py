"""VSRGANModel — TecoGAN (port of ``tecogan_tpu/models/vsrgan_model.py``).

In test mode a TecoGAN model is its generator only, so it is a
``VSRModel``. In training it adds the discriminator (STNet or SNet) and,
with a perceptual loss, the frozen VGG19, and ``train`` takes one
``steps.tecogan_train_step``: ping-pong doubling, the D input assembled
once, D updated first when the adaptive vote passes, then the generator's
pixel, warping, perceptual, ping-pong, feature-matching and GAN losses
against the updated D.
"""

from __future__ import annotations

import functools
import logging
import os.path as osp

import torch

from ..utils import ckpt as ckpt_io
from . import convert
from .networks import VGG19, DTrunk, define_discriminator
from .schedules import make_adam
from .steps import tecogan_init_state, tecogan_train_step
from .vsr_model import VSRModel

__all__ = ["VSRGANModel"]

_log = logging.getLogger(__name__)


class VSRGANModel(VSRModel):
    def _init_training(self, opt):
        """The discriminator (from ``load_path`` or drawn from the seed + 1),
        the VGG19 when a perceptual loss is configured, G's and D's Adam and
        the GAN step."""
        seed = opt.get("manual_seed", 2021)
        self.cfg_d, build_d = define_discriminator(opt)
        load_path = opt["model"]["discriminator"].get("load_path")
        if load_path:
            self.net_d = self._load_discriminator(load_path)
            _log.info("Load discriminator from: %s", load_path)
        else:
            self.net_d = build_d(torch.Generator().manual_seed(seed + 1),
                                 self.device)
        self.vgg = None
        if self.tcfg.feature_crit is not None:
            self.vgg = self._load_vgg(opt, seed)
        opt_g, self.sched_g = make_adam(opt["train"]["generator"],
                                        self.net_g.parameters())
        # D's lr is set from the global step before each update it takes,
        # so the adaptive policy's skipped steps do not hold it back
        opt_d, self.sched_d = make_adam(opt["train"]["discriminator"],
                                        self.net_d.parameters())
        self.state = tecogan_init_state(self.net_g, self.net_d, opt_g, opt_d)
        self.sync_replicas(self.state)
        self._train_step = functools.partial(
            tecogan_train_step, cfg_g=self.cfg_g, cfg_d=self.cfg_d,
            tcfg=self.tcfg, sched_g=self.sched_g, sched_d=self.sched_d,
            vgg=self.vgg, log_decay=self.log_decay)

    def _load_discriminator(self, path: str) -> DTrunk:
        """A reference ``.pth`` (by name) or a ``.npz`` in the JAX
        package's layout (through the bridge); keys or shapes that do not
        match the configured D raise."""
        if str(path).endswith(".pth"):
            sd = convert.load_state_dict(path)
        else:
            sd = convert.d_state_dict_from_jax(ckpt_io.load_pytree(path),
                                               self.cfg_d.spatial_size)
        return DTrunk.from_state_dict(self.cfg_d, sd, self.device)

    def _load_vgg(self, opt, seed: int) -> VGG19:
        """VGG19 weights for the perceptual loss, from
        ``feature_crit.weights_path`` (a ``.npz`` in the JAX package's
        layout; default ``pretrained_models/vgg19.npz``).

        The reference trains TecoGAN against ImageNet VGG19 features
        (`codes/models/networks/vgg_nets.py:6-38`); training against random
        features would complete without error and give a non-parity model,
        so a missing file raises unless
        ``feature_crit.allow_random_weights: true`` (smoke runs only), which
        draws the weights from the seed + 2 and logs a WARNING.
        """
        fc = opt["train"]["feature_crit"]
        path = fc.get("weights_path", "pretrained_models/vgg19.npz")
        if osp.exists(path):
            _log.info("Load VGG19 feature extractor from: %s", path)
            sd = convert.vgg19_state_dict_from_jax(ckpt_io.load_pytree(path))
            return VGG19.from_state_dict(sd, self.device)
        if not fc.get("allow_random_weights", False):
            raise FileNotFoundError(
                f"No pretrained VGG19 weights at '{path}'. The perceptual "
                "loss requires ImageNet VGG19 features; training against "
                "random features would complete without error but produce a "
                "non-parity model. Convert torchvision's checkpoint with:\n"
                "  python -c \"import torch; from tecogan_tpu_torch.models."
                "convert import vgg19_jax_from_state_dict; from "
                "tecogan_tpu_torch.utils.ckpt import save_pytree; sd = "
                "torch.load('vgg19-dcbb9e9d.pth', map_location='cpu', "
                "weights_only=True); save_pytree(vgg19_jax_from_state_dict("
                "sd), 'pretrained_models/vgg19.npz')\"\n"
                "or set feature_crit.allow_random_weights: true (smoke runs "
                "only), or point feature_crit.weights_path at a converted "
                ".npz.")
        _log.warning(
            "WARNING: no pretrained VGG19 weights found (%s); "
            "feature_crit.allow_random_weights is set, so the perceptual "
            "loss uses RANDOM features — NOT a parity run", path)
        return VGG19.random(torch.Generator().manual_seed(seed + 2),
                            self.device)

    # ------------------------------------------------------------------ train
    def get_learning_rate(self) -> dict:
        """The lrs the next updates use."""
        step = self.state["step"]
        return {"lr_G": float(self.sched_g(step)),
                "lr_D": float(self.sched_d(step))}

    # ------------------------------------------------------------------- save
    def save(self, current_iter):
        """``G_iter{N}.npz`` and ``D_iter{N}.npz`` in the JAX package's
        layout."""
        super().save(current_iter)
        params = convert.jax_from_d_state_dict(self.net_d.state_dict(),
                                               self.cfg_d.spatial_size)
        self.save_pytree(params, f"D_iter{current_iter}.npz")
