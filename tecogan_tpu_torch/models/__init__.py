"""Model registry (port of ``tecogan_tpu/models/__init__.py``)."""

from .vsr_model import VSRModel
from .vsrgan_model import VSRGANModel


def define_model(opt):
    name = opt["model"]["name"].lower()
    if name == "frvsr":
        return VSRModel(opt)
    if name == "tecogan":
        return VSRGANModel(opt)
    raise ValueError(f"Unrecognized model: {opt['model']['name']}")


__all__ = ["define_model", "VSRModel", "VSRGANModel"]
