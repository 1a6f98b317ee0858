"""Test-mode metrics (port of ``tecogan_tpu/metrics``: PSNR, SSIM, LPIPS,
tOF, and the model summary of profile mode)."""

from .metric_calculator import MetricCalculator, create_metric_calculator
from .ssim import ssim

__all__ = ["MetricCalculator", "create_metric_calculator", "ssim"]
