"""Test-mode metrics (port of ``tecogan_tpu/metrics``: PSNR, SSIM, tOF)."""

from .metric_calculator import MetricCalculator, create_metric_calculator
from .ssim import ssim

__all__ = ["MetricCalculator", "create_metric_calculator", "ssim"]
