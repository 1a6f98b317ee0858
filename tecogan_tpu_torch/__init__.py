"""tecogan_tpu_torch — the PyTorch/CUDA port of tecogan_tpu for NVIDIA Hopper.

The port runs streaming FRVSR inference (4x and 2x, BD and BI) with
PyTorch modules in NCHW and hand-written CUDA kernels for the bilinear
backward warps (``ops/``, ``csrc/``), the FRVSR training step, and the
CLI's test mode (``python -m tecogan_tpu_torch.main --mode test``). It
never imports jax, yaml or the JAX package, which stays beside it as the
reference it is tested against, and cv2 only for the tOF metric.

Public functions keep the JAX package's layouts: sequences are
(t, h, w, c) float in [0, 1], outputs uint8 (t, s*h, s*w, c).
"""

__version__ = "0.1.0"
