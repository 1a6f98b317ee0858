"""tecogan_tpu_torch — the PyTorch/CUDA port of tecogan_tpu for NVIDIA Hopper.

The port runs streaming FRVSR inference (4x and 2x, BD degradation) with
PyTorch modules in NCHW and one hand-written CUDA kernel: the bilinear
backward warp of the previous HR frame (``ops/warp_cuda.py``,
``csrc/warp_planes.cu``). It imports torch and numpy only; it never imports
jax or the JAX package, which stays beside it as the reference it is
tested against.

Public functions keep the JAX package's layouts: sequences are
(t, h, w, c) float in [0, 1], outputs uint8 (t, s*h, s*w, c).
"""

__version__ = "0.1.0"
