"""PyTorch/CUDA port of ``ccm_slam_tpu`` for NVIDIA Hopper (H100).

The JAX package ``ccm_slam_tpu`` is the reference; this package imports
neither it nor JAX.  Layout mirrors the reference (``utils/``, ``solvers/``,
``ops/``) so each module's counterpart is easy to find; ``csrc/`` holds the
hand-written CUDA kernels that replace the reference's Pallas TPU kernels.

Numerics: everything is float32 with TF32 OFF.  Importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` -- the counterpart of the
reference's exact-f32 (``Precision.HIGHEST``) residual and assembly path;
TF32 rounding of poses biases reprojections by ~2 px.

Devices: entry points run on ``cuda:0`` unless the caller passes
``device="cpu"`` (see ``device.resolve_device``); nothing falls back to the
CPU on its own.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
