"""structure_plp_slam_tpu_torch — the PyTorch/CUDA port of structure_plp_slam_tpu.

The package mirrors the JAX package module for module (``ops/``,
``camera/``, ``data/``, ``models/``, ``io/``, ``system.py``) and ports its
RGB-D point path: frontend, tracker, keyframe chain, local BA and
trajectory/ATE. Its one hand-written kernel is the fused windowed
descriptor matcher (``ops/fused_match.py`` + ``csrc/fused_match.cu``);
everything else is plain PyTorch.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (the CPU tests do); without a card they raise.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (Lie ops, LM solvers, Schur complements) must run in true
# float32, as the JAX package forces with jax_default_matmul_precision.
# TF32 keeps ~3 decimal digits — too coarse for normal-equation solves.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
