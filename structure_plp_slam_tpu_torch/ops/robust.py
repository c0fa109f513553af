"""Robust-cost kernels shared by all optimizers.

Port of structure_plp_slam_tpu/ops/robust.py (Huber IRLS weights and the
reference's chi-squared gates, pose_optimizer.cc:117-121).
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.ops.linalg import sqrt

CHI2_2D = 5.991  # 95% for 2 DoF (mono reprojection)
CHI2_3D = 7.815  # 95% for 3 DoF (stereo reprojection)


def huber_weight(chi2, delta_sq):
    """IRLS weight of the Huber kernel: min(1, delta / sqrt(e)). On the CPU
    a Python-number ``delta_sq`` is divided as JAX divides it, once
    (torch would multiply by the reciprocal), and the root is correctly
    rounded."""
    e = torch.clamp(chi2, min=1e-12)
    if e.device.type == "cpu" and not torch.is_tensor(delta_sq):
        delta_sq = torch.full_like(e, delta_sq)
    return torch.clamp(sqrt(delta_sq / e), max=1.0)


def chi2_2d(residual, inv_sigma_sq):
    """Weighted squared error for 2D residuals ``[..., 2]``."""
    return torch.sum(residual * residual, dim=-1) * inv_sigma_sq


def chi2_3d(residual, inv_sigma_sq):
    return torch.sum(residual * residual, dim=-1) * inv_sigma_sq
