"""Robust-cost kernels shared by all optimizers.

Port of structure_plp_slam_tpu/ops/robust.py (Huber IRLS weights and the
reference's chi-squared gates, pose_optimizer.cc:117-121).
"""

from __future__ import annotations

import torch

CHI2_2D = 5.991  # 95% for 2 DoF (mono reprojection)
CHI2_3D = 7.815  # 95% for 3 DoF (stereo reprojection)


def huber_weight(chi2, delta_sq):
    """IRLS weight of the Huber kernel: min(1, delta / sqrt(e))."""
    e = torch.clamp(chi2, min=1e-12)
    return torch.clamp(torch.sqrt(delta_sq / e), max=1.0)


def chi2_2d(residual, inv_sigma_sq):
    """Weighted squared error for 2D residuals ``[..., 2]``."""
    return torch.sum(residual * residual, dim=-1) * inv_sigma_sq


def chi2_3d(residual, inv_sigma_sq):
    return torch.sum(residual * residual, dim=-1) * inv_sigma_sq
