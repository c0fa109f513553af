"""Fisheye (equidistant, Kannala-Brandt k1..k4) camera functions.

Port of structure_plp_slam_tpu/camera/fisheye.py (reference
camera/fisheye.{h,cc}, the cv::fisheye model), batched over ``[N, ...]``.
Undistortion is the same fixed 10-step Newton solve for theta from
theta_d. The powers of theta^2 are written as the products JAX lowers
``t2**n`` to (``lax.integer_pow``: t2*t2, t2*(t2*t2), (t2*t2)*(t2*t2)),
so both packages round them alike.
"""

from __future__ import annotations

import math

import torch

from structure_plp_slam_tpu_torch.camera import perspective

NEWTON_STEPS = 10


def _powers(t2):
    """t2^2, t2^3, t2^4 in ``lax.integer_pow``'s order."""
    p2 = t2 * t2
    return p2, t2 * p2, p2 * p2


def undistort_keypoints(camera, keypts):
    """``[N, 2]`` pixel keypoints -> undistorted (pinhole) pixel keypoints."""
    keypts = torch.as_tensor(keypts, dtype=torch.float32)
    x_d = (keypts[..., 0] - camera.cx) * camera.fx_inv
    y_d = (keypts[..., 1] - camera.cy) * camera.fy_inv
    theta_d = torch.sqrt(x_d * x_d + y_d * y_d)
    theta_d_c = torch.clamp(theta_d, -math.pi, math.pi)
    theta = theta_d_c
    for _ in range(NEWTON_STEPS):
        t2 = theta * theta
        p2, p3, p4 = _powers(t2)
        k = 1.0 + camera.k1 * t2 + camera.k2 * p2 + camera.k3 * p3 + camera.k4 * p4
        dk = (1.0 + 3.0 * camera.k1 * t2 + 5.0 * camera.k2 * p2 + 7.0 * camera.k3 * p3
              + 9.0 * camera.k4 * p4)
        dk = torch.where(torch.abs(dk) < 1e-9, torch.full_like(dk, 1e-9), dk)
        theta = theta - (theta * k - theta_d_c) / dk
    far = theta_d > 1e-9
    scale = torch.where(far, torch.tan(theta) / torch.where(far, theta_d, torch.ones_like(theta_d)),
                        torch.ones_like(theta_d))
    return torch.stack([x_d * scale * camera.fx + camera.cx,
                        y_d * scale * camera.fy + camera.cy], dim=-1)


def bearings(camera, undist_keypts):
    """Undistorted pixel keypoints ``[N, 2]`` -> unit bearings ``[N, 3]``."""
    return perspective.bearings(camera, undist_keypts)


def project(camera, points_cam):
    """Distortion-free pinhole projection on undistorted coordinates:
    (uv ``[N, 2]``, depth ``[N]``)."""
    return perspective.project(camera, points_cam)


def project_jacobian(camera, points_cam):
    """Pinhole Jacobian: every residual lives in undistorted pixel space."""
    return perspective.project_jacobian(camera, points_cam)


def in_image(camera, uv, margin: float = 0.0):
    return perspective.in_image(camera, uv, margin)
