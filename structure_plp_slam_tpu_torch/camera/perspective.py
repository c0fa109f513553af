"""Perspective (pinhole + radial-tangential) camera functions.

Port of structure_plp_slam_tpu/camera/perspective.py, batched over
``[N, 2]`` keypoints / ``[N, 3]`` camera-space points. Undistortion is the
same 8-step fixed-point iteration (OpenCV's undistortPoints scheme).
"""

from __future__ import annotations

import torch


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def undistort_keypoints(camera, keypts):
    """``[N, 2]`` pixel keypoints -> undistorted pixel keypoints ``[N, 2]``."""
    keypts = torch.as_tensor(keypts, dtype=torch.float32)
    if not camera.has_distortion:
        return keypts
    xd = (keypts[..., 0] - camera.cx) * camera.fx_inv
    yd = (keypts[..., 1] - camera.cy) * camera.fy_inv
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = 1.0 / (1.0 + camera.k1 * r2 + camera.k2 * r4 + camera.k3 * r6)
        dx = 2.0 * camera.p1 * x * y + camera.p2 * (r2 + 2.0 * x * x)
        dy = camera.p1 * (r2 + 2.0 * y * y) + 2.0 * camera.p2 * x * y
        x, y = (xd - dx) * icdist, (yd - dy) * icdist
    return torch.stack([x * camera.fx + camera.cx, y * camera.fy + camera.cy], dim=-1)


def bearings(camera, undist_keypts):
    """Undistorted pixel keypoints ``[N, 2]`` -> unit bearings ``[N, 3]``."""
    x = (undist_keypts[..., 0] - camera.cx) * camera.fx_inv
    y = (undist_keypts[..., 1] - camera.cy) * camera.fy_inv
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def project(camera, points_cam):
    """Camera-space points ``[N, 3]`` -> (uv ``[N, 2]``, depth ``[N]``),
    with distortion-free intrinsics."""
    z = points_cam[..., 2]
    safe_z = _safe_z(z)
    u = camera.fx * points_cam[..., 0] / safe_z + camera.cx
    v = camera.fy * points_cam[..., 1] / safe_z + camera.cy
    return torch.stack([u, v], dim=-1), z


def project_jacobian(camera, points_cam):
    """d(uv)/d(pc) for the distortion-free pinhole projection ``[..., 2, 3]``."""
    x, y = points_cam[..., 0], points_cam[..., 1]
    iz = 1.0 / _safe_z(points_cam[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    row_u = torch.stack([camera.fx * iz, zero, -camera.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, camera.fy * iz, -camera.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def reproject_stereo(camera, points_cam):
    """``project`` plus the right image's x coordinate,
    ``x_right = u - fx * baseline / z``: (uv ``[N, 2]``, x_right ``[N]``,
    depth ``[N]``)."""
    uv, z = project(camera, points_cam)
    return uv, uv[..., 0] - camera.focal_x_baseline / _safe_z(z), z


def in_image(camera, uv, margin: float = 0.0):
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < camera.cols - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < camera.rows - margin)
    )
