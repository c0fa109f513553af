"""Equirectangular (360 degree) camera functions.

Port of structure_plp_slam_tpu/camera/equirectangular.py (reference
camera/equirectangular.{h,cc}): pixel (u, v) maps to (longitude,
latitude), bearings live on the unit sphere and "depth" is the ray length.
"""

from __future__ import annotations

import math

import torch


def undistort_keypoints(camera, keypts):
    return torch.as_tensor(keypts, dtype=torch.float32)


def bearings(camera, undist_keypts):
    """Pixel keypoints ``[N, 2]`` -> unit bearings ``[N, 3]`` on the sphere."""
    lon = (undist_keypts[..., 0] / camera.cols - 0.5) * 2.0 * math.pi
    lat = -(undist_keypts[..., 1] / camera.rows - 0.5) * math.pi
    return torch.stack([torch.cos(lat) * torch.sin(lon), -torch.sin(lat),
                        torch.cos(lat) * torch.cos(lon)], dim=-1)


def project(camera, points_cam):
    """Camera-space points ``[N, 3]`` -> (uv ``[N, 2]``, range ``[N]``)."""
    norm = torch.linalg.norm(points_cam, dim=-1)
    b = points_cam / torch.clamp(norm[..., None], min=1e-12)
    lat = -torch.arcsin(torch.clamp(b[..., 1], -1.0, 1.0))
    lon = torch.atan2(b[..., 0], b[..., 2])
    u = camera.cols * (0.5 + lon / (2.0 * math.pi))
    v = camera.rows * (0.5 - lat / math.pi)
    return torch.stack([u, v], dim=-1), norm


def project_jacobian(camera, points_cam):
    """d(uv)/d(pc) of the lat/long projection ``[..., 2, 3]`` (the reference's
    equirectangular_reproj_edge linearizeOplus). With d = |pc|:
      du/dpc = cols/(2pi) * [z, 0, -x] / (x^2 + z^2)
      dv/dpc = rows/pi * (e_y - (y/d^2) pc) / sqrt(x^2 + z^2)
    clamped at the poles (x = z = 0), where the projection saturates."""
    x, y, z = points_cam[..., 0], points_cam[..., 1], points_cam[..., 2]
    r2 = torch.clamp(x * x + z * z, min=1e-12)
    d2 = torch.clamp(x * x + y * y + z * z, min=1e-12)
    ku = camera.cols / (2.0 * math.pi)
    zero = torch.zeros_like(z)
    row_u = torch.stack([ku * z / r2, zero, -ku * x / r2], dim=-1)
    kv = camera.rows / math.pi / torch.sqrt(r2)
    row_v = torch.stack([-kv * x * y / d2, kv * (1.0 - y * y / d2), -kv * z * y / d2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def in_image(camera, uv, margin: float = 0.0):
    """Every longitude is in the image; only v is bounded."""
    return (uv[..., 1] >= margin) & (uv[..., 1] < camera.rows - margin)
