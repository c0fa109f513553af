"""Camera model registry and dataclass.

Port of structure_plp_slam_tpu/camera/base.py: a camera is a frozen
dataclass of Python floats plus batched functions in ``perspective.py``,
``fisheye.py`` and ``equirectangular.py``, dispatched by model.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import torch


class CameraSetup(enum.Enum):
    MONOCULAR = "monocular"
    STEREO = "stereo"
    RGBD = "rgbd"


class CameraModel(enum.Enum):
    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"
    EQUIRECTANGULAR = "equirectangular"


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera description (same fields as the JAX package's)."""

    name: str
    setup: CameraSetup
    model: CameraModel
    cols: int
    rows: int
    fps: float = 30.0
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    focal_x_baseline: float = 0.0
    depth_threshold: float = 40.0
    depthmap_factor: float = 1.0

    @property
    def fx_inv(self) -> float:
        return 1.0 / self.fx if self.fx else 0.0

    @property
    def fy_inv(self) -> float:
        return 1.0 / self.fy if self.fy else 0.0

    @property
    def focal_like(self) -> float:
        """Pixels-per-radian scale for pixel-threshold conversions."""
        if self.fx:
            return self.fx
        return self.cols / (2.0 * math.pi)

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3, self.k4))

    @property
    def baseline(self) -> float:
        return self.focal_x_baseline / self.fx if self.fx else 0.0

    @property
    def true_depth_threshold(self) -> float:
        """baseline * depth_threshold (reference config.cc true_depth_thr_)."""
        return self.baseline * self.depth_threshold

    def image_bounds(self) -> Tuple[float, float, float, float]:
        """(min_x, max_x, min_y, max_y) of the undistorted image frame."""
        if self.model is CameraModel.EQUIRECTANGULAR or not self.has_distortion:
            return 0.0, float(self.cols), 0.0, float(self.rows)
        corners = torch.tensor(
            [[0.0, 0.0], [self.cols, 0.0], [0.0, self.rows], [self.cols, self.rows]],
            dtype=torch.float32,
        )
        und = dispatch(self).undistort_keypoints(self, corners)
        return (
            float(min(und[0, 0], und[2, 0])),
            float(max(und[1, 0], und[3, 0])),
            float(min(und[0, 1], und[1, 1])),
            float(max(und[2, 1], und[3, 1])),
        )


def dispatch(camera: Camera):
    """The function module for this camera's model."""
    from structure_plp_slam_tpu_torch.camera import equirectangular, fisheye, perspective

    return {
        CameraModel.PERSPECTIVE: perspective,
        CameraModel.FISHEYE: fisheye,
        CameraModel.EQUIRECTANGULAR: equirectangular,
    }[camera.model]


def undistort_keypoints(camera: Camera, keypts):
    return dispatch(camera).undistort_keypoints(camera, keypts)


def bearings(camera: Camera, undist_keypts):
    return dispatch(camera).bearings(camera, undist_keypts)


def project(camera: Camera, points_cam):
    return dispatch(camera).project(camera, points_cam)


def project_jacobian(camera: Camera, points_cam):
    """d(uv)/d(pc) ``[..., 2, 3]`` for camera-space points."""
    return dispatch(camera).project_jacobian(camera, points_cam)


def in_image(camera: Camera, uv, margin: float = 0.0):
    return dispatch(camera).in_image(camera, uv, margin)


def uv_residual(camera: Camera, uv_pred, uv_obs):
    """Reprojection residual ``uv_pred - uv_obs``, wrapped horizontally for
    equirectangular images (u and u + cols are the same pixel).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    d = uv_pred - uv_obs
    if camera.model is CameraModel.EQUIRECTANGULAR:
        du = d[..., 0]
        du = du - torch.round(du / camera.cols) * camera.cols
        d = torch.stack([du, d[..., 1]], dim=-1)
    return d


def cheirality(camera: Camera, points_cam):
    """Observability gate: positive depth for the pinhole-style models, any
    direction for the full-sphere equirectangular model."""
    if camera.model is CameraModel.EQUIRECTANGULAR:
        return torch.sum(points_cam * points_cam, dim=-1) > 1e-12
    return points_cam[..., 2] > 1e-6
