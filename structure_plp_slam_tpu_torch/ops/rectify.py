"""Stereo rectification: precomputed remap grids applied before the frontend.

Port of structure_plp_slam_tpu/ops/rectify.py (reference
util/stereo_rectifier.{h,cc}): the YAML ``StereoRectifier`` node carries
each side's pre-rectification intrinsics K, distortion D and rectifying
rotation R. The inverse maps are built once in numpy with the math of
cv::initUndistortRectifyMap (the JAX package's own copy); the per-frame
resampling is a bilinear gather of both images on the device, with the
arithmetic of ``jax.scipy.ndimage.map_coordinates(order=1,
mode="constant")``.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_plp_slam_tpu_torch.utils.types import resolve_device


def _distort_perspective(x, y, D):
    k1, k2, p1, p2, k3 = (list(D) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return x_d, y_d


def _distort_fisheye(x, y, D):
    k1, k2, k3, k4 = (list(D) + [0.0] * 4)[:4]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
    return x * scale, y * scale


def build_rectify_map(rows, cols, K_rect, K_side, D_side, R_side, fisheye=False):
    """Inverse sampling map ``(map_y, map_x)`` each [H, W] f32: where in the
    original image each rectified pixel reads from."""
    vs, us = np.mgrid[0:rows, 0:cols].astype(np.float64)
    x = (us - K_rect[0, 2]) / K_rect[0, 0]
    y = (vs - K_rect[1, 2]) / K_rect[1, 1]
    ray = np.stack([x, y, np.ones_like(x)], axis=-1)  # rectified frame
    Rinv = np.asarray(R_side, np.float64).reshape(3, 3).T
    ray = ray @ Rinv.T  # original camera frame
    xn = ray[..., 0] / ray[..., 2]
    yn = ray[..., 1] / ray[..., 2]
    if fisheye:
        xd, yd = _distort_fisheye(xn, yn, D_side)
    else:
        xd, yd = _distort_perspective(xn, yn, D_side)
    K = np.asarray(K_side, np.float64).reshape(3, 3)
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_y, map_x


def remap_bilinear(img, map_y, map_x):
    """Bilinear resampling of ``img [H, W]`` at ``(map_y, map_x)``; samples
    outside the image read 0 (cv::remap BORDER_CONSTANT). The four taps
    are weighted and summed in map_coordinates' order."""
    img = img.to(torch.float32)
    H, W = img.shape

    def taps(coord):
        lower = torch.floor(coord)
        w_hi = coord - lower
        idx = lower.to(torch.int64)
        return [(idx, 1.0 - w_hi), (idx + 1, w_hi)]

    out = None
    for iy, wy in taps(map_y):
        for ix, wx in taps(map_x):
            ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            val = img[torch.clamp(iy, 0, H - 1), torch.clamp(ix, 0, W - 1)]
            term = (wy * wx) * torch.where(ok, val, torch.zeros_like(val))
            out = term if out is None else out + term
    return out


class StereoRectifier:
    """Built from the config's raw YAML dict (stereo_rectifier.cc:46-60
    reads StereoRectifier.{K,D,R}_{left,right}; the post-rectification
    matrix is the camera's own K). Call with the raw stereo pair; returns
    the rectified pair as f32 tensors on ``device``."""

    YAML_KEYS = (
        "StereoRectifier.K_left", "StereoRectifier.D_left",
        "StereoRectifier.R_left", "StereoRectifier.K_right",
        "StereoRectifier.D_right", "StereoRectifier.R_right",
    )

    @staticmethod
    def available(raw: dict) -> bool:
        return all(k in raw for k in StereoRectifier.YAML_KEYS)

    def __init__(self, camera, raw: dict, device=None):
        if not self.available(raw):
            missing = [k for k in self.YAML_KEYS if k not in raw]
            raise KeyError(f"StereoRectifier YAML keys missing: {missing}")
        self.device = resolve_device(device)
        fisheye = str(raw.get("StereoRectifier.model", "perspective")).lower() == "fisheye"
        K_rect = np.array([[camera.fx, 0.0, camera.cx], [0.0, camera.fy, camera.cy],
                           [0.0, 0.0, 1.0]])
        maps = []
        for side in ("left", "right"):
            my, mx = build_rectify_map(
                camera.rows, camera.cols, K_rect, raw[f"StereoRectifier.K_{side}"],
                np.asarray(raw[f"StereoRectifier.D_{side}"], np.float64).ravel(),
                raw[f"StereoRectifier.R_{side}"], fisheye=fisheye,
            )
            maps.append((torch.from_numpy(my).to(self.device),
                         torch.from_numpy(mx).to(self.device)))
        (self.my_l, self.mx_l), (self.my_r, self.mx_r) = maps

    def __call__(self, img_left, img_right):
        left = torch.as_tensor(img_left, device=self.device)
        right = torch.as_tensor(img_right, device=self.device)
        return (remap_bilinear(left, self.my_l, self.mx_l),
                remap_bilinear(right, self.my_r, self.mx_r))
