"""Per-frame feature frontend: image -> padded feature dict.

Port of the mono, RGB-D and stereo paths of structure_plp_slam_tpu/models/
frontend.py (reference data::frame construction, frame.h:87-164). One
call per frame produces the fixed-capacity feature tensors the MapState
stores per keyframe:

  xy [N,2] undistorted level-0 coords   xr [N] right x (<0 mono)
  depth [N]                              level [N] i64, angle [N]
  desc [N,8] int32                       bearing [N,3]
  valid [N] bool                         response [N]

With ``with_lines`` each frame also gets up to ``max_lines`` line
segments (``_lines``): seg [M,4], seg_desc [M,D], seg_valid [M] and
seg_depth [M,2], the endpoint depths sampled from the depth map (RGB-D),
searched on the rectified pair (stereo) or 0 (mono).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.ops import image as image_ops
from structure_plp_slam_tpu_torch.ops import lines as line_ops
from structure_plp_slam_tpu_torch.ops import matching
from structure_plp_slam_tpu_torch.ops import orb as orb_ops
from structure_plp_slam_tpu_torch.ops import stereo as stereo_ops
from structure_plp_slam_tpu_torch.utils.types import rdiv, resolve_device


class Frontend:
    """Feature extraction bound to a camera + ORB params; ``pad_to`` is
    the output slot count (the MapState per-keyframe capacity)."""

    def __init__(self, camera, orb_params: orb_ops.OrbParams, pad_to: int,
                 with_lines: bool = False, max_lines: int = 64, device=None):
        self.device = resolve_device(device)
        self.with_lines = with_lines
        self.max_lines = max_lines
        # A StageTimer to time the line work as ``frontend.lines`` (the
        # System sets its own).
        self.timer = None
        # Where the endpoint depths are sampled along each segment.
        self._line_fracs = torch.tensor([0.05, 0.1, 0.15, 0.85, 0.9, 0.95],
                                        dtype=torch.float32, device=self.device)
        self.camera = camera
        self.extractor = orb_ops.OrbExtractor(camera.rows, camera.cols, orb_params)
        if pad_to < self.extractor.capacity:
            raise ValueError(
                f"pad_to={pad_to} < extractor capacity {self.extractor.capacity}"
            )
        self.pad_to = pad_to
        self.scale_factors = torch.as_tensor(
            orb_params.scale_factors(), dtype=torch.float32, device=self.device
        )
        # Per-level information weights: 1 / scale^2 (orb_params.h).
        self.inv_sigma_sq = 1.0 / (self.scale_factors**2)
        if orb_params.mask_rects:
            m = np.ones((camera.rows, camera.cols), bool)
            for x0, x1, y0, y1 in orb_params.mask_rects:
                m[int(round(camera.rows * y0)):int(round(camera.rows * y1)),
                  int(round(camera.cols * x0)):int(round(camera.cols * x1))] = False
            self._rect_mask = torch.from_numpy(m).to(self.device)
        else:
            self._rect_mask = None

    def _eff_mask(self, mask):
        """Per-frame mask image (0 = excluded) combined with the static
        rectangle mask."""
        if mask is None:
            return self._rect_mask
        m = torch.as_tensor(mask, device=self.device) != 0
        return m if self._rect_mask is None else (m & self._rect_mask)

    def mono(self, img_gray, key=None, mask=None):
        """uint8/f32 [H, W] grayscale -> feature dict (mono). ``key`` goes
        to the line detector, as in the JAX package (which draws nothing
        from it)."""
        out = self._base(img_gray, self._eff_mask(mask))
        n = self.pad_to
        out["xr"] = torch.full((n,), -1.0, dtype=torch.float32, device=self.device)
        out["depth"] = torch.zeros((n,), dtype=torch.float32, device=self.device)
        out.pop("_xy_raw")
        if self.with_lines:
            self._lines(img_gray, out, key)
        return out

    def rgbd(self, img_gray, depth, key=None, mask=None):
        """Adds per-keypoint depth sampled from the registered depth map
        and a virtual right-x coordinate (reference frame.cc RGB-D ctor:
        x_right = x - fx*baseline/depth)."""
        out = self._base(img_gray, self._eff_mask(mask))
        cam = self.camera
        xy = out.pop("_xy_raw")
        depth_map = torch.as_tensor(depth, device=self.device)
        xs = torch.clamp(xy[:, 0].to(torch.int64), 0, cam.cols - 1)
        ys = torch.clamp(xy[:, 1].to(torch.int64), 0, cam.rows - 1)
        d = depth_map[ys, xs].to(torch.float32) * (1.0 / cam.depthmap_factor)
        has_depth = d > 1e-6
        safe_d = torch.where(has_depth, d, torch.ones_like(d))
        out["xr"] = torch.where(
            has_depth, out["xy"][:, 0] - rdiv(cam.focal_x_baseline, safe_d), -1.0
        )
        out["depth"] = torch.where(has_depth, d, torch.zeros_like(d))
        if self.with_lines:
            self._lines(img_gray, out, key, depth_map=depth_map)
        return out

    def stereo(self, img_left, img_right, key=None, mask=None):
        """Rectified stereo pair: left features plus disparity-derived depth
        (reference frame.cc stereo ctor: ORB on both images, then
        match::stereo). Line endpoint depths come from a row SAD search on
        the pair (the stereo line frame ctor, frame.h:87-164)."""
        out = self._base(img_left, self._eff_mask(mask))
        gray_l = image_ops.to_grayscale(img_left, device=self.device)
        gray_r = image_ops.to_grayscale(img_right, device=self.device)
        feats_r = self.extractor(gray_r)
        xr, depth, ok = stereo_ops.match_stereo(
            gray_l, gray_r, out.pop("_xy_raw"), out["level"],
            matching.unpack_desc_bits(out["desc"]), out["valid"],
            self._pad(feats_r["xy"]), self._pad(feats_r["level"]),
            matching.unpack_desc_bits(self._pad(feats_r["desc"])),
            self._pad(feats_r["valid"]), self.scale_factors,
            focal_x_baseline=self.camera.focal_x_baseline,
        )
        out["xr"], out["depth"] = xr, depth  # -1 / 0 where unmatched
        if self.with_lines:
            self._lines(gray_l, out, key, gray_right=gray_r)
        return out

    def _lines(self, img, out, key=None, depth_map=None, gray_right=None):
        """Attach line-segment features to ``out`` (the line frame ctors,
        frame.h:87-164): detection at two scales, band descriptors and
        endpoint depths, each the median of three samples just inside the
        segment's ends."""
        with self.timer.stage("frontend.lines") if self.timer else contextlib.nullcontext():
            self._lines_impl(img, out, key, depth_map, gray_right)

    def _lines_impl(self, img, out, key, depth_map, gray_right):
        gray = image_ops.to_grayscale(img, device=self.device)
        seg, valid, _ = line_ops.detect_line_segments_multiscale(gray, key,
                                                                 max_lines=self.max_lines)
        desc = line_ops.line_band_descriptors(gray, seg, valid)
        fracs = self._line_fracs
        xs = seg[None, :, 0] + fracs[:, None] * (seg[None, :, 2] - seg[None, :, 0])
        ys = seg[None, :, 1] + fracs[:, None] * (seg[None, :, 3] - seg[None, :, 1])
        if gray_right is not None:
            d, ok = stereo_ops.depth_at_points(
                gray, gray_right, torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1),
                focal_x_baseline=self.camera.focal_x_baseline)
            d = torch.where(ok, d, torch.zeros_like(d)).reshape(6, -1)
        elif depth_map is not None:
            dm = depth_map.to(torch.float32) * (1.0 / self.camera.depthmap_factor)
            xi = torch.clamp(xs.to(torch.int64), 0, self.camera.cols - 1)
            yi = torch.clamp(ys.to(torch.int64), 0, self.camera.rows - 1)
            d = dm[yi, xi]
        else:
            d = None
        if d is None:
            seg_depth = torch.zeros((seg.shape[0], 2), dtype=torch.float32, device=self.device)
        else:
            seg_depth = torch.stack([torch.median(d[:3], dim=0).values,
                                     torch.median(d[3:], dim=0).values], dim=1)
        out.update(seg=seg, seg_desc=desc, seg_valid=valid, seg_depth=seg_depth)

    def _pad(self, t):
        n = t.shape[0]
        if n == self.pad_to:
            return t
        return torch.cat([t, t.new_zeros((self.pad_to - n,) + tuple(t.shape[1:]))])

    def _base(self, img, mask=None):
        gray = image_ops.to_grayscale(img, device=self.device)
        feats = self.extractor(gray)
        valid = feats["valid"]
        if mask is not None:
            # Keypoints in excluded regions drop on their raw (distorted)
            # coords, the coords detection ran on.
            xi = torch.clamp(feats["xy"][:, 0].to(torch.int64), 0, self.camera.cols - 1)
            yi = torch.clamp(feats["xy"][:, 1].to(torch.int64), 0, self.camera.rows - 1)
            valid = valid & mask[yi, xi]
        xy_und = cam_base.undistort_keypoints(self.camera, feats["xy"])
        bearing = cam_base.bearings(self.camera, xy_und)
        return {
            "xy": self._pad(xy_und),
            "level": self._pad(feats["level"]),
            "angle": self._pad(feats["angle"]),
            "desc": self._pad(feats["desc"]),
            "bearing": self._pad(bearing),
            "valid": self._pad(valid),
            "response": self._pad(feats["response"]),
            "_xy_raw": self._pad(feats["xy"]),
        }

    def obs_inv_sigma_sq(self, level):
        """Per-observation information from pyramid level ``[N]``."""
        return self.inv_sigma_sq[torch.clamp(level, 0, self.inv_sigma_sq.shape[0] - 1)]
