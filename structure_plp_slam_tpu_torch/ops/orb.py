"""ORB feature extraction: pyramid FAST + IC-angle orientation + rBRIEF.

Port of structure_plp_slam_tpu/ops/orb.py, atlas formulation included:
every dense stage (FAST score, NMS, IC moments, BRIEF blur) runs once over
the vertical pyramid atlas; keypoint selection runs per level on slices
of the shared score map. The BRIEF pattern is drawn from the same numpy
generator and seed (1234) as the JAX package's, so descriptors are
comparable bit for bit.

Output layout (the frame's "features" dict of tensors):
  xy [K, 2] f32 level-0 pixel coords, response [K] f32, level [K] i64,
  angle [K] f32 (radians), desc [K, 8] int32 (u32 bit patterns),
  valid [K] bool.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List

import numpy as np
import torch

from structure_plp_slam_tpu_torch.ops import fast as fast_ops
from structure_plp_slam_tpu_torch.ops import image as image_ops

PATCH_RADIUS = 15  # IC-angle circular patch radius (31x31 patch).
BRIEF_RADIUS = 13  # max |offset| of generated BRIEF points.
EDGE_MARGIN = 19   # keep keypoints this far from borders (orientation+BRIEF).


@functools.lru_cache(maxsize=4)
def _brief_pattern(seed: int = 1234, num_pairs: int = 256) -> np.ndarray:
    """BRIEF pattern ``[num_pairs, 4]`` = (x0, y0, x1, y1): Gaussian with
    sigma = patch/5 (BRIEF paper), rounded, clipped to ``BRIEF_RADIUS`` —
    the same draw as the JAX package's."""
    rng = np.random.default_rng(seed)
    sigma = (2 * BRIEF_RADIUS + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(num_pairs * 2, 2))
    pts = np.clip(np.round(pts), -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.int32)
    return pts.reshape(num_pairs, 4)


def _windowed_sum(P, h, dim):
    """Sliding-window sum of half-extent ``h`` along ``dim`` from an
    exclusive prefix sum ``P`` (one extra leading element on ``dim``);
    border windows are truncated."""
    n = P.shape[dim] - 1
    first = P.narrow(dim, 0, 1)
    last = P.narrow(dim, P.shape[dim] - 1, 1)
    hi = torch.cat([P, last.expand_as(P.narrow(dim, 0, h))], dim=dim).narrow(
        dim, h + 1, n
    )
    lo = torch.cat([first.expand_as(P.narrow(dim, 0, h)), P], dim=dim).narrow(
        dim, 0, n
    )
    return hi - lo


def ic_moment_maps(img):
    """Dense IC-angle moment maps ``(m10, m01)`` at every pixel from prefix
    sums: each column offset d contributes d times a windowed sum of
    half-extent floor(sqrt(r^2 - d^2))."""
    r = PATCH_RADIUS
    H, W = img.shape
    Py = torch.cat([img.new_zeros((1, W)), torch.cumsum(img, dim=0)], dim=0)
    Px = torch.cat([img.new_zeros((H, 1)), torch.cumsum(img, dim=1)], dim=1)
    m10 = torch.zeros_like(img)
    m01 = torch.zeros_like(img)
    for d in range(1, r + 1):
        h = int(math.floor(math.sqrt(r * r - d * d)))
        V = _windowed_sum(Py, h, dim=0)
        left = torch.cat([V, V.new_zeros((H, d))], dim=1)[:, d:]
        right = torch.cat([V.new_zeros((H, d)), V], dim=1)[:, :W]
        m10 = m10 + float(d) * (left - right)
        Hs = _windowed_sum(Px, h, dim=1)
        down = torch.cat([Hs, Hs.new_zeros((d, W))], dim=0)[d:, :]
        up = torch.cat([Hs.new_zeros((d, W)), Hs], dim=0)[:H, :]
        m01 = m01 + float(d) * (down - up)
    return m10, m01


def ic_angles(img, xy, moments=None):
    """Intensity-centroid orientations ``[K]`` of keypoints ``xy [K, 2]``:
    atan2(m01, m10) of the radius-15 patch, read from the dense moment
    maps (:func:`ic_moment_maps`, or ``moments`` when given) at the
    truncated, clamped pixel."""
    m10, m01 = ic_moment_maps(img) if moments is None else moments
    H, W = img.shape
    xs = torch.clamp(xy[:, 0].to(torch.int64), 0, W - 1)
    ys = torch.clamp(xy[:, 1].to(torch.int64), 0, H - 1)
    return torch.atan2(m01[ys, xs], m10[ys, xs])


def _brief_sample_coords(xy, angles):
    """Rotated BRIEF sample coordinates: two ``[K, 256]`` (x, y) pairs.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    pat = torch.from_numpy(_brief_pattern()).to(xy.device).to(torch.float32)
    x0, y0, x1, y1 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    c = torch.cos(angles)[:, None]
    s = torch.sin(angles)[:, None]

    def rot(px, py):
        rx = torch.round(c * px[None, :] - s * py[None, :]).to(torch.int64)
        ry = torch.round(s * px[None, :] + c * py[None, :]).to(torch.int64)
        return rx, ry

    rx0, ry0 = rot(x0, y0)
    rx1, ry1 = rot(x1, y1)
    xs = xy[:, 0].to(torch.int64)[:, None]
    ys = xy[:, 1].to(torch.int64)[:, None]
    return (xs + rx0, ys + ry0), (xs + rx1, ys + ry1)


def pack_bits(bits):
    """``[K, 256]`` bool -> ``[K, 8]`` int32 (bit i of word w = bit 32w+i)."""
    b = bits.reshape(bits.shape[0], 8, 32).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, device=bits.device),
    )
    words = torch.sum(b * weights, dim=-1)  # [K, 8] in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def brief_descriptors(blurred, xy, angles):
    """Rotated BRIEF descriptors ``[K, 8]`` int32 of keypoints on one
    blurred level: the pattern rotated by each keypoint's angle, the
    samples clamped to the image."""
    H, W = blurred.shape
    (x0, y0), (x1, y1) = _brief_sample_coords(xy, angles)

    def sample(rx, ry):
        return blurred[torch.clamp(ry, 0, H - 1), torch.clamp(rx, 0, W - 1)]

    return pack_bits(sample(x0, y0) < sample(x1, y1))


def brief_descriptors_pyramid(blur_flat, level_shapes, level_offsets,
                              xy_list, angle_list, row_stride=None):
    """BRIEF for all pyramid levels with one gather pair over the flattened
    blurred atlas (``level_offsets``: flat index of each level's origin)."""
    coords_a, coords_b = [], []
    for (H, W), off, xy, ang in zip(level_shapes, level_offsets, xy_list, angle_list):
        stride = row_stride if row_stride is not None else W
        (x0, y0), (x1, y1) = _brief_sample_coords(xy, ang)
        coords_a.append(
            torch.clamp(y0, 0, H - 1) * stride + torch.clamp(x0, 0, W - 1) + off
        )
        coords_b.append(
            torch.clamp(y1, 0, H - 1) * stride + torch.clamp(x1, 0, W - 1) + off
        )
    idx = torch.cat(coords_a + coords_b, dim=0)  # [2*K_tot, 256]
    vals = blur_flat[idx]
    K_tot = idx.shape[0] // 2
    return pack_bits(vals[:K_tot] < vals[K_tot:])


@dataclasses.dataclass(frozen=True)
class OrbParams:
    """Mirrors reference orb_params (src/PLPSLAM/feature/orb_params.h:34-72)."""

    max_num_keypts: int = 2000
    scale_factor: float = 1.2
    num_levels: int = 8
    ini_fast_thr: float = 20.0
    min_fast_thr: float = 7.0
    mask_rects: tuple = ()

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.num_levels, dtype=np.float64)

    def level_budgets(self) -> List[int]:
        """Per-level keypoint budgets (geometric series, multiples of 8)."""
        f = 1.0 / self.scale_factor
        total = self.max_num_keypts
        n0 = total * (1 - f) / (1 - f**self.num_levels)
        budgets = [int(round(n0 * f**lv)) for lv in range(self.num_levels)]
        budgets[-1] = max(0, total - sum(budgets[:-1]))
        return [max(8, ((b + 7) // 8) * 8) for b in budgets]


class OrbExtractor:
    """Whole-frame ORB extraction for a fixed image geometry. ``capacity``
    is the padded sum of the level budgets."""

    def __init__(self, rows: int, cols: int, params: OrbParams = OrbParams()):
        self.rows = rows
        self.cols = cols
        self.params = params
        self.budgets = params.level_budgets()
        self.capacity = sum(self.budgets)
        self.shapes = image_ops.pyramid_shapes(
            rows, cols, params.num_levels, params.scale_factor
        )

    def __call__(self, img):
        """f32 ``[H, W]`` tensor -> feature dict (see module docstring)."""
        p = self.params
        offs, Ha, Wa = image_ops.atlas_layout(self.shapes)
        atlas = image_ops.build_atlas(img, self.shapes, offs, Ha, Wa)
        score_a = fast_ops.nms3x3(
            fast_ops.fast_score_map(atlas, p.ini_fast_thr, p.min_fast_thr)
        )
        m10_a, m01_a = ic_moment_maps(atlas)
        blur_flat = image_ops.gaussian_blur(atlas).reshape(-1)

        outs = []
        xy_list, angle_list = [], []
        for lv in range(p.num_levels):
            H, W = self.shapes[lv]
            y0 = offs[lv]
            budget = self.budgets[lv]
            xy, resp, valid = fast_ops.select_keypoints(
                score_a[y0 : y0 + H, :W],
                cell=16 if min(H, W) >= 64 else 8,
                per_cell=4,
                max_total=budget,
                margin=EDGE_MARGIN,
            )
            xs = torch.clamp(xy[:, 0].to(torch.int64), 0, W - 1)
            ys = torch.clamp(xy[:, 1].to(torch.int64), 0, H - 1) + y0
            angle = torch.atan2(m01_a[ys, xs], m10_a[ys, xs])
            xy_list.append(xy)
            angle_list.append(angle)
            scale = torch.tensor(p.scale_factor**lv, dtype=torch.float32)
            outs.append(
                dict(
                    xy=xy * scale.to(xy.device),
                    response=resp,
                    level=torch.full((budget,), lv, dtype=torch.int64, device=img.device),
                    angle=angle,
                    valid=valid,
                )
            )
        out = {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
        out["desc"] = brief_descriptors_pyramid(
            blur_flat, self.shapes, [y0 * Wa for y0 in offs], xy_list, angle_list,
            row_stride=Wa,
        )
        return out
