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

import ctypes
import dataclasses
import functools
import math
from typing import List

import numpy as np
import torch

from structure_plp_slam_tpu_torch.ops import fast as fast_ops
from structure_plp_slam_tpu_torch.ops import image as image_ops
from structure_plp_slam_tpu_torch.utils import prng

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


@functools.lru_cache(maxsize=8)
def _brief_pattern_on(device: str):
    """The pattern as f32 on ``device``, copied there once (a copy to the
    card per call is a host sync)."""
    return torch.from_numpy(_brief_pattern()).to(torch.float32).to(torch.device(device))


def _moment_maps(img, fused: bool):
    """``(m10, m01)`` from XLA:CPU's blocked prefix sums
    (``prng.cumsum_xla``). Each column offset d adds d times a difference
    of windowed sums: one f32 multiply and one f32 add (``fused`` False),
    or one fused multiply-add (``fused`` True, emulated as an f64 add of
    an exact f64 product, rounded to f32)."""
    r = PATCH_RADIUS
    H, W = img.shape

    def padded_prefix(dim):
        # exclusive prefix sums along dim, edges repeated r + 1 times more
        P = prng.cumsum_xla(img, dim)
        first, last = P.narrow(dim, 0, 1), P.narrow(dim, P.shape[dim] - 1, 1)
        zero = torch.zeros_like(first)
        return torch.cat([zero.expand_as(P.narrow(dim, 0, r + 1)), P,
                          last.expand_as(P.narrow(dim, 0, r + 1))], dim=dim)

    def moment(dim):
        # window sums of half-extent h along dim, truncated at the borders
        # (Pp[r + 1 + i + h] - Pp[r + 1 + i - h - 1]), land in the middle of
        # a zero border of r on the other axis; offset d then reads them
        # d ahead and d behind there
        Pp = padded_prefix(dim)
        n = img.shape[dim]
        other = 1 - dim
        Vz = img.new_zeros((H + 2 * r, W) if other == 0 else (H, W + 2 * r))
        mid = Vz.narrow(other, r, img.shape[other])
        acc = torch.zeros_like(img)
        for d in range(1, r + 1):
            h = int(math.floor(math.sqrt(r * r - d * d)))
            torch.sub(Pp.narrow(dim, r + 1 + h, n), Pp.narrow(dim, r - h, n), out=mid)
            diff = Vz.narrow(other, r + d, img.shape[other]) - Vz.narrow(
                other, r - d, img.shape[other])
            if fused:
                acc = torch.add(acc.to(torch.float64), diff.to(torch.float64),
                                alpha=d).to(torch.float32)
            else:
                acc = acc + float(d) * diff
        return acc

    # m10 sums column offsets of vertical window sums, m01 the reverse
    return moment(0), moment(1)


def ic_moment_maps(img):
    """Dense IC-angle moment maps ``(m10, m01)`` at every pixel from prefix
    sums: each column offset d contributes d times a windowed sum of
    half-extent floor(sqrt(r^2 - d^2)). Summed as the JAX package's
    function is when called on its own; the extractor's jitted pass fuses
    each multiply-add (``OrbExtractor``)."""
    return _moment_maps(img, fused=False)


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL("libm.so.6")
    for name, nargs in (("atan2f", 2), ("cosf", 1), ("sinf", 1)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * nargs
    return lib


def _trig(name: str, *args):
    """``atan2``, ``cos`` or ``sin`` of 1-D tensors. For f32 tensors on the
    CPU these are glibc's ``atan2f``, ``cosf`` and ``sinf``, one call per
    element, the functions XLA:CPU computes, so angles and rotations are
    the JAX package's bit for bit. On CUDA torch's kernels compute them,
    within 2 ulp of glibc: the one place where the devices compute
    differently. Other dtypes take torch's functions on either device."""
    if args[0].device.type != "cpu" or args[0].dtype != torch.float32:
        return getattr(torch, name)(*args)
    fn = getattr(_libm(), name + "f")
    vals = [a.tolist() for a in args]
    return torch.tensor([fn(*v) for v in zip(*vals)], dtype=torch.float32)


def ic_angles(img, xy, moments=None):
    """Intensity-centroid orientations ``[K]`` of keypoints ``xy [K, 2]``:
    atan2(m01, m10) of the radius-15 patch, read from the dense moment
    maps (:func:`ic_moment_maps`, or ``moments`` when given) at the
    truncated, clamped pixel."""
    m10, m01 = ic_moment_maps(img) if moments is None else moments
    H, W = img.shape
    xs = torch.clamp(xy[:, 0].to(torch.int64), 0, W - 1)
    ys = torch.clamp(xy[:, 1].to(torch.int64), 0, H - 1)
    return _trig("atan2", m01[ys, xs], m10[ys, xs])


def _brief_sample_coords(xy, angles):
    """Rotated BRIEF sample coordinates: two ``[K, 256]`` (x, y) pairs.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    pat = _brief_pattern_on(str(xy.device))
    x0, y0, x1, y1 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    c = _trig("cos", angles)[:, None]
    s = _trig("sin", angles)[:, None]

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
        m10_a, m01_a = _moment_maps(atlas, fused=True)
        blur_flat = image_ops._blur(atlas, 7, 2.0, fused=True).reshape(-1)

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
            angle = _trig("atan2", m01_a[ys, xs], m10_a[ys, xs])
            xy_list.append(xy)
            angle_list.append(angle)
            scale = float(np.float32(p.scale_factor**lv))  # an f32 multiply, no copy
            outs.append(
                dict(
                    xy=xy * scale,
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
