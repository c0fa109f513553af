"""FAST corner detection as dense tensor ops.

Port of structure_plp_slam_tpu/ops/fast.py: the 16 Bresenham-circle
neighbours as rolled copies, the 9-contiguous test as an AND-rotate
reduction, the OpenCV-flavoured score with the high-threshold bias, 3x3
non-max suppression, then per-cell top-k and a global top-K. Both top-k
steps sort stably so that equal scores keep the lower index first, as
``lax.top_k`` does (FAST scores tie often).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from structure_plp_slam_tpu_torch.utils.types import topk_stable

# Bresenham circle of radius 3 (dy, dx), OpenCV ordering (top, clockwise).
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def _shifted_stack(img):
    """``[H, W]`` -> ``[16, H, W]`` of circle-neighbour values."""
    return torch.stack(
        [torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in _CIRCLE]
    )


def _contiguous_9(flags):
    """``[16, H, W]`` bool -> ``[H, W]``: any 9 contiguous True on the ring."""
    c2 = flags & torch.roll(flags, -1, dims=0)
    c4 = c2 & torch.roll(c2, -2, dims=0)
    c8 = c4 & torch.roll(c4, -4, dims=0)
    c9 = c8 & torch.roll(flags, -8, dims=0)
    return torch.any(c9, dim=0)


def _ring_sum(x):
    """Sum over the 16 ring samples ``[16, H, W] -> [H, W]`` left to right,
    XLA:CPU's order for the reduction; one add per sample, so the card
    sums in the same order as the CPU."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def fast_score_map(img, ini_threshold: float, min_threshold: float):
    """Dense FAST-9 response map (0 where not a corner at
    ``min_threshold``; +1e4 where it also passes ``ini_threshold``)."""
    diff = _shifted_stack(img) - img[None]
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def corner_and_score(thr):
        brighter = diff > thr
        darker = diff < -thr
        is_corner = _contiguous_9(brighter) | _contiguous_9(darker)
        return is_corner, torch.maximum(_ring_sum(torch.where(brighter, diff - thr, zero)),
                                        _ring_sum(torch.where(darker, -diff - thr, zero)))

    corner_lo, score_lo = corner_and_score(min_threshold)
    corner_hi, _ = corner_and_score(ini_threshold)
    score = torch.where(corner_lo, score_lo, zero)
    score = torch.where(corner_hi, score + 1e4, score)
    H, W = img.shape
    interior = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    interior[3 : H - 3, 3 : W - 3] = True
    return torch.where(interior, score, zero)


def nms3x3(score):
    """3x3 non-maximum suppression (-inf padding); keeps local maxima."""
    neigh_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh_max, score, torch.zeros_like(score))


def select_keypoints(score, *, cell: int = 16, per_cell: int = 4, max_total: int,
                     margin: int = 16):
    """Cell-wise top-k then global top-K keypoint selection.

    Returns ``(xy [K, 2] f32 (x, y), response [K] f32, valid [K] bool)``
    with ``K = max_total`` (padded)."""
    H, W = score.shape
    dev = score.device
    ok = torch.zeros((H, W), dtype=torch.bool, device=dev)
    ok[margin : H - margin, margin : W - margin] = True
    score = torch.where(ok, score, torch.zeros_like(score))

    Hp = ((H + cell - 1) // cell) * cell
    Wp = ((W + cell - 1) // cell) * cell
    pad = torch.zeros((Hp, Wp), dtype=score.dtype, device=dev)
    pad[:H, :W] = score
    ncy, ncx = Hp // cell, Wp // cell
    cells = pad.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell
    )
    vals, idx = topk_stable(cells, per_cell)  # [ncells, per_cell]

    cid = torch.arange(ncy * ncx, device=dev)[:, None]
    yy = (cid // ncx) * cell + idx // cell
    xx = (cid % ncx) * cell + idx % cell
    flat_vals = vals.reshape(-1)
    k = min(max_total, flat_vals.shape[0])
    top_vals, top_i = topk_stable(flat_vals, k)
    sel_y = yy.reshape(-1)[top_i]
    sel_x = xx.reshape(-1)[top_i]
    valid = top_vals > 0.0
    if k < max_total:
        padn = max_total - k
        top_vals = torch.cat([top_vals, top_vals.new_zeros(padn)])
        sel_y = torch.cat([sel_y, sel_y.new_zeros(padn)])
        sel_x = torch.cat([sel_x, sel_x.new_zeros(padn)])
        valid = torch.cat([valid, valid.new_zeros(padn)])
    xy = torch.stack([sel_x, sel_y], dim=-1).to(torch.float32)
    resp = torch.where(top_vals > 1e4 * 0.5, top_vals - 1e4, top_vals)
    return xy, resp, valid
