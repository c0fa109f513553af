"""Stereo keypoint matching: left/right correspondence -> disparity/depth.

Port of structure_plp_slam_tpu/ops/stereo.py (reference match::stereo,
stereo.cc:45-): the row bucketing is a mask on the dense distance matrix
and the sub-pixel step a batched 3-point parabola over SAD samples at
integer offsets around the match. ``depth_at_points`` gives the stereo
line frontend its endpoint depths. On the CPU the SAD sums and their mean
are XLA:CPU's (``linalg.tree_sum`` / ``tree_mean``), so both functions give
the JAX package's results bit for bit; on the card they are ``torch.sum`` /
``torch.mean``.
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.ops import linalg, matching
from structure_plp_slam_tpu_torch.utils.types import HAMMING_MASKED, rdiv

def match_stereo(img_left, img_right, kp_l_xy, kp_l_level, kp_l_bits, kp_l_valid,
                 kp_r_xy, kp_r_level, kp_r_bits, kp_r_valid, scale_factors, *,
                 focal_x_baseline: float, min_disparity: float = 0.0,
                 max_hamming: int = 80, patch: int = 5, window: int = 5):
    """Returns (x_right [N], depth [N], valid [N]) for the left keypoints;
    x_right is -1 and depth 0 where not valid.

    1. candidates on the same row within 2 sigma(level), disparity in
       (min_disparity, focal_x_baseline], pyramid levels within 1, Hamming
       <= max_hamming; the best per left keypoint (lowest index on ties);
    2. SAD of the left patch (half-width ``patch``) against the right
       image at integer offsets -window..window around the match; the
       first minimum (lowest offset on ties, as ``jnp.argmin`` on flat
       patches) and a parabola through its neighbours give the sub-pixel
       x."""
    H, W = img_left.shape
    dev = img_left.device
    max_disparity = focal_x_baseline  # depth >= baseline (reference bound)

    sig_l = scale_factors[torch.clamp(kp_l_level, 0, scale_factors.shape[0] - 1)]
    d = matching.distance_matrix_mxu(kp_l_bits, kp_r_bits, kp_l_valid, kp_r_valid)
    row_ok = torch.abs(kp_l_xy[:, 1:2] - kp_r_xy[None, :, 1]) <= 2.0 * sig_l[:, None]
    disp = kp_l_xy[:, 0:1] - kp_r_xy[None, :, 0]
    disp_ok = (disp > min_disparity) & (disp <= max_disparity)
    level_ok = torch.abs(kp_l_level[:, None] - kp_r_level[None, :]) <= 1
    d = torch.where(row_ok & disp_ok & level_ok, d, HAMMING_MASKED)
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    matched = best_d <= max_hamming

    # ---- SAD sub-pixel refinement on the full-resolution images ---------
    xl = kp_l_xy[:, 0].to(torch.int64)
    yl = kp_l_xy[:, 1].to(torch.int64)
    xr0 = kp_r_xy[best, 0].to(torch.int64)
    offs = torch.arange(-patch, patch + 1, device=dev)
    dy = offs.repeat_interleave(2 * patch + 1)
    dx = offs.repeat(2 * patch + 1)

    def gather(img, xs, ys):
        yy = torch.clamp(ys[:, None] + dy[None, :], 0, H - 1)
        xx = torch.clamp(xs[:, None] + dx[None, :], 0, W - 1)
        return img[yy, xx]

    tmpl = gather(img_left, xl, yl)  # [N, P]
    cand = torch.stack([gather(img_right, xr0 + off, yl)
                        for off in range(-window, window + 1)], dim=1)  # [N, 2w+1, P]
    sad = linalg.tree_sum(torch.abs(tmpl[:, None, :] - cand), dim=-1)  # [N, 2w+1]
    k = torch.argmin(sad, dim=1)
    k_c = torch.clamp(k, 1, 2 * window - 1)
    s_m = torch.gather(sad, 1, (k_c - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, k_c[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (k_c + 1)[:, None])[:, 0]
    denom = torch.clamp(s_m - 2.0 * s_0 + s_p, min=1e-6)
    delta = torch.clamp(0.5 * (s_m - s_p) / denom, -1.0, 1.0)
    x_right = (xr0 + k_c - window).to(torch.float32) + delta

    disparity = kp_l_xy[:, 0] - x_right
    ok = matched & (disparity > min_disparity) & (disparity <= max_disparity)
    safe_disp = torch.where(ok, torch.clamp(disparity, min=1e-6), torch.ones_like(disparity))
    depth = torch.where(ok, rdiv(focal_x_baseline, safe_disp), torch.zeros_like(disparity))
    x_right = torch.where(ok, x_right, torch.full_like(x_right, -1.0))
    return x_right, depth, ok


def depth_at_points(img_left, img_right, pts_xy, *, focal_x_baseline: float,
                    max_disp: int = 96, patch: int = 3):
    """Depth at arbitrary left-image points by an exhaustive row SAD search
    on the rectified pair (integer disparities 1..max_disp, 3-point
    parabola sub-pixel step): the stereo line frontend's endpoint depths.
    ``pts_xy``: f32 [P, 2]. Returns (depth [P], ok [P])."""
    H, W = img_left.shape
    dev = img_left.device
    xs = pts_xy[:, 0].to(torch.int64)
    ys = pts_xy[:, 1].to(torch.int64)
    r = torch.arange(-patch, patch + 1, device=dev)
    dy = r[:, None].expand(-1, r.shape[0]).reshape(-1)
    dx = r[None, :].expand(r.shape[0], -1).reshape(-1)
    yy = torch.clamp(ys[:, None] + dy[None, :], 0, H - 1)               # [P, K]
    tmpl = img_left[yy, torch.clamp(xs[:, None] + dx[None, :], 0, W - 1)]
    disps = torch.arange(1, max_disp + 1, device=dev)                    # [D]
    xxr = torch.clamp(xs[:, None, None] - disps[None, :, None] + dx[None, None, :], 0, W - 1)
    cand = img_right[yy[:, None, :].expand_as(xxr), xxr]                 # [P, D, K]
    sad = linalg.tree_sum(torch.abs(cand - tmpl[:, None, :]), dim=-1)    # [P, D]

    k = torch.argmin(sad, dim=1)  # first minimum
    k_c = torch.clamp(k, 1, max_disp - 2)

    def at(j):
        return torch.gather(sad, 1, j[:, None])[:, 0]

    s_m, s_0, s_p = at(k_c - 1), at(k_c), at(k_c + 1)
    denom = torch.clamp(s_m - 2.0 * s_0 + s_p, min=1e-6)
    delta = torch.clamp(0.5 * (s_m - s_p) / denom, -1.0, 1.0)
    disparity = (k_c + 1).to(torch.float32) + delta
    # Gates: disparity in range, the match not clipped at the border, the
    # SAD minimum distinct from the row mean (texture present).
    mean_sad = linalg.tree_mean(sad, dim=1)
    ok = ((disparity > 0.5) & (disparity < float(max_disp)) & (xs - disps[k_c] >= patch)
          & (s_0 < 0.8 * torch.clamp(mean_sad, min=1e-6)))
    depth = torch.where(ok, rdiv(focal_x_baseline, torch.clamp(disparity, min=1e-6)),
                        torch.zeros_like(disparity))
    return depth, ok
