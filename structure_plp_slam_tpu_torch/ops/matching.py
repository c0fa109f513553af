"""Descriptor matching as dense masked distance matrices.

Port of structure_plp_slam_tpu/ops/matching.py (the projection-window
matchers and the bit-plane distance matrix). A 256-bit descriptor maps to
a ±1 vector b; for two descriptors <a, b> = 256 - 2 * hamming, so one f32
matmul of the bit planes gives every Hamming distance exactly (integer
sums of at most 256 terms; TF32 is off package-wide). The per-frame
tracker and the keyframe fuse go through the fused matcher
(ops/fused_match.py) instead; these functions are its plain-path
counterparts, serve the descriptor-only matches and, as in the JAX
package, every projection match of the equirectangular model, whose u
windows wrap (``wrap_cols``) and the kernel's do not. ``match_in_area``
and the rotation histogram serve monocular initialization.
"""

from __future__ import annotations

import math

import torch

from structure_plp_slam_tpu_torch.utils.types import HAMMING_MASKED, topk_stable

# Rotation-consistency histogram (reference match::angle_checker): bins,
# and how many of the most popular keep their matches.
ANGLE_BINS = 30


def _abs_du(pred_u, kp_u, wrap_cols):
    """``|u_pred - u_kp|`` per pair ``[L, N]``, wrapped horizontally when
    ``wrap_cols`` is set (equirectangular images are periodic in u)."""
    du = torch.abs(pred_u[:, None] - kp_u[None, :])
    if wrap_cols is not None:
        du = torch.minimum(du, wrap_cols - du)
    return du


def unpack_desc_bits(desc_u32):
    """``[..., 8]`` descriptors (u32 bit patterns in int32) ``-> [..., 256]``
    f32 in {-1, +1} (bit-plane form)."""
    shifts = torch.arange(32, device=desc_u32.device, dtype=torch.int32)
    bits = (desc_u32[..., :, None] >> shifts) & 1
    bits = bits.reshape(*desc_u32.shape[:-1], 256)
    return bits.to(torch.float32) * 2.0 - 1.0


def distance_matrix_mxu(bits_a, bits_b, valid_a=None, valid_b=None):
    """All-pairs Hamming ``[N, M]`` (int64) from ±1 bit planes ``[N, 256]``
    via one exact f32 matmul (the JAX package's name, from its MXU
    matmul). Invalid entries are ``HAMMING_MASKED``."""
    dot = bits_a @ bits_b.T
    d = ((256.0 - dot) * 0.5).to(torch.int64)
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, HAMMING_MASKED)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, HAMMING_MASKED)
    return d


def _windowed_best(d, pred_uv, pred_level, kp_xy, kp_level, radius_by_level,
                   max_hamming, ratio, level_window, wrap_cols):
    radius = radius_by_level[torch.clamp(pred_level, 0, radius_by_level.shape[0] - 1)]
    dx = _abs_du(pred_uv[:, 0], kp_xy[:, 0], wrap_cols)
    dy = torch.abs(pred_uv[:, 1:2] - kp_xy[None, :, 1])
    in_window = (dx <= radius[:, None]) & (dy <= radius[:, None])
    in_level = torch.abs(kp_level[None, :] - pred_level[:, None]) <= level_window
    d = torch.where(in_window & in_level, d, HAMMING_MASKED)
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    ok = best_d <= max_hamming
    if ratio is not None:
        masked = d.clone()
        masked[torch.arange(d.shape[0], device=d.device), best] = HAMMING_MASKED
        second = torch.amin(masked, dim=1)
        ok = ok & (best_d.to(torch.float32) <= ratio * second.to(torch.float32))
    return torch.where(ok, best, -1), best_d


def match_by_projection_precomputed(d, pred_uv, pred_level, lm_valid, kp_xy,
                                    kp_level, *, radius_by_level,
                                    max_hamming: int = 50, ratio=None,
                                    level_window: int = 1, wrap_cols=None):
    """Windowed matching over a precomputed distance matrix ``d [L, N]``;
    ``wrap_cols`` wraps the u window (equirectangular).
    Returns ``(kp_idx [L] (-1 = none), dist [L])``."""
    d = torch.where(lm_valid[:, None], d, HAMMING_MASKED)
    return _windowed_best(d, pred_uv, pred_level, kp_xy, kp_level,
                          radius_by_level, max_hamming, ratio, level_window, wrap_cols)


def match_by_projection(pred_uv, pred_level, lm_bits, lm_valid, kp_xy, kp_level,
                        kp_bits, kp_valid, *, radius_by_level,
                        max_hamming: int = 50, ratio=None, level_window: int = 1,
                        wrap_cols=None):
    """Landmark -> keypoint matching inside a reprojection window
    (reference match::projection): per-level pixel radius, ±level_window
    pyramid levels, best Hamming with an optional Lowe ratio test;
    ``wrap_cols`` wraps the u window (equirectangular).
    Returns ``(kp_idx [L] (-1 = none), dist [L])``."""
    d = distance_matrix_mxu(lm_bits, kp_bits, lm_valid, kp_valid)
    return _windowed_best(d, pred_uv, pred_level, kp_xy, kp_level,
                          radius_by_level, max_hamming, ratio, level_window, wrap_cols)


def mutual_best(d, max_hamming: int):
    """Each row's best column of a distance matrix ``d [N, M]`` (lowest
    index on ties) and whether it is kept: within ``max_hamming`` and the
    row is that column's best too. Returns ``(best [N], ok [N])``."""
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    rev = torch.argmin(d, dim=0)
    return best, (best_d <= max_hamming) & (rev[best] == torch.arange(d.shape[0], device=d.device))


def match_in_area(kp_xy_1, kp_angle_1, kp_bits_1, kp_valid_1, kp_xy_2, kp_angle_2,
                  kp_bits_2, kp_valid_2, *, window: float = 100.0, max_hamming: int = 50,
                  ratio: float = 0.9, check_orientation: bool = True, wrap_cols=None):
    """2D-2D windowed matching for monocular initialization (reference
    match::area::match_in_consistent_area): frame-1 keypoints match
    frame-2 keypoints inside a square window around their own
    coordinates, Lowe-ratio tested, kept only when mutually best, then
    filtered by the rotation histogram (``check_orientation``);
    ``wrap_cols`` wraps the u window
    (equirectangular). Returns ``idx_2_for_1 [N1]`` (-1 for unmatched)."""
    d = distance_matrix_mxu(kp_bits_1, kp_bits_2, kp_valid_1, kp_valid_2)
    dx = _abs_du(kp_xy_1[:, 0], kp_xy_2[:, 0], wrap_cols)
    dy = torch.abs(kp_xy_1[:, 1:2] - kp_xy_2[None, :, 1])
    d = torch.where((dx <= window) & (dy <= window), d, HAMMING_MASKED)

    rows = torch.arange(d.shape[0], device=d.device)
    best = torch.argmin(d, dim=1)  # lowest index on ties, as jnp.argmin
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    masked = d.clone()
    masked[rows, best] = HAMMING_MASKED
    second = torch.amin(masked, dim=1)
    ok = (best_d <= max_hamming) & (
        best_d.to(torch.float32) <= ratio * second.to(torch.float32)
    )
    # Mutual best only (stronger than the reference's last-writer dedup).
    best_rev = torch.argmin(d, dim=0)
    ok = ok & (best_rev[best] == rows)
    matches = torch.where(ok, best, -1)
    if check_orientation:
        matches = filter_by_rotation_histogram(matches, kp_angle_1, kp_angle_2)
    return matches


def filter_by_rotation_histogram(matches, angle_1, angle_2, keep_bins: int = 3):
    """Keep matches whose orientation difference falls in one of the
    ``keep_bins`` most popular of ANGLE_BINS histogram bins; the lower bin
    wins a tie, as ``lax.top_k``."""
    valid = matches >= 0
    dtheta = angle_1 - angle_2[torch.clamp(matches, 0, angle_2.shape[0] - 1)]
    # jnp.mod: C fmod, then shifted into the divisor's sign.
    two_pi = 2.0 * math.pi
    r = torch.fmod(dtheta, two_pi)
    dtheta = torch.where(r < 0, r + two_pi, r)
    bins = torch.clamp((dtheta * (ANGLE_BINS / two_pi)).to(torch.int64), 0, ANGLE_BINS - 1)
    hist = torch.zeros((ANGLE_BINS,), dtype=torch.int64, device=matches.device)
    hist.index_add_(0, bins, valid.to(torch.int64))
    _, top = topk_stable(hist, keep_bins)
    in_top = (bins[:, None] == top[None, :]).any(dim=1)
    return torch.where(valid & in_top, matches, -1)


def predict_scale_level(dist, max_dist, scale_factor: float, num_levels: int):
    """ceil(log(max_dist / dist) / log(scale_factor)), clipped to the
    pyramid (reference landmark::predict_scale_level)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1.0)
    log_sf = torch.log(torch.tensor(scale_factor, dtype=torch.float32, device=dist.device))
    lv = torch.ceil(torch.log(ratio) / log_sf).to(torch.int64)
    return torch.clamp(lv, 0, num_levels - 1)
