"""Monocular map initialization: two-view SfM.

Port of structure_plp_slam_tpu/models/initializer.py (reference
module/initializer.cc + initialize/perspective.cc): area matching, the H
and E model races as batched hypothesis sweeps, model selection by the
score ratio, pose recovery by cheirality, triangulation and median-depth
scaling. The key is split exactly as the JAX package splits it, so both
packages draw the same minimal sets.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from structure_plp_slam_tpu_torch.camera import CameraModel
from structure_plp_slam_tpu_torch.ops import matching, ransac
from structure_plp_slam_tpu_torch.utils import prng
from structure_plp_slam_tpu_torch.utils.types import nanmedian_mean, rdiv

class MonoInitResult(NamedTuple):
    success: torch.Tensor       # bool
    R_2w: torch.Tensor          # [3,3] pose of frame 2 (frame 1 = identity)
    t_2w: torch.Tensor          # [3]
    matches: torch.Tensor       # [N] frame-2 keypoint per frame-1 keypoint (-1)
    points_w: torch.Tensor      # [N, 3] triangulated (frame-1 camera = world)
    point_ok: torch.Tensor      # [N] bool
    num_points: torch.Tensor    # i64
    used_homography: torch.Tensor  # bool
    num_matches: torch.Tensor   # i64 raw area matches (restart-decision input)


def try_initialize_mono(camera, feats1, feats2, key, *, min_triangulated: int = 50,
                        coherent: bool = False) -> MonoInitResult:
    """Attempt two-view initialization between two monocular frames
    (perspective.cc:54-122): area matching, H and E estimation, H chosen
    when ``s_H / (s_H + s_E) > 0.40``, pose by cheirality; it succeeds
    when the chosen pose triangulates ``min_triangulated`` points. ``coherent``
    runs the spatially coherent consensus for both races (GC-RANSAC,
    perspective.cc:70-85). An equirectangular camera matches with the u
    window wrapped and takes the essential matrix of its sphere bearings
    alone, with the spherical cheirality gate (bearing_vector.cc: no
    homography on the sphere). Nothing here reads back to the host."""
    equirect = camera.model is CameraModel.EQUIRECTANGULAR
    m12 = matching.match_in_area(
        feats1["xy"], feats1["angle"], matching.unpack_desc_bits(feats1["desc"]),
        feats1["valid"], feats2["xy"], feats2["angle"],
        matching.unpack_desc_bits(feats2["desc"]), feats2["valid"],
        window=100.0, max_hamming=50, ratio=0.9,
        wrap_cols=float(camera.cols) if equirect else None,
    )
    has = m12 >= 0
    N = m12.shape[0]
    m_safe = torch.clamp(m12, 0, N - 1)
    uv1 = feats1["xy"]
    uv2 = feats2["xy"][m_safe]
    b1 = feats1["bearing"]
    b2 = feats2["bearing"][m_safe]

    k1, k2 = prng.split(key)
    # Angular inlier threshold of about 2 px at this camera's pixel pitch.
    thr_e = max(1e-6, (2.0 / camera.focal_like) ** 2)
    if coherent:
        E, in_e, _ = ransac.essential_ransac_coherent(b1, b2, uv1, has, k2, inlier_thr=thr_e)
    else:
        E, in_e, _ = ransac.essential_ransac(b1, b2, has, k2, inlier_thr=thr_e)
    if equirect:
        Rs_e, ts_e = ransac.decompose_essential(E)
        R, t, pts, good, count = ransac.select_pose_by_cheirality(
            Rs_e, ts_e, b1, b2, in_e & has, spherical=True,
            reproj_cos=math.cos(5.0 / camera.focal_like))
        return MonoInitResult(
            success=count >= min_triangulated, R_2w=R, t_2w=t,
            matches=torch.where(good, m12, -1), points_w=pts, point_ok=good,
            num_points=count, used_homography=torch.zeros((), dtype=torch.bool, device=R.device),
            num_matches=torch.sum(has),
        )
    if coherent:
        H, in_h, s_h = ransac.homography_ransac_coherent(uv1, uv2, has, k1)
    else:
        H, in_h, s_h = ransac.homography_ransac(uv1, uv2, has, k1)

    # The essential score in pixel units (angular err * f^2 ~ px^2), to
    # compare with H's.
    err_px = ransac.epipolar_error_angular(E, b1, b2) * (camera.fx * camera.fy)
    s_e_px = torch.sum(torch.where(has, torch.clamp(ransac.H_INLIER_THR - err_px, min=0.0),
                                   torch.zeros_like(err_px)))
    rel_h = s_h / torch.clamp(s_h + s_e_px, min=1e-9)
    use_h = rel_h > 0.40

    K = torch.tensor([[camera.fx, 0.0, camera.cx], [0.0, camera.fy, camera.cy],
                      [0.0, 0.0, 1.0]], dtype=torch.float32, device=uv1.device)
    Rs_h, ts_h = ransac.decompose_homography(H, K)
    Rs_e, ts_e = ransac.decompose_essential(E)
    # E's 4 candidates twice, so both sets have 8 rows.
    Rs = torch.where(use_h, Rs_h, torch.cat([Rs_e, Rs_e]))
    ts = torch.where(use_h, ts_h, torch.cat([ts_e, ts_e]))
    inliers = torch.where(use_h, in_h, in_e)

    R, t, pts, good, count = ransac.select_pose_by_cheirality(Rs, ts, b1, b2, inliers & has)
    return MonoInitResult(
        success=count >= min_triangulated,
        R_2w=R,
        t_2w=t,
        matches=torch.where(good, m12, -1),
        points_w=pts,
        point_ok=good,
        num_points=count,
        used_homography=use_h,
        num_matches=torch.sum(has),
    )


def scale_to_median_depth(points_w, point_ok, t_2w, target: float = 1.0,
                          use_dist: bool = False):
    """Scale the map so the median point depth (in frame 1 = world) is
    ``target`` (initializer.cc:310-320 scale_map). ``use_dist``: the ray length
    replaces z (the equirectangular path, where points surround the
    camera). Returns (points, t, s)."""
    depth = torch.linalg.norm(points_w, dim=-1) if use_dist else points_w[:, 2]
    med = nanmedian_mean(depth, point_ok)
    s = rdiv(target, torch.clamp(med, min=1e-9))
    return points_w * s, t_2w * s, s
