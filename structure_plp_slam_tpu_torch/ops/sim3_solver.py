"""Batched Sim3 estimation (Umeyama/Horn) and RANSAC.

Port of structure_plp_slam_tpu/ops/sim3_solver.py (reference solve/
sim3_solver.{h,cc}: Horn's closed-form similarity from 3 point pairs,
RANSAC with reprojection checks both ways). All hypotheses are solved and
scored at once. The minimal sets are ``ops/ransac.sample_minimal_sets``,
bit-equal to the JAX package's draws for the same key; a set that repeats
a point leaves Umeyama's rotation undetermined and scores 0 (ROADMAP C16,
``ransac.distinct_sets``).
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.ops import linalg
from structure_plp_slam_tpu_torch.ops.ransac import distinct_sets, sample_minimal_sets
from structure_plp_slam_tpu_torch.utils.types import rdiv

NUM_HYPOTHESES = 128  # minimal sets per RANSAC call (sim3_ransac's default)
CHI2_GATE = 9.21      # 99% of a 2-DoF chi-square: a reprojection inlier (x sigma^2)


def umeyama_alignment(P, Q, with_scale: bool = True):
    """Closed-form similarity minimizing |s R p + t - q|^2.
    ``P, Q: [..., N, 3]``. Returns (R [..., 3, 3], t [..., 3], s [...])."""
    mu_p = torch.mean(P, dim=-2, keepdim=True)
    mu_q = torch.mean(Q, dim=-2, keepdim=True)
    Pc = P - mu_p
    Qc = Q - mu_q
    S = torch.einsum("...ni,...nj->...ij", Qc, Pc) / P.shape[-2]
    U, D, Vt = linalg.svd(S)
    det = linalg.det3(U) * linalg.det3(Vt)
    diag = torch.ones(S.shape[:-1], dtype=P.dtype, device=P.device)
    diag[..., 2] = torch.sign(det)
    R = U @ (diag[..., :, None] * Vt)
    if with_scale:
        var_p = torch.mean(torch.sum(Pc * Pc, dim=-1), dim=-1)
        s = torch.sum(D * diag, dim=-1) / torch.clamp(var_p, min=1e-12)
    else:
        s = torch.ones(S.shape[:-2], dtype=P.dtype, device=P.device)
    t = mu_q[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_p[..., 0, :])
    return R, t, s


def _reproj_err(camera, R, t, s, pts_from, uv_to):
    """Squared pixel error of ``s R p + t`` projected against ``uv_to``;
    inf behind the camera."""
    pc = s[..., None, None] * torch.einsum("...ij,...nj->...ni", R, pts_from) + t[..., None, :]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, torch.full_like(pc[..., 2], 1e-9), pc[..., 2])
    u = camera.fx * pc[..., 0] / z + camera.cx
    v = camera.fy * pc[..., 1] / z + camera.cy
    err = (u - uv_to[..., 0]) ** 2 + (v - uv_to[..., 1]) ** 2
    return torch.where(pc[..., 2] > 0, err, torch.full_like(err, float("inf")))


def sim3_ransac(camera, pts_1, pts_2, uv_1, uv_2, sigma_sq_1, sigma_sq_2, valid, key, *,
                num_hypotheses: int = NUM_HYPOTHESES, fix_scale: bool = False):
    """Estimate ``S_21`` (camera-1-frame points -> camera-2 frame) from
    landmark positions in each keyframe's camera frame and their observed
    keypoints, over ``num_hypotheses`` minimal sets (scale 1 with
    ``fix_scale``). An inlier reprojects within ``CHI2_GATE * sigma^2``
    both ways. Returns (R_21, t_21, s_21, inliers [N], num_inliers)."""
    N = pts_1.shape[0]
    idx = sample_minimal_sets(key, num_hypotheses, 3, N, valid)
    R, t, s = umeyama_alignment(pts_1[idx], pts_2[idx], with_scale=not fix_scale)
    e12 = _reproj_err(camera, R, t, s, pts_1[None], uv_2[None])
    R_inv = R.transpose(-1, -2)
    s_inv = rdiv(1.0, torch.clamp(s, min=1e-12))
    t_inv = -s_inv[..., None] * torch.einsum("...ij,...j->...i", R_inv, t)
    e21 = _reproj_err(camera, R_inv, t_inv, s_inv, pts_2[None], uv_1[None])
    ok = (
        (e12 <= CHI2_GATE * sigma_sq_2[None, :])
        & (e21 <= CHI2_GATE * sigma_sq_1[None, :])
        & valid[None, :]
    )
    counts = torch.where(distinct_sets(idx), torch.sum(ok, dim=-1), 0)
    best = torch.argmax(counts)
    return R[best], t[best], s[best], ok[best], counts[best]


def refine_sim3(camera, R, t, s, pts_1, pts_2, uv_1, uv_2, inliers,
                num_iters: int = 10):
    """Polish a Sim3 on its inliers (the reference's transform_optimizer
    mutual-reprojection refinement): ``num_iters`` Umeyama fits with
    the outliers collapsed onto the inlier centroid, each followed by
    re-gating the one-way reprojection. Returns (R, t, s, inliers, count)."""
    inl = inliers
    for _ in range(num_iters):
        w = inl.to(torch.float32)
        wsum = torch.clamp(torch.sum(w), min=3.0)
        mu1 = torch.sum(pts_1 * w[:, None], dim=0) / wsum
        mu2 = torch.sum(pts_2 * w[:, None], dim=0) / wsum
        P = torch.where(inl[:, None], pts_1, mu1)
        Q = torch.where(inl[:, None], pts_2, mu2)
        R2, t2, s2 = umeyama_alignment(P[None], Q[None])
        R, t, s = R2[0], t2[0], s2[0]
        pc = s * pts_1 @ R.T + t
        z = torch.where(torch.abs(pc[:, 2]) < 1e-9, torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
        u = camera.fx * pc[:, 0] / z + camera.cx
        v = camera.fy * pc[:, 1] / z + camera.cy
        err = (u - uv_2[:, 0]) ** 2 + (v - uv_2[:, 1]) ** 2
        inl = inliers & (err <= CHI2_GATE) & (pc[:, 2] > 0)
    return R, t, s, inl, torch.sum(inl)
