"""Batched PnP RANSAC (the relocalization pose solver).

Port of structure_plp_slam_tpu/ops/pnp.py (reference solve/pnp_solver:
EPnP + RANSAC): each hypothesis is a 6-point DLT fit of the projection
matrix (a batched SVD of [12, 12] systems) factored into the nearest
rotation, scored by reprojection, and the best one polished by the
motion-only LM (``models/pose_opt.optimize_pose``). The minimal sets are
the JAX package's draws for the same key (``utils/prng``).
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.models import pose_opt
from structure_plp_slam_tpu_torch.ops import linalg
from structure_plp_slam_tpu_torch.ops.ransac import distinct_sets, sample_minimal_sets


def pnp_dlt(points_w, bearings):
    """Batched 6-point DLT: ``[S, 6, 3]`` world points + unit bearings ->
    (R [S,3,3], t [S,3]) world->camera, via projection-matrix
    factorization. SVD signs cancel: P's sign is fixed by cheirality."""
    z = bearings[..., 2:3]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    x = bearings[..., 0:1] / safe_z
    y = bearings[..., 1:2] / safe_z
    Xh = torch.cat([points_w, torch.ones_like(x)], dim=-1)  # [S, 6, 4]
    zeros4 = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros4, -x * Xh], dim=-1)  # [S, 6, 12]
    r2 = torch.cat([zeros4, Xh, -y * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [S, 12, 12]
    _, _, Vt = linalg.svd(A)
    P = Vt[..., -1, :].reshape(*A.shape[:-2], 3, 4)
    # Projective depths of points in front of the camera are positive.
    w_depth = torch.einsum("...j,...nj->...n", P[..., 2, :], Xh)
    flip = torch.sum(torch.sign(w_depth), dim=-1) < 0
    P = torch.where(flip[..., None, None], -P, P)
    M = P[..., :3]
    # M = s R: the nearest rotation (det-corrected); a mirrored sample
    # scores ~0 inliers and drops out.
    U, D, Vt2 = linalg.svd(M)
    sgn = torch.sign(linalg.det3(U) * linalg.det3(Vt2))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = linalg.matmul(U * diag[..., None, :], Vt2)
    scale = torch.sum(D * diag, dim=-1) / 3.0
    safe_scale = torch.where(torch.abs(scale) < 1e-12, torch.full_like(scale, 1e-12), scale)
    return R, P[..., 3] / safe_scale[..., None]


def pnp_ransac(camera, points_w, uv, inv_sigma_sq, valid, key, *,
               num_hypotheses: int = 256):
    """RANSAC PnP over ``num_hypotheses`` minimal sets on pixel
    observations, polished with the motion-only LM. Returns (R, t,
    inliers [N], num_inliers)."""
    N = points_w.shape[0]
    bx = (uv[:, 0] - camera.cx) / camera.fx
    by = (uv[:, 1] - camera.cy) / camera.fy
    b = torch.stack([bx, by, torch.ones_like(bx)], dim=-1)
    b = b / linalg.norm(b)[:, None]

    idx = sample_minimal_sets(key, num_hypotheses, 6, N, valid)
    R, t = pnp_dlt(points_w[idx], b[idx])

    pc = torch.einsum("sij,nj->sni", R, points_w) + t[:, None, :]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, torch.full_like(pc[..., 2], 1e-9),
                    pc[..., 2])
    u = camera.fx * pc[..., 0] / z + camera.cx
    v = camera.fy * pc[..., 1] / z + camera.cy
    err = ((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2) * inv_sigma_sq[None]
    ok = (err <= 5.991) & (pc[..., 2] > 0) & valid[None]
    # A set that repeats a point counts no inliers (ransac.distinct_sets).
    best = torch.argmax(torch.where(distinct_sets(idx), torch.sum(ok, dim=-1), 0))

    res = pose_opt.optimize_pose(camera, R[best], t[best], points_w, uv,
                                 torch.full((N,), -1.0, dtype=uv.dtype, device=uv.device),
                                 inv_sigma_sq, ok[best])
    return res.R, res.t, res.inliers, res.num_inliers
