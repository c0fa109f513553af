"""Batched two-view triangulation.

Port of structure_plp_slam_tpu/ops/triangulation.py: DLT normal equations
for N points at once, null vector from a batched symmetric 4x4
eigendecomposition (the eigenvector's sign cancels in the homogeneous
division). On the CPU the rows, their normal matrix and the eigh are
XLA:CPU's arithmetic (fused multiply-adds, LAPACK; ``ops/linalg``): a
low-parallax point moves by millimetres with the last bit of its
normal matrix (ROADMAP C45).
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.ops import linalg


def _safe(x, eps=1e-12):
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def triangulate_dlt(bearings_1, bearings_2, R_21, t_21):
    """Triangulate in camera-1 coordinates from bearing correspondences
    ``[N, 3]``; ``x_2 = R_21 @ x_1 + t_21``."""
    z1 = _safe(bearings_1[..., 2:3])
    z2 = _safe(bearings_2[..., 2:3])
    x1 = bearings_1[..., 0:1] / z1
    y1 = bearings_1[..., 1:2] / z1
    x2 = bearings_2[..., 0:1] / z2
    y2 = bearings_2[..., 1:2] / z2
    P1 = torch.cat(
        [torch.eye(3, dtype=bearings_1.dtype, device=bearings_1.device),
         bearings_1.new_zeros((3, 1))],
        dim=1,
    )
    P2 = torch.cat([R_21, t_21[..., None]], dim=-1)
    A = torch.stack(
        [
            linalg.fms(x1, P1[2], P1[0]),
            linalg.fms(y1, P1[2], P1[1]),
            linalg.fms(x2, P2[..., 2, :], P2[..., 0, :]),
            linalg.fms(y2, P2[..., 2, :], P2[..., 1, :]),
        ],
        dim=-2,
    )  # [N, 4, 4]
    AtA = linalg.einsum_fma("...ij,...ik->...jk", A, A)
    _, v = linalg.eigh(AtA)
    h = v[..., :, 0]  # eigenvector of the smallest eigenvalue
    return h[..., :3] / _safe(h[..., 3])[..., None]


def triangulate_two_view(bear_1, bear_2, R_1w, t_1w, R_2w, t_2w):
    """Triangulate to world coordinates given world->cam poses."""
    R_21 = R_2w @ R_1w.transpose(-1, -2)
    t_21 = t_2w - torch.einsum("...ij,...j->...i", R_21, t_1w)
    pts_c1 = triangulate_dlt(bear_1, bear_2, R_21, t_21)
    return torch.einsum("...ji,...nj->...ni", R_1w, pts_c1 - t_1w[..., None, :])


def rays_parallax_cos(bear_1, bear_2, R_21):
    """cos of the ray parallax angle between correspondences."""
    b1_in_2 = torch.einsum("...ij,...nj->...ni", R_21, bear_1)
    return torch.sum(b1_in_2 * bear_2, dim=-1)


def check_triangulation(pts_c1, bear_1, bear_2, R_21, t_21, *, reproj_thr_sq=5.99,
                        min_parallax_cos=0.9998):
    """Checks after triangulation, ``[N]`` bool: positive depth in both
    views, each point's ray within cos 0.9998 of its bearing, and a
    parallax cosine below ``min_parallax_cos`` (``reproj_thr_sq`` is
    unused, as in the JAX package)."""
    pts_c2 = torch.einsum("...ij,...nj->...ni", R_21, pts_c1) + t_21[..., None, :]
    depth_ok = (pts_c1[..., 2] > 1e-6) & (pts_c2[..., 2] > 1e-6)

    def cos_to(pts, bear):
        d = pts / torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), min=1e-12)
        return torch.sum(d * bear, dim=-1)

    reproj_ok = (cos_to(pts_c1, bear_1) > 0.9998) & (cos_to(pts_c2, bear_2) > 0.9998)
    parallax_ok = rays_parallax_cos(bear_1, bear_2, R_21) < min_parallax_cos
    return depth_ok & reproj_ok & parallax_ok
