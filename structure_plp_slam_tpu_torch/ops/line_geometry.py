"""3D line geometry: Plücker coordinates, triangulation, reprojection.

Port of structure_plp_slam_tpu/ops/line_geometry.py (reference
optimize/g2o/line3d.{h,cc}, module/two_view_triangulator_line.cc,
optimize/g2o/se3/reproj_edge_line3d_orthonormal.h). All batched.

Conventions:
* A Plücker line is (m, d): direction ``d`` and moment ``m = p x d`` for
  any point ``p`` on the line, stored ``[..., 6]`` as [m, d].
* World->camera transform under (R, t): d_c = R d_w; m_c = R m_w + t x d_c.
* Image line coefficients: l = K_line @ m_c with
  K_line = [[fy, 0, 0], [0, fx, 0], [-fy*cx, -fx*cy, fx*fy]].
* The residual of an observed segment: the signed distances of both
  detected endpoints to ``l`` (a 2-vector).
"""

from __future__ import annotations

import functools

import torch

from structure_plp_slam_tpu_torch.ops import lie


def _unit(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def plucker_from_endpoints(p1, p2):
    """Two 3D points ``[..., 3]`` -> Plücker ``[..., 6]`` ([m, d], d unit)."""
    d = _unit(p2 - p1)
    return torch.cat([torch.linalg.cross(p1, d), d], dim=-1)


def closest_point_on_line(pluck, p):
    """Closest point on the line to ``p`` ``[..., 3]`` (d unit)."""
    m, d = pluck[..., :3], pluck[..., 3:]
    p0 = torch.linalg.cross(d, m)
    t = torch.sum((p - p0) * d, dim=-1, keepdim=True)
    return p0 + t * d


def transform_line(pluck_w, R, t):
    """World->camera Plücker transform. Shapes broadcast."""
    m, d = pluck_w[..., :3], pluck_w[..., 3:]
    d_c = torch.einsum("...ij,...j->...i", R, d)
    m_c = torch.einsum("...ij,...j->...i", R, m) + torch.linalg.cross(
        torch.broadcast_to(t, d_c.shape), d_c)
    return torch.cat([m_c, d_c], dim=-1)


@functools.lru_cache(maxsize=16)
def line_intrinsics(camera, device=None):
    """K_line ``[3, 3]``, cached per camera and device (a copy to the card
    waits for it)."""
    return torch.tensor(
        [[camera.fy, 0.0, 0.0],
         [0.0, camera.fx, 0.0],
         [-camera.fy * camera.cx, -camera.fx * camera.cy, camera.fx * camera.fy]],
        dtype=torch.float32, device=device,
    )


def project_line(camera, pluck_c):
    """Camera-frame Plücker -> image line coefficients ``[..., 3]``
    (un-normalized ax + by + c = 0)."""
    KL = line_intrinsics(camera, pluck_c.device)
    return torch.einsum("ij,...j->...i", KL, pluck_c[..., :3])


def endpoint_line_distances(l, ep1, ep2):
    """Signed distances of two 2D endpoints to line ``l = [a, b, c]``:
    ``[..., 2]``."""
    n = torch.sqrt(torch.clamp(l[..., 0] ** 2 + l[..., 1] ** 2, min=1e-12))
    d1 = (l[..., 0] * ep1[..., 0] + l[..., 1] * ep1[..., 1] + l[..., 2]) / n
    d2 = (l[..., 0] * ep2[..., 0] + l[..., 1] * ep2[..., 1] + l[..., 2]) / n
    return torch.stack([d1, d2], dim=-1)


def _bearing(camera, x, y):
    return torch.stack([(x - camera.cx) / camera.fx, (y - camera.cy) / camera.fy,
                        torch.ones_like(x)], dim=-1)


def triangulate_line_two_view(camera, seg1, seg2, R1, t1, R2, t2):
    """Two observed segments ``[..., 4]`` (x1, y1, x2, y2) -> world Plücker
    line by intersecting their back-projected planes
    (two_view_triangulator_line.cc:52-; the dual Plücker matrix
    L* = pi1 pi2^T - pi2 pi1^T). Returns (pluck_w [..., 6], ok [...])."""

    def backproject_plane(seg, R, t):
        n_c = torch.linalg.cross(_bearing(camera, seg[..., 0], seg[..., 1]),
                                 _bearing(camera, seg[..., 2], seg[..., 3]))
        n_w = torch.einsum("...ji,...j->...i", R, n_c)
        C = -torch.einsum("...ji,...j->...i", R, t)
        d = -torch.sum(n_w * C, dim=-1)
        return n_w, d

    n1, d1 = backproject_plane(seg1, R1, t1)
    n2, d2 = backproject_plane(seg2, R2, t2)
    d = torch.linalg.cross(n1, n2)
    m = d1[..., None] * n2 - d2[..., None] * n1
    d_norm = torch.linalg.norm(d, dim=-1)
    # Degenerate when the planes are parallel (a low-parallax pair).
    parallax_ok = torch.abs(torch.sum(_unit(n1) * _unit(n2), dim=-1)) < 0.9995
    safe = torch.clamp(d_norm, min=1e-12)[..., None]
    return torch.cat([m / safe, d / safe], dim=-1), parallax_ok & (d_norm > 1e-9)


def trim_endpoints(camera, pluck_c, seg):
    """3D endpoints on the (camera-frame) line matching an observed
    segment: the closest points of the line to the back-projected
    endpoint rays. Returns (``[..., 2, 3]`` endpoints, both in front)."""
    m, d = pluck_c[..., :3], pluck_c[..., 3:]
    p0 = torch.linalg.cross(d, m)

    def hit(ux, uy):
        b = _bearing(camera, ux, uy)
        bb = torch.sum(b * b, dim=-1)
        dd = torch.sum(d * d, dim=-1)
        bd = torch.sum(b * d, dim=-1)
        c1 = torch.sum(p0 * b, dim=-1)
        c2 = torch.sum(p0 * d, dim=-1)
        det = bb * dd - bd * bd
        safe_det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        t_line = (bb * (-c2) + bd * c1) / safe_det
        return p0 + t_line[..., None] * d

    e1 = hit(seg[..., 0], seg[..., 1])
    e2 = hit(seg[..., 2], seg[..., 3])
    ok = (e1[..., 2] > 1e-6) & (e2[..., 2] > 1e-6)
    return torch.stack([e1, e2], dim=-2), ok


# ---------------------------------------------------------------------------
# The orthonormal 4-DoF parameterization (line3d.h:57-140: U in SO(3),
# w in SO(2)) for BA updates.
# ---------------------------------------------------------------------------


def plucker_to_orthonormal(pluck):
    """[..., 6] -> (U [..., 3, 3], w [..., 2] with |w| = 1)."""
    m, d = pluck[..., :3], pluck[..., 3:]
    nm = torch.linalg.norm(m, dim=-1)
    nd = torch.linalg.norm(d, dim=-1)
    u1 = m / torch.clamp(nm, min=1e-12)[..., None]
    u2 = d / torch.clamp(nd, min=1e-12)[..., None]
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], dim=-1)
    n = torch.sqrt(torch.clamp(nm * nm + nd * nd, min=1e-24))
    return U, torch.stack([nm / n, nd / n], dim=-1)


def orthonormal_to_plucker(U, w, scale=1.0):
    """(U, w) -> Plücker [..., 6] with |(m, d)| = ``scale``."""
    m = w[..., 0:1] * U[..., :, 0]
    d = w[..., 1:2] * U[..., :, 1]
    return torch.cat([m, d], dim=-1) * scale


def orthonormal_update(U, w, delta):
    """The 4-DoF update: U <- U exp_so3(delta[0:3]), w <- R2(delta[3]) w."""
    U2 = U @ lie.so3_exp(delta[..., :3])
    c = torch.cos(delta[..., 3])
    s = torch.sin(delta[..., 3])
    w1 = c * w[..., 0] - s * w[..., 1]
    w2 = s * w[..., 0] + c * w[..., 1]
    return U2, torch.stack([w1, w2], dim=-1)
