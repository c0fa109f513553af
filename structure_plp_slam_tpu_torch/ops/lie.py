"""Batched Lie-group operations: SO(3), SE(3) and Sim(3).

Port of structure_plp_slam_tpu/ops/lie.py with the same conventions:
rotations ``[..., 3, 3]``; poses world->camera (``x_c = R @ x_w + t``),
packed ``[..., 3, 4]``; se(3) tangents ``[..., 6]`` ordered
``[rho, phi]``; sim(3) tangents ``[..., 7]`` ordered ``[rho, phi,
sigma]``, a similarity ``(R, t, s)`` acting as ``x -> s R x + t``;
quaternions ``[..., 4]`` in ``[w, x, y, z]`` order. Small angles take
Taylor branches selected with ``torch.where``.
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.ops import linalg as _linalg
from structure_plp_slam_tpu_torch.utils.types import rdiv


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v):
    """so(3) hat operator: ``[..., 3] -> [..., 3, 3]`` skew matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m):
    """Inverse of :func:`hat`: ``[..., 3, 3] -> [..., 3]``."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _small_safe(theta):
    small = torch.abs(theta) < 1e-4
    return small, torch.where(small, torch.ones_like(theta), theta)


def _sinc(theta):
    """sin(x)/x with Taylor fallback near 0."""
    small, safe = _small_safe(theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta):
    """(1-cos(x))/x^2 with Taylor fallback near 0."""
    small, safe = _small_safe(theta)
    return torch.where(
        small, 0.5 - theta * theta / 24.0, (1.0 - torch.cos(safe)) / (safe * safe)
    )


def _sincc(theta):
    """(x - sin(x))/x^3 with Taylor fallback near 0."""
    small, safe = _small_safe(theta)
    return torch.where(
        small,
        1.0 / 6.0 - theta * theta / 120.0,
        (safe - torch.sin(safe)) / (safe * safe * safe),
    )


def _angle(phi):
    return torch.sqrt(torch.clamp(torch.sum(phi * phi, dim=-1), min=1e-24))


def so3_exp(phi):
    """Rodrigues formula: ``[..., 3] -> [..., 3, 3]``."""
    theta = _angle(phi)
    K = hat(phi)
    K2 = K @ K
    return (
        _eye3(phi).expand(K.shape)
        + _sinc(theta)[..., None, None] * K
        + _cosc(theta)[..., None, None] * K2
    )


def so3_log(R):
    """Log map ``[..., 3, 3] -> [..., 3]`` through the quaternion."""
    q = quat_from_rotmat(R)
    w = q[..., 0]
    xyz = q[..., 1:]
    n = torch.sqrt(torch.clamp(torch.sum(xyz * xyz, dim=-1), min=1e-24))
    small = n < 1e-6
    safe_n = torch.where(small, torch.ones_like(n), n)
    safe_w = torch.clamp(w, min=1e-12)
    scale_generic = 2.0 * torch.atan2(n, w) / safe_n
    scale_small = rdiv(2.0, safe_w) * (1.0 - n * n / (3.0 * safe_w * safe_w))
    scale = torch.where(small, scale_small, scale_generic)
    return scale[..., None] * xyz


def so3_left_jacobian(phi):
    """Left Jacobian of SO(3): J_l = I + cosc(θ) K + sincc(θ) K²."""
    theta = _angle(phi)
    K = hat(phi)
    K2 = K @ K
    return (
        _eye3(phi).expand(K.shape)
        + _cosc(theta)[..., None, None] * K
        + _sincc(theta)[..., None, None] * K2
    )


def _mv(A, v):
    return torch.einsum("...ij,...j->...i", A, v)


def se3_exp(xi):
    """se(3) exp: ``[..., 6] ([rho, phi]) -> (R [...,3,3], t [...,3])``."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), _mv(so3_left_jacobian(phi), rho)


def se3_log(R, t):
    """se(3) log: ``(R, t) -> [..., 6]``."""
    phi = so3_log(R)
    rho = _linalg.solve3(so3_left_jacobian(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): apply b first, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_apply(R, t, points):
    """Transform points ``[..., N, 3]`` by pose (R ``[...,3,3]``, t ``[...,3]``)."""
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def pack_pose(R, t):
    """(R, t) -> ``[..., 3, 4]``."""
    return torch.cat([R, t[..., None]], dim=-1)


def unpack_pose(P):
    """``[..., 3, 4]`` -> (R, t)."""
    return P[..., :3], P[..., 3]


def se3_update(R, t, xi):
    """Left-multiplicative update: exp(xi) ∘ (R, t). The optimizer step."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)


def orthonormalize(R):
    """Project a near-rotation back onto SO(3) (quaternion round trip)."""
    return rotmat_from_quat(quat_from_rotmat(R))


def clamp_tangent(xi, max_rot: float = 0.5, max_trans: float = 10.0):
    """Trust-region clamp of an se(3) step ``[..., 6]`` ([rho, phi])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    nr = torch.sqrt(torch.clamp(torch.sum(rho * rho, -1, keepdim=True), min=1e-24))
    npf = torch.sqrt(torch.clamp(torch.sum(phi * phi, -1, keepdim=True), min=1e-24))
    rho = rho * torch.clamp(rdiv(max_trans, nr), max=1.0)
    phi = phi * torch.clamp(rdiv(max_rot, npf), max=1.0)
    return torch.cat([rho, phi], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3): loop closing (Sim3 fitting, pose graph; reference g2o/sim3).
# ---------------------------------------------------------------------------


def _sim3_W(phi, sigma, s):
    """W = A I + B K + C K^2 of the sim(3) exp (Eade's closed form), with
    the small-sigma and small-theta limits."""
    theta = _angle(phi)
    K = hat(phi)
    K2 = K @ K
    eps = 1e-5
    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    safe_sig = torch.where(sig_small, torch.ones_like(sigma), sigma)
    safe_th = torch.where(th_small, torch.ones_like(theta), theta)
    th2 = safe_th * safe_th
    A_generic = (s - 1.0) / safe_sig
    A = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, A_generic)
    a = s * torch.sin(safe_th)
    b = s * torch.cos(safe_th)
    c = th2 + safe_sig * safe_sig
    B_generic = (a * safe_sig + (1.0 - b) * safe_th) / (safe_th * c)
    C_generic = (A_generic - ((b - 1.0) * safe_sig + a * safe_th) / c) / th2
    sig2 = safe_sig * safe_sig
    B_th0 = ((safe_sig - 1.0) * s + 1.0) / sig2
    C_th0 = (s * (0.5 * sig2 - safe_sig + 1.0) - 1.0) / (sig2 * safe_sig)
    B = torch.where(sig_small, _cosc(theta), torch.where(th_small, B_th0, B_generic))
    C = torch.where(sig_small, _sincc(theta), torch.where(th_small, C_th0, C_generic))
    return (A[..., None, None] * _eye3(phi).expand(K.shape)
            + B[..., None, None] * K + C[..., None, None] * K2)


def sim3_exp(xi):
    """sim(3) exp: ``[..., 7] ([rho, phi, sigma]) -> (R, t, s)``."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    return so3_exp(phi), _mv(_sim3_W(phi, sigma, s), rho), s


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra,ta,sa) ∘ (Rb,tb,sb): x -> sa Ra (sb Rb x + tb) + ta."""
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = rdiv(1.0, s)
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def sim3_apply(R, t, s, points):
    return s[..., None, None] * torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def sim3_log(R, t, s):
    """sim(3) log: the inverse of :func:`sim3_exp` (solves W rho = t)."""
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = _linalg.solve3(_sim3_W(phi, sigma, s), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def quat_from_rotmat(R):
    """``[..., 3, 3] -> [..., 4]`` (wxyz), branch-free Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    case = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(case), 4(wxyz)]
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_from_quat(q):
    """``[..., 4] (wxyz) -> [..., 3, 3]``."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
