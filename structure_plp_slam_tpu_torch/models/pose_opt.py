"""Motion-only pose optimization (the per-frame hot solve).

Port of structure_plp_slam_tpu/models/pose_opt.py (reference g2o
motion-only BA, pose_optimizer.cc:53-: 4 trials x 10 LM iterations, chi2
re-classification between trials at 5.991 mono / 7.815 stereo, Huber
kernel). The solve is batched over a leading dimension: where the JAX
tracker ``vmap``s three association strategies through one solve, the
port passes them as a batch of 3 (each with its own LM damping and step
acceptance).

On the CPU the f32 solve of a perspective or fisheye camera (both project
with the pinhole model) runs ``ops/pose_cpu``, a C source that computes
what XLA:CPU compiles for the JAX tracker's two solves, bit for bit; other
inputs, and every input on the card, run ``_optimize_pose_torch``. The C
source repeats the loop of ``_optimize_pose_torch`` (trials, LM steps,
acceptance, inlier re-classification) and takes its constants, the
``_LM_*`` policy and the chi2 gates, from this module as arguments; the
tests hold both solves against the JAX package's.

Analytic Jacobians (left-multiplicative se(3) update, translation first):
  pc = R @ X + t;  d(pc)/d(xi) = [ I_3 | -hat(pc) ]
  mono residual r = project(pc) - uv_obs, stereo adds x_right.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.camera.base import CameraModel
from structure_plp_slam_tpu_torch.ops import lie, pose_cpu, robust
from structure_plp_slam_tpu_torch.ops import linalg as linalg_ops
from structure_plp_slam_tpu_torch.utils.types import fixed_order_sum, rdiv


class PoseOptResult(NamedTuple):
    R: torch.Tensor            # [(B,) 3, 3]
    t: torch.Tensor            # [(B,) 3]
    inliers: torch.Tensor      # [(B,) N] bool
    num_inliers: torch.Tensor  # [(B,)] i64
    chi2: torch.Tensor         # [(B,)] f32 total weighted error over inliers


# The normal equations' sums over the observations (``...``: the blocks
# of ``fixed_order_sum`` on the CPU).
_EIN_H2 = functools.partial(torch.einsum, "...bnri,...bnrj->...bij")
_EIN_H3 = functools.partial(torch.einsum, "...bni,...bnj->...bij")
_EIN_G2 = functools.partial(torch.einsum, "...bnri,...bnr->...bi")
_EIN_G3 = functools.partial(torch.einsum, "...bni,...bn->...bi")


# The LM policy (reference pose_optimizer.cc): the initial damping, its
# factors after an accepted and a rejected step and their clamps, the floor
# of the damped diagonal, and the trust region of a step (rotation, then
# translation; ops/lie.clamp_tangent's defaults, as the JAX package uses).
_LM_LAMBDA0 = 1e-3
_LM_DOWN, _LM_MIN = 0.5, 1e-7
_LM_UP, _LM_MAX = 4.0, 1e4
_LM_DIAG_FLOOR = 1e-6
_MAX_ROT, _MAX_TRANS = 0.5, 10.0


def _lm_policy() -> tuple:
    """The solve's constants in the order ``ops/pose_cpu`` passes them to the
    C source: the policy above, then the chi2 gates (mono, stereo)."""
    return (_LM_LAMBDA0, _LM_DOWN, _LM_MIN, _LM_UP, _LM_MAX, _LM_DIAG_FLOOR, _MAX_ROT,
            _MAX_TRANS, robust.CHI2_2D, robust.CHI2_3D)


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _residuals(camera, R, t, points_w, obs_uv, obs_xr):
    """Batched residuals: R [B,3,3], t [B,3], points_w [B,N,3]."""
    pc = points_w @ R.transpose(-1, -2) + t[:, None, :]
    uv, _ = cam_base.project(camera, pc)
    r_uv = cam_base.uv_residual(camera, uv, obs_uv)
    xr = uv[..., 0] - rdiv(camera.focal_x_baseline, _safe_z(pc[..., 2]))
    return pc, r_uv, xr - obs_xr


def optimize_pose(camera, R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid, *,
                  num_trials: int = 4, num_iters: int = 10) -> PoseOptResult:
    """Optimize world->camera poses against fixed landmarks.

    ``points_w [N, 3]`` / ``valid [N]`` solve one pose; ``[B, N, 3]`` /
    ``[B, N]`` solve B poses at once (``R0``/``t0`` broadcast). ``obs_uv
    [N, 2]``, ``obs_xr [N]`` (< 0: mono) and ``inv_sigma_sq [N]`` are
    shared by the batch."""
    if (points_w.device.type == "cpu" and points_w.dtype == torch.float32
            and camera.model in (CameraModel.PERSPECTIVE, CameraModel.FISHEYE)):
        R, t, inl, total = pose_cpu.optimize_pose(
            camera, R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid,
            num_trials=num_trials, num_iters=num_iters, policy=_lm_policy())
        return PoseOptResult(R, t, inl, torch.sum(inl.to(torch.int64), dim=-1), total)
    return _optimize_pose_torch(camera, R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid,
                                num_trials=num_trials, num_iters=num_iters)


def _optimize_pose_torch(camera, R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid, *,
                         num_trials: int = 4, num_iters: int = 10) -> PoseOptResult:
    """``optimize_pose`` in PyTorch ops: the card's solve, and the CPU's for
    the other inputs."""
    batched = points_w.ndim == 3
    if not batched:
        points_w, valid = points_w[None], valid[None]
    B = points_w.shape[0]
    R = R0.expand(B, 3, 3) if R0.ndim == 2 else R0
    t = t0.expand(B, 3) if t0.ndim == 1 else t0
    has_stereo = obs_xr >= 0.0
    delta_sq = torch.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D).to(points_w.dtype)
    zero = torch.zeros((), dtype=points_w.dtype, device=points_w.device)

    def chi2_of(r_uv, r_xr):
        return robust.chi2_2d(r_uv, inv_sigma_sq) + torch.where(
            has_stereo, r_xr * r_xr * inv_sigma_sq, zero
        )

    def robust_cost(R, t, inlier):
        _, r_uv, r_xr = _residuals(camera, R, t, points_w, obs_uv, obs_xr)
        chi2 = chi2_of(r_uv, r_xr)
        rho = torch.where(
            chi2 <= delta_sq,
            chi2,
            2.0 * torch.sqrt(delta_sq * torch.clamp(chi2, min=1e-12)) - delta_sq,
        )
        return torch.sum(torch.where(valid & inlier, rho, zero), dim=-1)

    eye = torch.eye(3, dtype=points_w.dtype, device=points_w.device)
    inlier = valid
    for _ in range(num_trials):
        lam = torch.full((B,), _LM_LAMBDA0, dtype=points_w.dtype, device=points_w.device)
        cost = robust_cost(R, t, inlier)
        for _ in range(num_iters):
            pc, r_uv, r_xr = _residuals(camera, R, t, points_w, obs_uv, obs_xr)
            chi2 = chi2_of(r_uv, r_xr)
            w_huber = robust.huber_weight(chi2, delta_sq)
            w = torch.where(valid & inlier, w_huber * inv_sigma_sq, zero)  # [B, N]

            J_uv = cam_base.project_jacobian(camera, pc)  # [B, N, 2, 3]
            x, iz = pc[..., 0], 1.0 / _safe_z(pc[..., 2])
            iz2 = iz * iz
            J_xr_pc = torch.stack(
                [camera.fx * iz, torch.zeros_like(iz),
                 -camera.fx * x * iz2 + camera.focal_x_baseline * iz2],
                dim=-1,
            )  # [B, N, 3]
            dpc = torch.cat([eye.expand(pc.shape[:-1] + (3, 3)), -lie.hat(pc)], dim=-1)
            J2 = linalg_ops.matmul(J_uv, dpc)                            # [B, N, 2, 6]
            J3r = linalg_ops.matmul(J_xr_pc[..., None, :], dpc)[..., 0, :]  # [B, N, 6]
            w_st = torch.where(has_stereo, w, zero)

            Jw2 = J2 * w[..., None, None]
            J3w = J3r * w_st[..., None]
            # Sums over the N observations, in one order on the CPU.
            H = fixed_order_sum(_EIN_H2, Jw2, J2, dim=1) + fixed_order_sum(
                _EIN_H3, J3w, J3r, dim=1)
            g = -(fixed_order_sum(_EIN_G2, Jw2, r_uv, dim=1)
                  + fixed_order_sum(_EIN_G3, J3w, r_xr, dim=1))
            H_lm = H + lam[:, None, None] * torch.diag_embed(
                torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=_LM_DIAG_FLOOR)
            )
            xi = linalg_ops.solve6_spd(H_lm, g)
            ok = torch.isfinite(xi).all(dim=-1)
            xi = torch.where(ok[:, None], lie.clamp_tangent(xi, _MAX_ROT, _MAX_TRANS), zero)
            R_new, t_new = lie.se3_update(R, t, xi)
            new_cost = robust_cost(R_new, t_new, inlier)
            accept = ok & (new_cost < cost)
            R = torch.where(accept[:, None, None], R_new, R)
            t = torch.where(accept[:, None], t_new, t)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.where(accept, torch.clamp(lam * _LM_DOWN, min=_LM_MIN),
                              torch.clamp(lam * _LM_UP, max=_LM_MAX))
        # Re-classify inliers for the next trial (reference :163-201).
        _, r_uv, r_xr = _residuals(camera, R, t, points_w, obs_uv, obs_xr)
        inlier = valid & (chi2_of(r_uv, r_xr) <= delta_sq)

    R = lie.orthonormalize(R)
    _, r_uv, r_xr = _residuals(camera, R, t, points_w, obs_uv, obs_xr)
    total = torch.sum(torch.where(inlier, chi2_of(r_uv, r_xr), zero), dim=-1)
    res = PoseOptResult(R, t, inlier, torch.sum(inlier.to(torch.int64), dim=-1), total)
    if not batched:
        res = PoseOptResult(*(f[0] for f in res))
    return res
