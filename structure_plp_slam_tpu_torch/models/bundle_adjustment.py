"""Batched Schur-complement bundle adjustment (points).

Port of the point path of structure_plp_slam_tpu/models/
bundle_adjustment.py (reference local_bundle_adjuster.cc: two-phase
damped GN with an outlier cull between phases). Per iteration:

  1. residuals + analytic Jacobians for every observation
  2. per-observation normal-equation blocks Hcc [O,6,6], Hll [O,3,3],
     Hcl [O,6,3], bc [O,6], bl [O,3]
  3. segment sums into cameras, landmarks and (landmark, camera) pairs —
     ``index_add_`` on the flattened ids, the torch form of the JAX
     package's one-hot contractions (its ``obs_grid`` layout, where the
     observations are a dense [C, O/C] camera grid, is just one case)
  4. Schur complement S = Hcc - W Hll^-1 W^T, dense [6C, 6C]
  5. Cholesky solve of S, back-substitution of landmark updates.

The joint point+line window (``LineWindow``) comes with ROADMAP A14.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.ops import lie, robust
from structure_plp_slam_tpu_torch.ops.linalg import inv3x3
from structure_plp_slam_tpu_torch.utils.types import rdiv


class BAProblem(NamedTuple):
    """Fixed-shape BA window."""

    cam_pose: torch.Tensor      # [C, 3, 4] world->cam
    cam_fixed: torch.Tensor     # [C] bool — gauge/fixed cameras
    cam_valid: torch.Tensor     # [C] bool
    lm_pos: torch.Tensor        # [M, 3]
    lm_valid: torch.Tensor      # [M] bool
    obs_cam: torch.Tensor       # [O] i64 — local camera index
    obs_lm: torch.Tensor        # [O] i64 — local landmark index
    obs_uv: torch.Tensor        # [O, 2] f32
    obs_xr: torch.Tensor        # [O] f32 (< 0: mono)
    obs_inv_sigma_sq: torch.Tensor  # [O] f32
    obs_valid: torch.Tensor     # [O] bool


class BAResult(NamedTuple):
    cam_pose: torch.Tensor
    lm_pos: torch.Tensor
    obs_inlier: torch.Tensor    # [O] bool — post-solve chi2 classification
    chi2: torch.Tensor          # f32 — final total error over inliers


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _project_residuals(camera, cam_pose, lm_pos, prob: BAProblem):
    R = cam_pose[prob.obs_cam, :, :3]
    t = cam_pose[prob.obs_cam, :, 3]
    pc = torch.einsum("oij,oj->oi", R, lm_pos[prob.obs_lm]) + t
    uv, _ = cam_base.project(camera, pc)
    r_uv = cam_base.uv_residual(camera, uv, prob.obs_uv)
    r_xr = (uv[..., 0] - rdiv(camera.focal_x_baseline, _safe_z(pc[:, 2]))) - prob.obs_xr
    return pc, r_uv, r_xr


def _obs_chi2(prob, r_uv, r_xr, has_stereo):
    chi2 = torch.sum(r_uv * r_uv, -1) * prob.obs_inv_sigma_sq
    return chi2 + torch.where(has_stereo, r_xr * r_xr * prob.obs_inv_sigma_sq, 0.0)


def _segment_sum(ids, vals, n):
    """Sum rows of ``vals [O, ...]`` into ``n`` bins by ``ids``."""
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add_(0, ids, vals)


def ba_solve(camera, prob: BAProblem, *, num_iters: int = 15,
             cull_at_iters: tuple = (5,), damping: float = 1e-4) -> BAResult:
    """Damped Gauss-Newton with Schur elimination on a BA window.
    ``cull_at_iters``: iterations after which observations are chi2-gated
    (the reference's two-phase structure)."""
    cam_base.dispatch(camera)
    C = prob.cam_pose.shape[0]
    M = prob.lm_pos.shape[0]
    dev = prob.cam_pose.device
    f32 = dict(dtype=torch.float32, device=dev)
    has_stereo = prob.obs_xr >= 0.0
    delta_sq = torch.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D).to(torch.float32)
    zero = torch.zeros((), **f32)
    eye3 = torch.eye(3, **f32)
    eye6 = torch.eye(6, **f32)
    free = (~prob.cam_fixed) & prob.cam_valid
    free_f = free.to(torch.float32)
    pair = prob.obs_lm * C + prob.obs_cam  # (landmark, camera) bin of each obs

    cam_pose, lm_pos = prob.cam_pose, prob.lm_pos
    obs_live = prob.obs_valid & prob.cam_valid[prob.obs_cam] & prob.lm_valid[prob.obs_lm]
    for it in range(num_iters):
        pc, r_uv, r_xr = _project_residuals(camera, cam_pose, lm_pos, prob)
        chi2 = _obs_chi2(prob, r_uv, r_xr, has_stereo)
        w = torch.where(
            obs_live, robust.huber_weight(chi2, delta_sq) * prob.obs_inv_sigma_sq, zero
        )
        # Behind-camera observations contribute nothing this iteration.
        w = torch.where(cam_base.cheirality(camera, pc), w, zero)

        # --- Jacobians ----------------------------------------------------
        x = pc[:, 0]
        iz = 1.0 / _safe_z(pc[:, 2])
        iz2 = iz * iz
        J_uv_pc = cam_base.project_jacobian(camera, pc)  # [O, 2, 3]
        J_xr_pc = torch.stack(
            [camera.fx * iz, torch.zeros_like(iz),
             -camera.fx * x * iz2 + camera.focal_x_baseline * iz2],
            dim=-1,
        )  # [O, 3]
        R = cam_pose[prob.obs_cam, :, :3]
        dpc_dxi = torch.cat([eye3.expand(pc.shape[0], 3, 3), -lie.hat(pc)], dim=-1)
        Jc2 = J_uv_pc @ dpc_dxi                          # [O, 2, 6]
        Jl2 = J_uv_pc @ R                                # [O, 2, 3]
        Jc3 = (J_xr_pc[:, None, :] @ dpc_dxi)[:, 0]      # [O, 6]
        Jl3 = (J_xr_pc[:, None, :] @ R)[:, 0]            # [O, 3]
        w_st = torch.where(has_stereo, w, zero)
        Jc2w = Jc2 * w[:, None, None]
        Jl2w = Jl2 * w[:, None, None]
        Jc3w = Jc3 * w_st[:, None]
        Jl3w = Jl3 * w_st[:, None]

        # --- normal-equation blocks ----------------------------------------
        Hcc_o = torch.einsum("ori,orj->oij", Jc2w, Jc2) + torch.einsum("oi,oj->oij", Jc3w, Jc3)
        Hll_o = torch.einsum("ori,orj->oij", Jl2w, Jl2) + torch.einsum("oi,oj->oij", Jl3w, Jl3)
        Hcl_o = torch.einsum("ori,orj->oij", Jc2w, Jl2) + torch.einsum("oi,oj->oij", Jc3w, Jl3)
        bc_o = -(torch.einsum("ori,or->oi", Jc2w, r_uv) + Jc3 * (w_st * r_xr)[:, None])
        bl_o = -(torch.einsum("ori,or->oi", Jl2w, r_uv) + Jl3 * (w_st * r_xr)[:, None])
        Hcc = _segment_sum(prob.obs_cam, Hcc_o, C)
        bc = _segment_sum(prob.obs_cam, bc_o, C)
        Hll = _segment_sum(prob.obs_lm, Hll_o, M)
        bl = _segment_sum(prob.obs_lm, bl_o, M)
        W = _segment_sum(pair, Hcl_o, M * C).reshape(M, C, 6, 3)

        # --- Schur elimination ---------------------------------------------
        lam_l = damping * torch.clamp(
            torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, min=1e-6
        )
        Hll_inv = inv3x3(Hll + lam_l * eye3)
        WHinv = torch.einsum("mcij,mjk->mcik", W, Hll_inv)        # [M, C, 6, 3]
        S_red = torch.einsum("mcik,mdjk->cdij", WHinv, W)         # [C, C, 6, 6]
        eye_cc = torch.eye(C, **f32)[:, :, None, None]
        S = -S_red + eye_cc * Hcc[:, None]
        rhs = bc - torch.einsum("mcik,mk->ci", WHinv, bl)         # [C, 6]

        # Fixed cameras: identity rows/cols (gauge + window borders).
        S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
        S = S + eye_cc * (torch.where(free[:, None, None], zero, 1.0) * eye6)[:, None]
        diag_blocks = torch.diagonal(S, dim1=0, dim2=1).permute(2, 0, 1)  # [C, 6, 6]
        diag_scale = damping * torch.clamp(
            torch.diagonal(diag_blocks, dim1=-2, dim2=-1).sum(-1) / 6.0, min=1e-6
        )
        S = S + eye_cc * (diag_scale[:, None, None] * eye6)[:, None]
        rhs = rhs * free_f[:, None]

        S_dense = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
        L_chol, info = torch.linalg.cholesky_ex(S_dense)
        dx_c = torch.cholesky_solve(rhs.reshape(6 * C, 1), L_chol).reshape(C, 6)
        # A failed factorization gives NaNs (as jax's cho_factor does), and
        # the finite check below then rejects the whole step.
        dx_c = torch.where(info == 0, dx_c, torch.nan)

        # Back-substitute landmarks: dX = Hll^-1 (bl - W^T dx_c).
        Wt_dxc = torch.einsum("mcij,ci->mj", W, dx_c)
        dx_l = torch.einsum("mij,mj->mi", Hll_inv, bl - Wt_dxc)
        ok = torch.isfinite(dx_c).all() & torch.isfinite(dx_l).all()
        dx_c = torch.where(ok, lie.clamp_tangent(dx_c, 0.3, 5.0), zero)
        dx_l = torch.where(ok, torch.clamp(dx_l, -5.0, 5.0), zero)

        R_new, t_new = lie.se3_update(cam_pose[:, :, :3], cam_pose[:, :, 3], dx_c)
        cam_pose = torch.where(free[:, None, None], lie.pack_pose(R_new, t_new), cam_pose)
        lm_pos = torch.where(prob.lm_valid[:, None], lm_pos + dx_l, lm_pos)

        if it in cull_at_iters:
            _, r_uv2, r_xr2 = _project_residuals(camera, cam_pose, lm_pos, prob)
            obs_live = obs_live & (_obs_chi2(prob, r_uv2, r_xr2, has_stereo) <= delta_sq)

    # Re-project rotations onto SO(3); fixed cameras keep their input pose.
    cam_pose = lie.pack_pose(lie.orthonormalize(cam_pose[:, :, :3]), cam_pose[:, :, 3])
    cam_pose = torch.where(free[:, None, None], cam_pose, prob.cam_pose)
    _, r_uv, r_xr = _project_residuals(camera, cam_pose, lm_pos, prob)
    chi2 = _obs_chi2(prob, r_uv, r_xr, has_stereo)
    inlier = obs_live & (chi2 <= delta_sq)
    return BAResult(cam_pose, lm_pos, inlier, torch.sum(torch.where(inlier, chi2, zero)))
