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

With a ``LineWindow`` the window is the joint point + line BA of
local_bundle_adjuster_extended_line.cc:69-: 4-DoF orthonormal lines
(optimize/g2o/line3d.h:57-140) observed as segments whose endpoint
distances to the projected line are the residuals
(reproj_edge_line3d_orthonormal.h:49-150). Their forward-mode Jacobians
come from ``torch.func``; the line blocks are eliminated like the point
blocks.

The BA of the System's two-view init and of its keyframe chain (``_xla=
"init"`` / ``"chain"``, passed by those two call sites only; monocular,
RGB-D and stereo) computes each iteration on the CPU as XLA:CPU compiles the
JAX package's
(``ops/ba_cpu``, a C source); the loop and its policy (iterations, damping,
chi2 gates, step limits, the cull schedule) stay here and ``_ba_policy``
passes the constants. Every other call, and the card, runs the PyTorch
iteration.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.ops import ba_cpu, lie, linalg, robust
from structure_plp_slam_tpu_torch.ops import line_geometry as lg
from structure_plp_slam_tpu_torch.ops.linalg import inv3x3
from structure_plp_slam_tpu_torch.utils.types import fixed_order_sum, rdiv


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


class LineWindow(NamedTuple):
    """Line terms of the joint point + line window."""

    ln_U: torch.Tensor        # [Ml, 3, 3]
    ln_w: torch.Tensor        # [Ml, 2]
    ln_valid: torch.Tensor    # [Ml] bool (>= 2 window observations)
    lobs_cam: torch.Tensor    # [Ol] i64 local camera index
    lobs_line: torch.Tensor   # [Ol] i64 local line index
    lobs_seg: torch.Tensor    # [Ol, 4] detected segment endpoints
    lobs_inv_sigma_sq: torch.Tensor  # [Ol]
    lobs_valid: torch.Tensor  # [Ol] bool


class BAResult(NamedTuple):
    cam_pose: torch.Tensor
    lm_pos: torch.Tensor
    obs_inlier: torch.Tensor    # [O] bool — post-solve chi2 classification
    chi2: torch.Tensor          # f32 — final total error over inliers
    ln_U: torch.Tensor = None   # [Ml, 3, 3] with a LineWindow
    ln_w: torch.Tensor = None   # [Ml, 2]


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


def inv4x4_sym(H):
    """Batched symmetric 4x4 inverse by 3x3-block Schur partitioning."""
    A, b, c = H[..., :3, :3], H[..., :3, 3], H[..., 3, 3]
    Ai = inv3x3(A)
    Aib = torch.einsum("...ij,...j->...i", Ai, b)
    s = c - torch.einsum("...i,...i->...", b, Aib)
    s_inv = 1.0 / torch.where(torch.abs(s) < 1e-12, torch.full_like(s, 1e-12), s)
    TL = Ai + s_inv[..., None, None] * torch.einsum("...i,...j->...ij", Aib, Aib)
    TR = -s_inv[..., None] * Aib
    top = torch.cat([TL, TR[..., :, None]], dim=-1)
    bot = torch.cat([TR, s_inv[..., None]], dim=-1)
    return torch.cat([top, bot[..., None, :]], dim=-2)


def _line_residuals(camera, U, w, R, t, seg, xi, dl):
    """Endpoint-to-line residuals ``[Ol, 2]`` of line observations under
    camera updates ``xi [Ol, 6]`` and line updates ``dl [Ol, 4]``."""
    R2, t2 = lie.se3_update(R, t, xi)
    U2, w2 = lg.orthonormal_update(U, w, dl)
    l_img = lg.project_line(camera, lg.transform_line(lg.orthonormal_to_plucker(U2, w2), R2, t2))
    return lg.endpoint_line_distances(l_img, seg[..., 0:2], seg[..., 2:4])


def line_residuals_and_jacobians(camera, U, w, R, t, seg):
    """(r [Ol, 2], d r / d camera [Ol, 2, 6], d r / d line [Ol, 2, 4]) at
    the linearization point."""
    n = seg.shape[0]
    z6 = seg.new_zeros((n, 6))
    z4 = seg.new_zeros((n, 4))
    r, Jc = linalg.jacobian_fwd(lambda xi: _line_residuals(camera, U, w, R, t, seg, xi, z4), z6, 6)
    _, Jl = linalg.jacobian_fwd(lambda dl: _line_residuals(camera, U, w, R, t, seg, z6, dl), z4, 4)
    return r, Jc, Jl


def _line_chi2(camera, lines, cam_pose, ln_U, ln_w):
    U = ln_U[lines.lobs_line]
    w = ln_w[lines.lobs_line]
    R = cam_pose[lines.lobs_cam, :, :3]
    t = cam_pose[lines.lobs_cam, :, 3]
    r = _line_residuals(camera, U, w, R, t, lines.lobs_seg, lines.lobs_seg.new_zeros(
        (U.shape[0], 6)), lines.lobs_seg.new_zeros((U.shape[0], 4)))
    return torch.sum(r * r, -1) * lines.lobs_inv_sigma_sq


# The step limits: the camera step's trust region (rotation, translation)
# and the landmark step's clip.
_MAX_ROT, _MAX_TRANS, _MAX_LM_STEP = 0.3, 5.0, 5.0


def _ba_policy(damping: float) -> tuple:
    """The solve's constants in the order ``ops/ba_cpu`` passes them to its C
    source: the damping, the monocular and stereo chi2 gates, the step
    limits."""
    return (damping, robust.CHI2_2D, robust.CHI2_3D, _MAX_ROT, _MAX_TRANS, _MAX_LM_STEP)


def ba_solve(camera, prob: BAProblem, lines: LineWindow = None, *, num_iters: int = 15,
             cull_at_iters: tuple = (5,), damping: float = 1e-4,
             obs_grid: bool = False, _xla: str = None) -> BAResult:
    """Damped Gauss-Newton with Schur elimination on a BA window, with
    the line terms of ``lines`` when given. ``cull_at_iters``: iterations
    after which observations are chi2-gated (the reference's two-phase
    structure). ``obs_grid`` is the JAX package's promise that the
    observations form a dense [C, O/C] grid, which there picks a cheaper
    contraction; the port sums by (landmark, camera) bin whatever the
    layout, so the promise leaves the solve as it is. ``_xla``: the JAX
    program whose solve this call is, ``"init"`` (the System's two-view
    init) or ``"chain"`` (its keyframe chain); on the CPU (a pinhole camera,
    no lines) each iteration is then XLA:CPU's arithmetic (``ops/ba_cpu``)."""
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
    if lines is not None:
        Ml = lines.ln_U.shape[0]
        eye4 = torch.eye(4, **f32)
        lpair = lines.lobs_line * C + lines.lobs_cam
        ln_U, ln_w = lines.ln_U, lines.ln_w
        lobs_live = lines.lobs_valid & lines.ln_valid[lines.lobs_line]
        # Pre-gate: an observation grossly inconsistent with the input
        # geometry (e.g. across an uncorrected loop drift) never enters
        # the solve. Scene-adaptive: 9x the median live chi2, at least 9x
        # the chi2 threshold (the median is the lower middle value).
        chi2_l0 = _line_chi2(camera, lines, cam_pose, ln_U, ln_w)
        n_live = torch.sum(lobs_live)
        chi_sorted = torch.sort(torch.where(lobs_live, chi2_l0,
                                            torch.full_like(chi2_l0, float("inf")))).values
        med = chi_sorted.gather(0, torch.clamp((n_live - 1) // 2, 0,
                                               chi2_l0.shape[0] - 1).reshape(1))[0]
        med = torch.where(torch.isfinite(med), med, zero)
        lobs_live = lobs_live & (chi2_l0 <= torch.clamp(9.0 * med, min=9.0 * robust.CHI2_2D))
    if _xla is not None and _xla not in ba_cpu.PROGRAMS:
        raise ValueError(f"_xla={_xla!r}: the XLA:CPU iteration knows {ba_cpu.PROGRAMS}")
    xla = _xla is not None and ba_cpu.serves(camera, prob, lines)
    if xla:
        ba_cpu.check(prob)
        policy = _ba_policy(damping)
    for it in range(num_iters):
        if xla:
            cam_pose, lm_pos = ba_cpu.iteration(camera, prob, cam_pose, lm_pos, obs_live, free,
                                                policy=policy)
            if it in cull_at_iters:
                chi2 = ba_cpu.obs_chi2(camera, prob, cam_pose, lm_pos, policy=policy)
                obs_live = obs_live & (chi2 <= delta_sq)
            continue
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
        if lines is not None:
            r_l, Jc_l, Jl_l = line_residuals_and_jacobians(
                camera, ln_U[lines.lobs_line], ln_w[lines.lobs_line],
                cam_pose[lines.lobs_cam, :, :3], cam_pose[lines.lobs_cam, :, 3], lines.lobs_seg)
            chi2_l = torch.sum(r_l * r_l, -1) * lines.lobs_inv_sigma_sq
            w_lo = torch.where(
                lobs_live,
                robust.huber_weight(chi2_l, robust.CHI2_2D) * lines.lobs_inv_sigma_sq, zero)
            Jc_lw = Jc_l * w_lo[:, None, None]
            Jl_lw = Jl_l * w_lo[:, None, None]
            Hcc = Hcc + _segment_sum(lines.lobs_cam, torch.einsum("ori,orj->oij", Jc_lw, Jc_l), C)
            bc = bc + _segment_sum(lines.lobs_cam, -torch.einsum("ori,or->oi", Jc_lw, r_l), C)
            Hln = _segment_sum(lines.lobs_line, torch.einsum("ori,orj->oij", Jl_lw, Jl_l), Ml)
            bln = _segment_sum(lines.lobs_line, -torch.einsum("ori,or->oi", Jl_lw, r_l), Ml)
            Wl = _segment_sum(lpair, torch.einsum("ori,orj->oij", Jc_lw, Jl_l),
                              Ml * C).reshape(Ml, C, 6, 4)

        # --- Schur elimination ---------------------------------------------
        lam_l = damping * torch.clamp(
            torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, min=1e-6
        )
        Hll_inv = inv3x3(Hll + lam_l * eye3)
        WHinv = torch.einsum("mcij,mjk->mcik", W, Hll_inv)        # [M, C, 6, 3]
        S_red = fixed_order_sum(functools.partial(torch.einsum, "...mcik,...mdjk->...cdij"),
                                WHinv, W)                         # [C, C, 6, 6]
        eye_cc = torch.eye(C, **f32)[:, :, None, None]
        S = -S_red + eye_cc * Hcc[:, None]
        rhs = bc - torch.einsum("mcik,mk->ci", WHinv, bl)         # [C, 6]
        if lines is not None:
            # The 4-DoF line blocks are eliminated like the point blocks.
            lam_ln = damping * torch.clamp(
                torch.diagonal(Hln, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 4.0, min=1e-6)
            Hln_inv = inv4x4_sym(Hln + (lam_ln + 1e-8) * eye4)
            WlHinv = torch.einsum("mcij,mjk->mcik", Wl, Hln_inv)  # [Ml, C, 6, 4]
            S = S - torch.einsum("mcik,mdjk->cdij", WlHinv, Wl)
            rhs = rhs - torch.einsum("mcik,mk->ci", WlHinv, bln)

        # Fixed cameras: identity rows/cols (gauge + window borders).
        S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
        S = S + eye_cc * (torch.where(free[:, None, None], zero, 1.0) * eye6)[:, None]
        diag_blocks = torch.diagonal(S, dim1=0, dim2=1).permute(2, 0, 1)  # [C, 6, 6]
        diag_scale = damping * torch.clamp(
            torch.diagonal(diag_blocks, dim1=-2, dim2=-1).sum(-1) / 6.0, min=1e-6
        )
        S = S + eye_cc * (diag_scale[:, None, None] * eye6)[:, None]
        rhs = rhs * free_f[:, None]

        # A failed factorization gives NaNs (as jax's cho_factor does), and
        # the finite check below then rejects the whole step.
        dx_c = linalg.block_cholesky_solve(S, rhs)

        # Back-substitute landmarks: dX = Hll^-1 (bl - W^T dx_c).
        Wt_dxc = torch.einsum("mcij,ci->mj", W, dx_c)
        dx_l = torch.einsum("mij,mj->mi", Hll_inv, bl - Wt_dxc)
        ok = torch.isfinite(dx_c).all() & torch.isfinite(dx_l).all()
        dx_c = torch.where(ok, lie.clamp_tangent(dx_c, _MAX_ROT, _MAX_TRANS), zero)
        dx_l = torch.where(ok, torch.clamp(dx_l, -_MAX_LM_STEP, _MAX_LM_STEP), zero)

        R_new, t_new = lie.se3_update(cam_pose[:, :, :3], cam_pose[:, :, 3], dx_c)
        cam_pose = torch.where(free[:, None, None], lie.pack_pose(R_new, t_new), cam_pose)
        lm_pos = torch.where(prob.lm_valid[:, None], lm_pos + dx_l, lm_pos)
        if lines is not None:
            # Back-substitute lines: dl = Hln^-1 (bln - Wl^T dx_c). A line
            # moves only while >= 2 live observations constrain it.
            dx_ln = torch.einsum("mij,mj->mi", Hln_inv,
                                 bln - torch.einsum("mcij,ci->mj", Wl, dx_c))
            ln_cnt = _segment_sum(lines.lobs_line, lobs_live.to(torch.int64), Ml)
            ok_ln = lines.ln_valid & (ln_cnt >= 2) & torch.isfinite(dx_ln).all(-1) & ok
            dx_ln = torch.where(ok_ln[:, None], torch.clamp(dx_ln, -0.3, 0.3), zero)
            ln_U, ln_w = lg.orthonormal_update(ln_U, ln_w, dx_ln)

        if it in cull_at_iters:
            _, r_uv2, r_xr2 = _project_residuals(camera, cam_pose, lm_pos, prob)
            obs_live = obs_live & (_obs_chi2(prob, r_uv2, r_xr2, has_stereo) <= delta_sq)
            if lines is not None:
                lobs_live = lobs_live & (_line_chi2(camera, lines, cam_pose, ln_U, ln_w)
                                         <= robust.CHI2_2D)

    # Re-project rotations onto SO(3); fixed cameras keep their input pose.
    if xla:
        cam_pose = ba_cpu.orthonormalize(cam_pose)
    else:
        cam_pose = lie.pack_pose(lie.orthonormalize(cam_pose[:, :, :3]), cam_pose[:, :, 3])
    cam_pose = torch.where(free[:, None, None], cam_pose, prob.cam_pose)
    if xla:
        chi2 = ba_cpu.obs_chi2(camera, prob, cam_pose, lm_pos, policy=policy)
    else:
        _, r_uv, r_xr = _project_residuals(camera, cam_pose, lm_pos, prob)
        chi2 = _obs_chi2(prob, r_uv, r_xr, has_stereo)
    inlier = obs_live & (chi2 <= delta_sq)
    total = (linalg.tree_sum if xla else torch.sum)(torch.where(inlier, chi2, zero))
    if lines is not None:
        return BAResult(cam_pose, lm_pos, inlier, total, ln_U, ln_w)
    return BAResult(cam_pose, lm_pos, inlier, total)
