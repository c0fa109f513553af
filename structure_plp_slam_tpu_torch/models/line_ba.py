"""Line refinement: orthonormal 4-DoF Gauss-Newton over the 3D lines.

Port of structure_plp_slam_tpu/models/line_ba.py (the line terms of
local_bundle_adjuster_extended_line.cc:69- and
reproj_edge_line3d_orthonormal.h:49-150, with line3d.h:57-140's (U, w)
parameterization): every line with >= 2 segment observations is refined
against the current keyframe poses, all observations in one flat batch,
the per-line normal equations summed by line and solved as batched 4x4
systems. The System runs it after merging a global BA.
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.ops import line_geometry as lg
from structure_plp_slam_tpu_torch.ops import linalg, robust
from structure_plp_slam_tpu_torch.ops.linalg import jacobian_fwd
from structure_plp_slam_tpu_torch.utils.types import segment_plan, segment_sum


def _obs_residual(camera, U, w, delta, R, t, seg):
    """Endpoint-to-line residuals ``[O, 2]`` under line updates ``delta``."""
    U2, w2 = lg.orthonormal_update(U, w, delta)
    l_img = lg.project_line(camera, lg.transform_line(lg.orthonormal_to_plucker(U2, w2), R, t))
    return lg.endpoint_line_distances(l_img, seg[..., 0:2], seg[..., 2:4])


def refine_lines(camera, state: ms.MapState, *, num_iters: int = 4, damping: float = 1e-3):
    """Gauss-Newton refinement of every line with >= 2 observations.
    Returns the state with the refined ``ln_pluck`` (|d| = 1) and the
    stored endpoints projected onto the moved lines (the post-BA endpoint
    trimming, loop_bundle_adjuster.h:87); a refinement that moves an
    endpoint farther than the segment's length + 0.2 is rejected."""
    K, ML = state.kf_line_idx.shape
    L2 = state.ln_pluck.shape[0]
    dev = state.device
    li = state.kf_line_idx.reshape(-1)
    obs_valid = ((state.kf_line_idx >= 0) & state.kf_seg_valid
                 & state.kf_valid[:, None]).reshape(-1)
    li_safe = torch.clamp(li, 0, L2 - 1)
    kf_of = torch.arange(K, device=dev)[:, None].expand(K, ML).reshape(-1)
    R_o = state.kf_pose[kf_of, :, :3]
    t_o = state.kf_pose[kf_of, :, 3]
    seg_o = state.kf_seg.reshape(-1, 4)
    tgt = torch.where(obs_valid, li, L2)
    n_obs = torch.zeros((L2 + 1,), dtype=torch.int64, device=dev)
    n_obs.index_add_(0, tgt, torch.ones_like(tgt))
    refinable = state.ln_valid & (n_obs[:L2] >= 2)
    plan = segment_plan(tgt, L2 + 1, keep=obs_valid)
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    z4 = torch.zeros((li.shape[0], 4), dtype=torch.float32, device=dev)

    U, w = lg.plucker_to_orthonormal(state.ln_pluck)
    for _ in range(num_iters):
        U_o, w_o = U[li_safe], w[li_safe]
        r, J = jacobian_fwd(lambda d: _obs_residual(camera, U_o, w_o, d, R_o, t_o, seg_o), z4, 4)
        chi2 = torch.sum(r * r, dim=-1)
        wgt = torch.where(obs_valid, robust.huber_weight(chi2, robust.CHI2_2D), zero)
        Jw = J * wgt[:, None, None]
        H = segment_sum(tgt, torch.einsum("ori,orj->oij", Jw, J), L2 + 1, plan=plan)[:L2]
        b = segment_sum(tgt, -torch.einsum("ori,or->oi", Jw, r), L2 + 1, plan=plan)[:L2]
        lam = damping * torch.clamp(
            torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 4.0, min=1e-6)
        delta = linalg.solve(H + (lam + 1e-8) * eye4, b)
        ok = refinable & torch.isfinite(delta).all(-1)
        delta = torch.where(ok[:, None], torch.clamp(delta, -0.3, 0.3), zero)
        U, w = lg.orthonormal_update(U, w, delta)

    pluck = lg.orthonormal_to_plucker(U, w)
    pluck = pluck / torch.clamp(torch.linalg.norm(pluck[:, 3:], dim=-1, keepdim=True), min=1e-12)
    eps_old = state.ln_endpoints
    e1 = lg.closest_point_on_line(pluck, eps_old[:, :3])
    e2 = lg.closest_point_on_line(pluck, eps_old[:, 3:])
    # Trust gate: the w-update scales the line's distance from the origin,
    # so an ill-conditioned line can run away while every step stays
    # inside its clip.
    span = torch.linalg.norm(eps_old[:, 3:] - eps_old[:, :3], dim=-1)
    move = torch.maximum(torch.linalg.norm(e1 - eps_old[:, :3], dim=-1),
                         torch.linalg.norm(e2 - eps_old[:, 3:], dim=-1))
    upd = (refinable & (move <= span + 0.2))[:, None]
    return state._replace(
        ln_pluck=torch.where(upd, pluck, state.ln_pluck),
        ln_endpoints=torch.where(upd, torch.cat([e1, e2], dim=-1), eps_old),
    )
