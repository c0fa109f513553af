"""Sim3 corrections of map structures through their reference keyframes.

Port of the correction helpers of structure_plp_slam_tpu/models/
pose_graph.py (:388-477). ``local_ba`` uses them to carry lines and planes
along with the keyframes it moves. The pose-graph solver itself comes
with loop closing (ROADMAP A12).
"""

from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def plucker_from_endpoints(p1, p2):
    """Two 3D points ``[..., 3]`` -> Plücker ``[..., 6]`` ([m, d], d unit)."""
    d = p2 - p1
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([_cross(p1, d), d], dim=-1)


def correct_landmarks(lm_pos, lm_ref_kf, lm_valid, R_old, t_old, s_old,
                      R_new, t_new, s_new):
    """X' = S_new^-1 ( S_old (X) ) through each landmark's reference keyframe."""
    K = R_old.shape[0]
    ref = torch.clamp(lm_ref_kf, 0, K - 1)
    Ro, to, so = R_old[ref], t_old[ref], s_old[ref]
    Rn, tn, sn = R_new[ref], t_new[ref], s_new[ref]
    Xc = so[:, None] * torch.einsum("lij,lj->li", Ro, lm_pos) + to
    sni = 1.0 / torch.clamp(sn, min=1e-12)
    Xw = sni[:, None] * torch.einsum("lji,lj->li", Rn, Xc - tn)
    return torch.where(lm_valid[:, None], Xw, lm_pos)


def correct_lines(ln_endpoints, ln_pluck, ln_ref_kf, ln_valid,
                  R_old, t_old, s_old, R_new, t_new, s_new):
    """Move 3D lines: both endpoints transform as points, the Plücker
    coordinates are rebuilt from them. Returns (endpoints', pluck')."""
    e1 = correct_landmarks(ln_endpoints[:, :3], ln_ref_kf, ln_valid,
                           R_old, t_old, s_old, R_new, t_new, s_new)
    e2 = correct_landmarks(ln_endpoints[:, 3:], ln_ref_kf, ln_valid,
                           R_old, t_old, s_old, R_new, t_new, s_new)
    eps = torch.cat([e1, e2], dim=-1)
    pluck = torch.where(ln_valid[:, None], plucker_from_endpoints(e1, e2), ln_pluck)
    return torch.where(ln_valid[:, None], eps, ln_endpoints), pluck


def correct_planes(pl_coef, pl_ref_kf, pl_valid, R_old, t_old, s_old,
                   R_new, t_new, s_new):
    """Move planes (n, d with n.X + d = 0): n' = R_n^T R_o n,
    d' = (s_o d - n . R_o^T (t_o - t_n)) / s_n."""
    K = R_old.shape[0]
    ref = torch.clamp(pl_ref_kf, 0, K - 1)
    Ro, to, so = R_old[ref], t_old[ref], s_old[ref]
    Rn, tn, sn = R_new[ref], t_new[ref], s_new[ref]
    n = pl_coef[:, :3]
    d = pl_coef[:, 3]
    n_new = torch.einsum("pji,pj->pi", Rn, torch.einsum("pij,pj->pi", Ro, n))
    d_new = (so * d - torch.einsum(
        "pi,pi->p", n, torch.einsum("pji,pj->pi", Ro, to - tn)
    )) / torch.clamp(sn, min=1e-12)
    coef = torch.cat([n_new, d_new[:, None]], dim=-1)
    return torch.where(pl_valid[:, None], coef, pl_coef)


def correct_map_structures(state, R_old, t_old, s_old, R_new, t_new, s_new,
                           lm_mask=None, ln_mask=None, pl_mask=None):
    """Apply a per-keyframe Sim3 correction to points, lines and planes
    through their reference keyframes; masks default to validity."""
    lm_mask = state.lm_valid if lm_mask is None else lm_mask
    ln_mask = state.ln_valid if ln_mask is None else ln_mask
    pl_mask = state.pl_valid if pl_mask is None else pl_mask
    lm_pos = correct_landmarks(state.lm_pos, state.lm_ref_kf, lm_mask,
                               R_old, t_old, s_old, R_new, t_new, s_new)
    eps, pluck = correct_lines(state.ln_endpoints, state.ln_pluck, state.ln_ref_kf,
                               ln_mask, R_old, t_old, s_old, R_new, t_new, s_new)
    pl_coef = correct_planes(state.pl_coef, state.pl_ref_kf, pl_mask,
                             R_old, t_old, s_old, R_new, t_new, s_new)
    return state._replace(lm_pos=lm_pos, ln_endpoints=eps, ln_pluck=pluck,
                          pl_coef=pl_coef)
