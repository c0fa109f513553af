"""Frame-to-map tracking: association + motion-only optimization.

Port of structure_plp_slam_tpu/models/tracker.py (reference
tracking_module.cc:424-835, frame_tracker.cc, local_map_updater.cc). Each
frame runs a narrow and a wide projection-window pass over the previous
frame's landmarks plus a descriptor-only fallback against the reference
keyframe, solves the three strategies as one batched LM, then matches the
local map and refines over the union.

All three projection-window passes go through the fused matcher
(ops/fused_match.py) — the JAX package's TPU branch. The keypoint meta is
built once per frame; a row is inactive through radius -1 and a keypoint
through level 1e9. Those masks and the fused kernel's level gate
``|Δlevel| <= 1.5`` compute the same function as the JAX package's
CPU branch (``match_by_projection_precomputed`` with ``level_window=1``
on integer levels), so the port is held against the JAX tracker on the
CPU. The equirectangular model's u windows wrap and the kernel's do not,
so that model takes the masked distance matrices with ``wrap_cols``
instead, as in the JAX package (tracker.py:149-157).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_plp_slam_tpu_torch.camera import CameraModel
from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.models import pose_opt
from structure_plp_slam_tpu_torch.ops import matching
from structure_plp_slam_tpu_torch.ops.fused_match import fused_match
from structure_plp_slam_tpu_torch.utils.types import (
    HAMMING_MASKED,
    nonzero_static,
    scatter_set,
)

KP_INVALID_LEVEL = 1e9


class TrackResult(NamedTuple):
    R: torch.Tensor            # [3, 3]
    t: torch.Tensor            # [3]
    kp_lm: torch.Tensor        # [N] i64 landmark per keypoint (-1 none)
    num_tracked: torch.Tensor  # i64 inlier landmark matches after local-map opt
    ref_kf: torch.Tensor       # i64 keyframe sharing most landmarks
    lm_vis: torch.Tensor       # [L] bool landmarks predicted visible (stats)
    lm_fnd: torch.Tensor       # [L] bool landmarks actually matched (stats)
    ref_tracked: torch.Tensor      # i64 reliable landmarks in ref_kf
    n_close_tracked: torch.Tensor  # i64 close-depth keypoints with a landmark
    n_close_untracked: torch.Tensor  # i64 close-depth keypoints without one


def _project_landmarks(camera, R, t, lm_pos):
    pc = lm_pos @ R.T + t
    uv, _ = cam_base.project(camera, pc)
    return uv, pc


def _visibility(camera, R, uv, pc, lm_normal, lm_dist_min, lm_dist_max, margin=5.0):
    """can_observe gating (frame.cc:797 / landmark.h:105-110): in image,
    positive depth, distance within the ORB scale bounds, viewing angle
    < 60 deg to the landmark's mean viewing direction."""
    in_img = cam_base.in_image(camera, uv, margin)
    dist = torch.linalg.norm(pc, dim=-1)
    in_scale = (dist >= 0.8 * lm_dist_min) & (dist <= 1.3 * lm_dist_max)
    view_c = pc / torch.clamp(dist[:, None], min=1e-9)
    cos = torch.sum(view_c * (lm_normal @ R.T), dim=-1)
    return in_img & cam_base.cheirality(camera, pc) & in_scale & (cos >= 0.5), dist


def _assoc_to_kp_lm(lm_idx_global, kp_best, dist, num_kps):
    """Per-landmark best keypoint -> per-keypoint landmark. Conflicts go to
    the smaller distance (scatter-min); equal distances to the last
    candidate row (:func:`scatter_set`'s rule)."""
    has = kp_best >= 0
    safe_kp = torch.where(has, kp_best, num_kps)
    best_per_kp = torch.full(
        (num_kps + 1,), HAMMING_MASKED, dtype=dist.dtype, device=dist.device
    ).scatter_reduce(0, safe_kp, dist, "amin")
    wins = has & (dist <= best_per_kp[safe_kp])
    kp_lm = torch.full((num_kps + 1,), -1, dtype=torch.int64, device=dist.device)
    return scatter_set(kp_lm, safe_kp, lm_idx_global, wins)[:num_kps]


def _lm_meta(uv, cand, radius, pred_level):
    """``[L, 4]`` rows (u, v, radius or -1 when inactive, level)."""
    return torch.stack(
        [uv[:, 0], uv[:, 1], torch.where(cand, radius, -1.0), pred_level.to(torch.float32)],
        dim=-1,
    ).contiguous()


def track_frame(camera, state: ms.MapState, feats, R_pred, t_pred, last_kp_lm,
                prev_ref_kf, inv_sigma_sq_table, obs_indicator, min_obs=3, *,
                num_levels: int = 8, scale_factor: float = 1.2,
                local_cap: int = 8192) -> TrackResult:
    """One full tracking step (motion association + local-map refinement).

    ``feats``: the current frame's feature dict (Frontend); ``R_pred``,
    ``t_pred``: motion-model prediction; ``last_kp_lm [N]``: the previous
    frame's keypoint -> landmark ids; ``obs_indicator``: the cached
    ``[K, L]`` observation indicator."""
    dev = state.device
    N = feats["xy"].shape[0]
    L = state.lm_pos.shape[0]
    K = state.kf_pose.shape[0]
    kp_desc = feats["desc"]
    kp_bits = matching.unpack_desc_bits(kp_desc)
    kp_valid = feats["valid"]
    wrap_cols = float(camera.cols) if camera.model is CameraModel.EQUIRECTANGULAR else None
    level = feats["level"]
    obs_info = inv_sigma_sq_table[torch.clamp(level, 0, num_levels - 1)]
    radius_narrow = torch.tensor(
        [15.0 * scale_factor**lv for lv in range(num_levels)],
        dtype=torch.float32, device=dev,
    )
    radius_wide = radius_narrow * 2.0
    kp_level_f = level.to(torch.float32)
    kp_meta = torch.stack(
        [feats["xy"][:, 0], feats["xy"][:, 1],
         torch.where(kp_valid, kp_level_f, KP_INVALID_LEVEL)],
        dim=-1,
    ).contiguous()

    def assoc(R, t, ids, ids_valid, desc_c, d_pre, radius_table, max_h, ratio):
        """Windowed projection matching over a compact candidate set: the
        fused matcher, or (equirectangular) the wrapped window over the
        precomputed distance matrix ``d_pre``."""
        dmax_c = state.lm_dist_max[ids]
        uv, pc = _project_landmarks(camera, R, t, state.lm_pos[ids])
        vis, dist = _visibility(camera, R, uv, pc, state.lm_normal[ids],
                                state.lm_dist_min[ids], dmax_c)
        cand = ids_valid & vis
        pred_level = matching.predict_scale_level(dist, dmax_c, scale_factor, num_levels)
        if wrap_cols is not None:
            kp_best, d_best = matching.match_by_projection_precomputed(
                d_pre, uv, pred_level, cand, feats["xy"], level, radius_by_level=radius_table,
                max_hamming=max_h, ratio=ratio, wrap_cols=wrap_cols)
            return _assoc_to_kp_lm(ids, kp_best, d_best, N), vis
        radius = radius_table[torch.clamp(pred_level, 0, num_levels - 1)]
        best_d, second_d, kb = fused_match(
            desc_c, _lm_meta(uv, cand, radius, pred_level), kp_desc, kp_meta
        )
        ok = best_d <= max_h
        if ratio is not None:
            ok = ok & (best_d <= ratio * second_d)
        kp_best = torch.where(ok, kb.to(torch.int64), -1)
        return _assoc_to_kp_lm(ids, kp_best, best_d.to(torch.int64), N), vis

    # ---------------- stage 1: last-frame landmarks, narrow + wide --------
    ids1 = torch.clamp(last_kp_lm, 0, L - 1)
    valid1 = (last_kp_lm >= 0) & state.lm_valid[ids1]
    desc1 = state.lm_desc[ids1].contiguous()
    d1 = (None if wrap_cols is None else
          matching.distance_matrix_mxu(matching.unpack_desc_bits(desc1), kp_bits,
                                          valid1, kp_valid))
    # Loose Hamming bound (match::base HAMMING_DIST_THR_HIGH = 100): the
    # spatial window is the primary gate; chi2 in the LM culls mistakes.
    kp_lm_n0, _ = assoc(R_pred, t_pred, ids1, valid1, desc1, d1, radius_narrow, 100, None)
    kp_lm_w0, _ = assoc(R_pred, t_pred, ids1, valid1, desc1, d1, radius_wide, 100, None)

    # Fallback: descriptor-only mutual matching against the reference
    # keyframe's landmarks (bow_match_based_track, frame_tracker.cc:127).
    ref_lm_prev = state.kf_lm_idx[prev_ref_kf]
    ref_has = (ref_lm_prev >= 0) & state.kf_kp_valid[prev_ref_kf]
    d_ref = matching.distance_matrix_mxu(
        kp_bits, matching.unpack_desc_bits(state.kf_desc[prev_ref_kf]), kp_valid, ref_has,
    )
    best_r, ok_r = matching.mutual_best(d_ref, 50)
    kp_lm_f0 = torch.where(ok_r, ref_lm_prev[best_r], -1)

    # The three strategies as ONE batched LM (shorter 2x8 schedule).
    kp_lm_s = torch.stack([kp_lm_n0, kp_lm_w0, kp_lm_f0])  # [3, N]
    pts_s = state.lm_pos[torch.clamp(kp_lm_s, 0, L - 1)]
    valid_s = (kp_lm_s >= 0) & kp_valid[None]
    res_s = pose_opt.optimize_pose(
        camera, R_pred, t_pred, pts_s, feats["xy"], feats["xr"], obs_info, valid_s,
        num_trials=2, num_iters=8,
    )
    kp_lm_post = torch.where(res_s.inliers, kp_lm_s, -1)
    n_inl = res_s.num_inliers
    use_narrow = n_inl[0] >= 20
    use_wide = ~use_narrow & (n_inl[1] >= torch.clamp(n_inl[2], min=20))
    sel = torch.where(use_narrow, 0, torch.where(use_wide, 1, 2))
    R1, t1, kp_lm_1 = res_s.R[sel], res_s.t[sel], kp_lm_post[sel]

    # ---------------- stage 2: local map -----------------------------------
    ind = obs_indicator
    kp_lm_1c = torch.clamp(kp_lm_1, 0, L - 1)
    cur_lm = torch.zeros((L,), dtype=torch.float32, device=dev).index_add_(
        0, kp_lm_1c, (kp_lm_1 >= 0).to(torch.float32)
    )
    share = torch.where(state.kf_valid, ind @ cur_lm, -1.0)
    ref_kf = torch.argmax(share)
    W_ref = ind @ ind[ref_kf]
    kf_local = state.kf_valid & ((W_ref >= 15.0) | (torch.arange(K, device=dev) == ref_kf))
    lm_local = ((kf_local.to(torch.float32) @ ind) > 0) & state.lm_valid

    # Gather the local map into a ``local_cap`` candidate budget, from the
    # HIGH end of the slot range (newest landmarks kept on overflow).
    Lc2 = min(local_cap, L)
    ids2 = (L - 1) - nonzero_static(torch.flip(lm_local, (0,)), Lc2, L - 1)
    valid2 = torch.arange(Lc2, device=dev) < torch.sum(lm_local)
    all_rows = torch.ones_like(kp_lm_1, dtype=torch.bool)
    already = scatter_set(
        torch.zeros((L,), dtype=torch.bool, device=dev), kp_lm_1c, kp_lm_1 >= 0, all_rows
    )
    uv2, pc2 = _project_landmarks(camera, R1, t1, state.lm_pos[ids2])
    dmax2 = state.lm_dist_max[ids2]
    vis2, dist2 = _visibility(camera, R1, uv2, pc2, state.lm_normal[ids2],
                              state.lm_dist_min[ids2], dmax2)
    cand2 = valid2 & vis2 & ~already[ids2]
    pred_level2 = matching.predict_scale_level(dist2, dmax2, scale_factor, num_levels)
    kp_free = kp_valid & (kp_lm_1 < 0)
    if wrap_cols is not None:
        d2 = matching.distance_matrix_mxu(matching.unpack_desc_bits(state.lm_desc[ids2]),
                                             kp_bits, valid2, kp_valid)
        kp_best2, d_best2 = matching.match_by_projection_precomputed(
            torch.where(kp_free[None, :], d2, HAMMING_MASKED), uv2, pred_level2, cand2,
            feats["xy"], level, radius_by_level=radius_narrow, max_hamming=100, ratio=0.85,
            wrap_cols=wrap_cols)
    else:
        kp_meta2 = kp_meta.clone()
        kp_meta2[:, 2] = torch.where(kp_free, kp_level_f, KP_INVALID_LEVEL)
        radius2 = radius_narrow[torch.clamp(pred_level2, 0, num_levels - 1)]
        bd2, sd2, kb2 = fused_match(
            state.lm_desc[ids2].contiguous(), _lm_meta(uv2, cand2, radius2, pred_level2),
            kp_desc, kp_meta2,
        )
        ok2 = (bd2 <= 100) & (bd2 <= 0.85 * sd2)
        kp_best2 = torch.where(ok2, kb2.to(torch.int64), -1)
        d_best2 = bd2.to(torch.int64)
    kp_lm_2 = _assoc_to_kp_lm(ids2, kp_best2, d_best2, N)
    # Valid entries of the union are unique landmark ids (see the JAX
    # tracker's invariant note).
    kp_lm_union = torch.where(kp_lm_1 >= 0, kp_lm_1, kp_lm_2)
    vis_cnt = torch.zeros((L,), dtype=torch.int64, device=dev)
    vis_cnt.scatter_reduce_(0, ids2, (vis2 & valid2).to(torch.int64), "amax")
    vis_cnt.scatter_reduce_(0, kp_lm_1c, (kp_lm_1 >= 0).to(torch.int64), "amax")

    has_u = (kp_lm_union >= 0) & kp_valid
    pts_u = state.lm_pos[torch.clamp(kp_lm_union, 0, L - 1)]
    res2 = pose_opt.optimize_pose(
        camera, R1, t1, pts_u, feats["xy"], feats["xr"], obs_info, has_u
    )
    kp_lm_final = torch.where(res2.inliers, kp_lm_union, -1)
    lm_fnd = scatter_set(
        torch.zeros((L,), dtype=torch.bool, device=dev),
        torch.clamp(kp_lm_final, 0, L - 1), kp_lm_final >= 0, all_rows,
    )

    # ---------------- keyframe-decision inputs ----------------------------
    counts = torch.sum(ind, dim=0).to(torch.int64)
    ref_lm = state.kf_lm_idx[ref_kf]
    ref_has2 = (ref_lm >= 0) & state.kf_kp_valid[ref_kf]
    ref_tracked = torch.sum(ref_has2 & (counts[torch.clamp(ref_lm, min=0)] >= min_obs))
    depth = feats["depth"]
    close = kp_valid & (depth > 1e-6) & (depth < camera.true_depth_threshold)
    tracked = kp_lm_final >= 0
    return TrackResult(
        R=res2.R,
        t=res2.t,
        kp_lm=kp_lm_final,
        num_tracked=torch.sum(tracked & kp_valid),
        ref_kf=ref_kf,
        lm_vis=vis_cnt > 0,
        lm_fnd=lm_fnd,
        ref_tracked=ref_tracked,
        n_close_tracked=torch.sum(close & tracked),
        n_close_untracked=torch.sum(close & ~tracked),
    )


def count_trackable_in_ref(camera, state: ms.MapState, ref_kf, min_obs, obs_indicator):
    """Landmarks of the reference keyframe observed by >= ``min_obs``
    keyframes (keyframe_inserter.cc:54-114 decision input)."""
    counts = torch.sum(obs_indicator, dim=0).to(torch.int64)
    lm = state.kf_lm_idx[ref_kf]
    ok = (lm >= 0) & state.kf_kp_valid[ref_kf]
    return torch.sum(ok & (counts[torch.clamp(lm, min=0)] >= min_obs))
