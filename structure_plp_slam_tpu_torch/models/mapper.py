"""Local mapping: keyframe insertion, landmark creation, fuse, culling, BA.

Port of structure_plp_slam_tpu/models/mapper.py (reference
mapping_module.cc:87-285: store_new_keyframe, create_new_landmarks,
update_new_keyframe/fuse, local_map_cleaner, local BA with the optional
line window; ``map_scale`` for the plane and line thresholds). Slot
counters may be Python ints or device scalars; creators compact their
valid outputs with a prefix sum into ``base_slot + cumsum`` slots and
return the number created as a tensor, so the keyframe chain runs without
a host sync.

JAX's ``.at[].set`` scatters become :func:`scatter_set` wherever indices
can repeat, which keeps the order XLA's CPU scatter leaves (last row wins).
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.camera import CameraModel
from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.models import bundle_adjustment as ba
from structure_plp_slam_tpu_torch.models import pose_graph as pg
from structure_plp_slam_tpu_torch.ops import lie, linalg, matching, triangulation
from structure_plp_slam_tpu_torch.ops import line_geometry as lg
from structure_plp_slam_tpu_torch.ops.fused_match import fused_match
from structure_plp_slam_tpu_torch.ops.hamming import popcount_u32
from structure_plp_slam_tpu_torch.utils.types import (
    HAMMING_MASKED,
    nonzero_static,
    scatter_set,
    segment_plan,
    segment_sum,
    topk_stable,
)

FUSE_RADIUS = 3.0
FUSE_MAX_HAMMING = 50


# ---------------------------------------------------------------------------
# Keyframe insertion + depth-seeded landmarks (RGB-D).
# ---------------------------------------------------------------------------


def insert_keyframe(camera, state: ms.MapState, slot, pose, timestamp, feats,
                    kp_lm, base_lm_slot):
    """Insert a keyframe; keypoints with measured depth and no landmark
    seed landmarks directly — everything under the true-depth threshold
    plus the 100 nearest (keyframe_inserter.cc:166-180).
    Returns (state, num_created)."""
    state = ms.add_keyframe(state, slot, pose, timestamp, feats, kp_lm)
    n = feats["xy"].shape[0]
    L = state.lm_pos.shape[0]
    dev = state.device
    depth = feats["depth"]
    seedable = (depth > 1e-6) & feats["valid"] & (kp_lm < 0)
    d_sort = torch.where(seedable, depth, torch.inf)
    rank = torch.empty((n,), dtype=torch.int64, device=dev)
    rank[torch.argsort(d_sort, stable=True)] = torch.arange(n, device=dev)
    depth_ok = seedable & ((depth < camera.true_depth_threshold) | (rank < 100))
    # Back-project: world = R^T (z * K^-1 uv~ - t).
    # On the CPU in XLA:CPU's arithmetic for the JAX function (linalg's
    # helpers; the plain ops on the card).
    R, t = pose[:, :3], pose[:, 3]
    x = linalg.div_const(feats["xy"][:, 0] - camera.cx, camera.fx) * depth
    y = linalg.div_const(feats["xy"][:, 1] - camera.cy, camera.fy) * depth
    pc = torch.stack([x, y, depth], dim=-1)
    pw = linalg.rows_matmul3(pc - t, R)
    slots = base_lm_slot + torch.cumsum(depth_ok.to(torch.int64), 0) - 1
    depth_ok = depth_ok & (slots < L)  # capacity gate
    dist_max = linalg.norm(pc) * torch.pow(1.2, feats["level"].to(torch.float32))
    dist_min = linalg.div_const(dist_max, 1.2**7)
    view = pw - (-linalg.vecmat(t, R))[None, :]
    view = view / torch.clamp(linalg.norm(view), min=1e-9)[:, None]
    state = ms.add_landmarks(
        state, slots, pw, feats["desc"], view, dist_min, dist_max,
        torch.full((n,), int(slot), dtype=torch.int64, device=dev), depth_ok,
    )
    state = state._replace(
        kf_lm_idx=ms.with_row(state.kf_lm_idx, slot, torch.where(depth_ok, slots, kp_lm))
    )
    return state, torch.sum(depth_ok)


# ---------------------------------------------------------------------------
# Two-view triangulation with a neighbor keyframe.
# ---------------------------------------------------------------------------


def triangulate_pair(camera, state: ms.MapState, kf1, kf2, base_lm_slot, enable=True,
                     *, scale_factor: float = 1.2):
    """Create landmarks by matching unassociated keypoints of kf1 and kf2
    along epipolar lines and triangulating (mapping_module.cc:359-601).
    ``enable`` (a device bool) turns the call into a no-op without a host
    sync. Returns (state, num_created)."""
    N = state.kf_xy.shape[1]
    L = state.lm_pos.shape[0]
    dev = state.device
    b1 = state.kf_bearing[kf1]
    b2 = state.kf_bearing[kf2]
    free1 = state.kf_kp_valid[kf1] & (state.kf_lm_idx[kf1] < 0)
    free2 = state.kf_kp_valid[kf2] & (state.kf_lm_idx[kf2] < 0)
    R1, t1 = state.kf_pose[kf1, :, :3], state.kf_pose[kf1, :, 3]
    R2, t2 = state.kf_pose[kf2, :, :3], state.kf_pose[kf2, :, 3]
    # On the CPU every product below is XLA:CPU's dot or fused sum for its
    # shapes (ops/linalg), as the JAX chain computes it.
    R_21 = linalg.matmul(R2, R1.T)
    t_21 = t2 - linalg.matvec(R_21, t1)
    E = linalg.matmul(lie.hat(t_21), R_21)

    d = matching.distance_matrix_mxu(
        matching.unpack_desc_bits(state.kf_desc[kf1]),
        matching.unpack_desc_bits(state.kf_desc[kf2]),
        free1, free2,
    )
    # Epipolar residual |b2 . E b1|^2 with both-sided normalization.
    Eb1 = linalg.einsum_fma("ij,nj->ni", E, b1)
    num = linalg.einsum_fma("mi,ni->nm", b2, Eb1)  # [N1, N2]
    d1 = torch.clamp(linalg.sq_norm(Eb1), min=1e-12)[:, None]
    Etb2 = linalg.rows_matmul3(b2, E)
    d2 = torch.clamp(linalg.sq_norm(Etb2), min=1e-12)[None, :]
    epi = num * num * (1.0 / d1 + 1.0 / d2)
    lvl_sig = torch.pow(scale_factor, state.kf_level[kf1].to(torch.float32)) ** 2
    thr = (2.0 / camera.focal_like) ** 2 * lvl_sig
    d = torch.where(epi <= thr[:, None], d, HAMMING_MASKED)

    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    best_rev = torch.argmin(d, dim=0)
    ok = (best_d <= 50) & (best_rev[best] == torch.arange(N, device=dev))

    b2m = b2[best]
    pts_w = triangulation.triangulate_two_view(b1, b2m, R1, t1, R2, t2)
    pts_c1 = linalg.einsum_fma("ij,nj->ni", R1, pts_w) + t1
    pts_c2 = linalg.einsum_fma("ij,nj->ni", R2, pts_w) + t2
    depth_ok = cam_base.cheirality(camera, pts_c1) & cam_base.cheirality(camera, pts_c2)

    def reproj_ok(pc, obs):
        uv, _ = cam_base.project(camera, pc)
        err = linalg.sq_norm(cam_base.uv_residual(camera, uv, obs))
        return err <= 5.991 * lvl_sig

    rp_ok = reproj_ok(pts_c1, state.kf_xy[kf1]) & reproj_ok(pts_c2, state.kf_xy[kf2][best])
    b1_in_2 = linalg.einsum_fma("ij,nj->ni", R_21, b1)
    parallax_ok = linalg.einsum_fma("ni,ni->n", b1_in_2, b2m) < 0.99995
    good = ok & depth_ok & rp_ok & parallax_ok & free1 & enable

    slots = base_lm_slot + torch.cumsum(good.to(torch.int64), 0) - 1
    good = good & (slots < L)  # capacity gate
    dist_max = linalg.norm(pts_c1) * torch.pow(
        scale_factor, state.kf_level[kf1].to(torch.float32)
    )
    dist_min = linalg.div_const(dist_max, scale_factor**7)
    view = pts_w - (-linalg.vecmat(t1, R1))[None, :]
    view = view / torch.clamp(linalg.norm(view), min=1e-9)[:, None]
    kf1_ids = torch.full((N,), 0, dtype=torch.int64, device=dev) + kf1
    state = ms.add_landmarks(state, slots, pts_w, state.kf_desc[kf1], view,
                             dist_min, dist_max, kf1_ids, good)
    # Register observations in both keyframes (kf1's row first, as the JAX
    # package does, so kf2 == kf1 reads the updated row).
    lm1 = torch.where(good, slots, state.kf_lm_idx[kf1])
    state = state._replace(kf_lm_idx=ms.with_row(state.kf_lm_idx, kf1, lm1))
    kf2_new = scatter_set(state.kf_lm_idx[kf2], best, slots, good)
    state = state._replace(kf_lm_idx=ms.with_row(state.kf_lm_idx, kf2, kf2_new))
    return state, torch.sum(good)


def triangulate_with_neighbors(camera, state: ms.MapState, slot, base_lm_slot, ind=None,
                               *, num_neighbors: int = 2, return_neighbors: bool = False):
    """Triangulate new landmarks with the top covisible neighbors of
    ``slot`` (covisibility top-k with a weight >= 15 gate, selected on
    device). Returns (state, num_created[, neighbors])."""
    W = ms.covisibility_matrix(state, ind)[slot].clone()
    W[slot] = 0
    W = torch.where(state.kf_valid, W, 0)
    w_top, nbs = topk_stable(W, num_neighbors)
    next_lm = base_lm_slot
    for i in range(num_neighbors):
        state, n_new = triangulate_pair(camera, state, slot, nbs[i], next_lm,
                                        enable=w_top[i] >= 15)
        next_lm = next_lm + n_new
    if return_neighbors:
        return state, next_lm - base_lm_slot, nbs
    return state, next_lm - base_lm_slot


def map_scale(state: ms.MapState, kf):
    """Median camera-frame landmark distance of keyframe ``kf`` (the lower
    middle value of an even count), the scale of the plane and line
    thresholds (estimate_map_scale, planar_mapping_module.cc:130-183);
    1.0 with fewer than 10 observations."""
    L = state.lm_pos.shape[0]
    lm = state.kf_lm_idx[kf]
    ok = (lm >= 0) & state.kf_kp_valid[kf]
    pose = state.kf_pose[kf]
    pc = state.lm_pos[torch.clamp(lm, 0, L - 1)] @ pose[:, :3].T + pose[:, 3]
    d = torch.linalg.norm(pc, dim=-1)
    cnt = torch.sum(ok)
    d_sorted = torch.sort(torch.where(ok, d, torch.full_like(d, float("inf")))).values
    med = d_sorted.gather(0, torch.clamp((cnt - 1) // 2, 0, d.shape[0] - 1).reshape(1))[0]
    return torch.where(cnt >= 10, torch.clamp(med, min=1e-3), torch.ones_like(med))


# ---------------------------------------------------------------------------
# Landmark statistics.
# ---------------------------------------------------------------------------


def _int_pow_f32(x: float, n: int) -> float:
    """``jnp.float32(x) ** n`` for an integer ``n``, as ``lax.integer_pow``
    multiplies it out in f32 (binary exponentiation), which XLA folds into
    a constant."""
    acc, x32 = None, torch.tensor(x, dtype=torch.float32)
    while n > 0:
        if n & 1:
            acc = x32 if acc is None else acc * x32
        n >>= 1
        if n:
            x32 = x32 * x32
    return float(acc if acc is not None else torch.tensor(1.0))


def _camera_centers(state):
    R = state.kf_pose[:, :, :3]
    t = state.kf_pose[:, :, 3]
    return -linalg.einsum_fma("kji,kj->ki", R, t)  # [K, 3]


def _mean_normals(state, ind):
    """Mean viewing direction over current observers (unit sum of
    X - C_k), and the observer count. On the CPU the observers' centers
    are summed in keyframe order and ``n X - sum`` is fused, as XLA:CPU
    compiles the JAX package's."""
    n_obs = torch.sum(ind, dim=0)
    sum_c = linalg.einsum_fma("kl,ki->li", ind, _camera_centers(state))
    dir_sum = linalg.fms(n_obs[:, None], state.lm_pos, sum_c)
    normal = dir_sum / torch.clamp(linalg.norm(dir_sum), min=1e-9)[:, None]
    return normal, n_obs


def update_landmark_normals(state: ms.MapState, ind=None):
    """Refresh each landmark's mean viewing direction over its current
    observers (landmark::update_normal_and_depth, landmark.h:105-110)."""
    if ind is None:
        ind = ms.observation_indicator(state)
    normal, n_obs = _mean_normals(state, ind)
    keep = (n_obs > 0) & state.lm_valid
    return state._replace(lm_normal=torch.where(keep[:, None], normal, state.lm_normal))


def refresh_landmark_stats(state: ms.MapState, ind=None, *, scale_factor: float = 1.2,
                           num_levels: int = 8, max_obs: int = 8, window_kfs=None):
    """Refresh the per-landmark statistics (data/landmark.h:99-110): mean
    viewing direction and ORB distance bounds over ALL observers, and the
    representative descriptor — the observation minimizing the median
    Hamming distance to the others, over each landmark's finest
    ``max_obs`` observations. ``window_kfs`` ([W] keyframe ids, -1 =
    padding) restricts only the descriptor refresh; it then overwrites
    only landmarks whose whole observer set lies in the window."""
    K = state.kf_lm_idx.shape[0]
    L = state.lm_pos.shape[0]
    M = max_obs
    dev = state.device
    if ind is None:
        ind = ms.observation_indicator(state)
    new_normal, n_obs = _mean_normals(state, ind)
    keep = (n_obs > 0) & state.lm_valid

    # ---- scale-invariance bounds: mean of dist * scale**level ----------
    C = _camera_centers(state)
    lvl_all = torch.clamp(state.kf_level, 0, num_levels - 1).to(torch.float32)
    obs_ok_all = (state.kf_lm_idx >= 0) & state.kf_kp_valid & state.kf_valid[:, None]
    lm_safe_all = torch.where(obs_ok_all, state.kf_lm_idx, L)
    sf32 = torch.tensor(scale_factor, dtype=torch.float32, device=dev)
    w_up = torch.where(obs_ok_all, sf32**lvl_all, 0.0)
    bins = (torch.arange(K, device=dev)[:, None] * (L + 1) + lm_safe_all).reshape(-1)
    ind_up = segment_sum(bins, w_up.reshape(-1), K * (L + 1),
                         plan=segment_plan(bins, K * (L + 1), keep=obs_ok_all.reshape(-1)))
    ind_up = ind_up.reshape(K, L + 1)[:, :L]
    # |X - C|^2 = |X|^2 - 2 C.X + |C|^2 (XLA fuses the first sum, which is
    # exact here: 2 C.X is).
    cross = linalg.einsum_fma("ki,li->kl", C, state.lm_pos)
    d2 = (linalg.sq_norm(state.lm_pos)[None, :] - 2.0 * cross) + linalg.sq_norm(C)[:, None]
    dist_kl = linalg.sqrt(torch.clamp(d2, min=0.0))
    dist_max = linalg.gemv_sum(ind_up, dist_kl) / torch.clamp(n_obs, min=1.0)
    dist_min = linalg.div_const(dist_max, _int_pow_f32(scale_factor, num_levels - 1))

    # ---- flat observation list (descriptor refresh) ---------------------
    if window_kfs is None:
        kf_ids = torch.arange(K, device=dev)
        row_ok = state.kf_valid
    else:
        kf_ids = torch.clamp(window_kfs, 0, K - 1)
        row_ok = (window_kfs >= 0) & state.kf_valid[kf_ids]
    lm_idx_w = state.kf_lm_idx[kf_ids]
    obs_ok = ((lm_idx_w >= 0) & state.kf_kp_valid[kf_ids] & row_ok[:, None]).reshape(-1)
    lvl = torch.clamp(state.kf_level[kf_ids].reshape(-1), 0, num_levels - 1)
    lm_safe = torch.where(obs_ok, lm_idx_w.reshape(-1), L)
    # Sort by (landmark, level): finest observations first per landmark.
    order = torch.argsort(lm_safe * num_levels + lvl, stable=True)
    lm_s = lm_safe[order].contiguous()
    O = lm_s.shape[0]
    starts = torch.searchsorted(lm_s, torch.arange(L + 1, device=dev))
    counts_seg = starts[1:] - starts[:-1]
    flat_desc = state.kf_desc[kf_ids].reshape(-1, 8)[order]
    slot_r = torch.arange(M, device=dev)[None]
    slot_ok = slot_r < counts_seg[:, None]                      # [L, M]
    slot_desc = flat_desc[torch.clamp(starts[:L, None] + slot_r, 0, O - 1)]
    slot_desc = torch.where(slot_ok[:, :, None], slot_desc, 0)  # [L, M, 8]

    # ---- representative descriptor: median-Hamming argmin ---------------
    x = torch.bitwise_xor(slot_desc[:, :, None, :], slot_desc[:, None, :, :])
    d = torch.sum(popcount_u32(x), dim=-1).to(torch.float32)   # [L, M, M]
    pair_ok = slot_ok[:, :, None] & slot_ok[:, None, :]
    eye = torch.eye(M, dtype=torch.bool, device=dev)[None]
    d = torch.where(pair_ok & ~eye, d, 1e9)
    d_sorted = torch.sort(d, dim=-1).values
    cnt = torch.sum(slot_ok, dim=-1)
    med_idx = torch.clamp((cnt - 2) // 2, 0, M - 1)
    med = torch.gather(d_sorted, 2, med_idx[:, None, None].expand(L, M, 1))[..., 0]
    med = torch.where(slot_ok, med, 1e12)
    best_row = torch.argmin(med, dim=-1)
    best_desc = slot_desc[torch.arange(L, device=dev), best_row]
    desc_keep = (cnt >= 2) & state.lm_valid
    if window_kfs is not None:
        desc_keep = desc_keep & (counts_seg.to(torch.float32) >= n_obs)
    bound_keep = (n_obs > 0) & state.lm_valid
    return state._replace(
        lm_normal=torch.where(keep[:, None], new_normal, state.lm_normal),
        lm_desc=torch.where(desc_keep[:, None], best_desc, state.lm_desc),
        lm_dist_max=torch.where(bound_keep, dist_max, state.lm_dist_max),
        lm_dist_min=torch.where(bound_keep, dist_min, state.lm_dist_min),
    )


# ---------------------------------------------------------------------------
# Duplicate landmark fusion.
# ---------------------------------------------------------------------------


def fuse_into_keyframe(camera, state: ms.MapState, kf, lm_cand_mask, ind=None):
    """Project candidate landmarks into keyframe ``kf`` through the fused
    matcher (3 px window, no level gate, Hamming <= 50); a match on a free
    keypoint adds the observation, a match on a keypoint holding another
    landmark merges the pair into the more-observed one (fuse.cc:168,
    mapping_module.cc:603-801). The equirectangular model matches through
    the masked distance matrix with the u window wrapped, as the JAX
    package does (mapper.py:504-548). Returns (state, num_fused)."""
    L = state.lm_pos.shape[0]
    N = state.kf_xy.shape[1]
    dev = state.device
    R, t = state.kf_pose[kf, :, :3], state.kf_pose[kf, :, 3]
    pc = state.lm_pos @ R.T + t
    uv, _ = cam_base.project(camera, pc)
    vis = (
        lm_cand_mask & state.lm_valid
        & cam_base.cheirality(camera, pc) & cam_base.in_image(camera, uv)
    )
    row = state.kf_lm_idx[kf]
    every = torch.ones_like(row, dtype=torch.bool)
    obs_here = scatter_set(
        torch.zeros((L,), dtype=torch.bool, device=dev),
        torch.clamp(row, 0, L - 1), row >= 0, every,
    )
    vis = vis & ~obs_here

    if camera.model is CameraModel.EQUIRECTANGULAR:
        kp_best, _ = matching.match_by_projection(
            uv, torch.zeros((L,), dtype=torch.int64, device=dev),
            matching.unpack_desc_bits(state.lm_desc), vis, state.kf_xy[kf], state.kf_level[kf],
            matching.unpack_desc_bits(state.kf_desc[kf]), state.kf_kp_valid[kf],
            radius_by_level=torch.full((8,), FUSE_RADIUS, device=dev),
            max_hamming=FUSE_MAX_HAMMING, level_window=8, wrap_cols=float(camera.cols))
        matched = kp_best >= 0
    else:
        # No level gate (the JAX CPU path's level_window=8 of 8 levels):
        # every landmark and valid keypoint sits at level 0, invalid
        # keypoints at 1e9.
        kp_meta = torch.stack(
            [state.kf_xy[kf, :, 0], state.kf_xy[kf, :, 1],
             torch.where(state.kf_kp_valid[kf], 0.0, 1e9)],
            dim=-1,
        ).contiguous()
        lm_meta = torch.stack(
            [uv[:, 0], uv[:, 1], torch.where(vis, FUSE_RADIUS, -1.0), torch.zeros_like(uv[:, 0])],
            dim=-1,
        ).contiguous()
        bd, _sd, kb = fused_match(state.lm_desc, lm_meta, state.kf_desc[kf].contiguous(),
                                  kp_meta)
        matched = bd <= FUSE_MAX_HAMMING
        kp_best = torch.where(matched, kb.to(torch.int64), -1)
    safe_kp = torch.where(matched, kp_best, N)
    existing = torch.cat([row, row.new_full((1,), -1)])[safe_kp]
    counts = ms.landmark_observation_counts(state, ind)
    lm_ids = torch.arange(L, device=dev)

    # Case A: keypoint free -> register the observation.
    free_kp = matched & (existing < 0)
    state = state._replace(
        kf_lm_idx=ms.with_row(state.kf_lm_idx, kf, scatter_set(row, safe_kp, lm_ids, free_kp))
    )
    # Case B: keypoint holds another landmark -> the one with fewer
    # observations is replaced by the other everywhere.
    dup = matched & (existing >= 0) & (existing != lm_ids)
    keep_other = counts[torch.clamp(existing, 0, L - 1)] >= counts
    src = torch.where(keep_other, lm_ids, existing)  # dies
    dst = torch.where(keep_other, existing, lm_ids)  # lives
    table = scatter_set(torch.arange(L + 1, device=dev), src, dst, dup)
    kf_lm = state.kf_lm_idx
    new_idx = torch.where(kf_lm >= 0, table[torch.clamp(kf_lm, 0, L)], kf_lm)
    dead = torch.zeros((L,), dtype=torch.bool, device=dev)
    dead[src[dup]] = True
    state = state._replace(kf_lm_idx=new_idx, lm_valid=state.lm_valid & ~dead)
    return state, torch.sum(free_kp) + torch.sum(dup)


# ---------------------------------------------------------------------------
# Culling (local_map_cleaner semantics as mask updates).
# ---------------------------------------------------------------------------


def cull_landmarks(state: ms.MapState, current_kf, recent_window: int = 2, ind=None):
    """Remove unreliable recent landmarks: found/visible ratio < 0.3, or
    created >= ``recent_window`` keyframes ago and observed by <= 2
    keyframes (local_map_cleaner.cc:51; plane-owned landmarks exempt)."""
    counts = ms.landmark_observation_counts(state, ind)
    ratio = state.lm_n_fnd.to(torch.float32) / torch.clamp(
        state.lm_n_vis.to(torch.float32), min=1.0
    )
    age = current_kf - state.lm_ref_kf
    bad = state.lm_valid & ((ratio < 0.3) | ((age >= recent_window) & (counts <= 2)))
    bad = bad & (state.lm_plane < 0)
    return ms.remove_landmarks(state, bad), torch.sum(bad)


def cull_keyframes(state: ms.MapState, protect_kf, ind=None):
    """Remove redundant keyframes: >= 90% of their landmarks observed by
    >= 3 other keyframes (local_map_cleaner.cc:201)."""
    counts = ms.landmark_observation_counts(state, ind)
    lm = state.kf_lm_idx
    has = (lm >= 0) & state.kf_kp_valid
    redundant = has & (counts[torch.clamp(lm, min=0)] >= 4)  # >= 3 others + itself
    n_obs = torch.sum(has, dim=1)
    frac = torch.sum(redundant, dim=1).to(torch.float32) / torch.clamp(
        n_obs.to(torch.float32), min=1.0
    )
    bad = state.kf_valid & (frac >= 0.9) & (n_obs > 0)
    bad[0] = False  # origin keyframe is permanent (bad is a fresh tensor)
    bad[protect_kf] = False
    return ms.remove_keyframes(state, bad), torch.sum(bad)


# ---------------------------------------------------------------------------
# Local BA window extraction + solve + write-back.
# ---------------------------------------------------------------------------


def _line_window(state, cams, cam_ok, inv_sigma_sq_table, max_lines):
    """The window's lines (the first ``max_lines`` valid lines the window
    cameras observe) and their observations, as a ``ba.LineWindow``, and
    the lines' global slots."""
    L2 = state.ln_pluck.shape[0]
    C, MLs = cams.shape[0], state.kf_line_idx.shape[1]
    dev = state.device
    ln_g = state.kf_line_idx[cams]                                     # [C, MLs]
    ln_obs_ok = (ln_g >= 0) & state.kf_seg_valid[cams] & cam_ok[:, None]
    lmask = torch.zeros((L2 + 1,), dtype=torch.bool, device=dev)
    lmask[torch.where(ln_obs_ok, ln_g, L2)] = True
    lmask = lmask[:L2] & state.ln_valid
    l_idx = nonzero_static(lmask, max_lines, -1)
    l_ok = l_idx >= 0
    l_safe = torch.clamp(l_idx, 0, L2 - 1)
    g2l = scatter_set(torch.full((L2 + 1,), -1, dtype=torch.int64, device=dev), l_safe,
                      torch.arange(max_lines, device=dev), l_ok)
    lobs_line = g2l[torch.clamp(ln_g, 0, L2)]
    lobs_ok = (ln_obs_ok & (lobs_line >= 0)).reshape(-1)
    lobs_line = torch.clamp(lobs_line, 0, max_lines - 1).reshape(-1)
    counts = torch.zeros((max_lines,), dtype=torch.int64, device=dev).index_add_(
        0, lobs_line, lobs_ok.to(torch.int64))
    U0, w0 = lg.plucker_to_orthonormal(state.ln_pluck[l_safe])
    lw = ba.LineWindow(
        ln_U=U0, ln_w=w0, ln_valid=l_ok & (counts >= 2),
        lobs_cam=torch.arange(C, device=dev)[:, None].expand(C, MLs).reshape(-1),
        lobs_line=lobs_line,
        lobs_seg=state.kf_seg[cams].reshape(-1, 4),
        # Segments carry level-0 information (the detector's coarse pass
        # maps back to level-0 pixels): the level-0 weight.
        lobs_inv_sigma_sq=inv_sigma_sq_table[0].expand(C * MLs),
        lobs_valid=lobs_ok,
    )
    return lw, l_safe


def _write_back_lines(state, result, lw, l_safe):
    """Write the window's jointly optimized lines back (|d| = 1, stored
    endpoints projected onto the moved line), gated like
    ``line_ba.refine_lines``. Returns (state, [L2] mask of the lines
    written)."""
    L2 = state.ln_pluck.shape[0]
    pluck = lg.orthonormal_to_plucker(result.ln_U, result.ln_w)
    pluck = pluck / torch.clamp(torch.linalg.norm(pluck[:, 3:], dim=-1, keepdim=True), min=1e-12)
    eps_old = state.ln_endpoints[l_safe]
    e1 = lg.closest_point_on_line(pluck, eps_old[:, :3])
    e2 = lg.closest_point_on_line(pluck, eps_old[:, 3:])
    span = torch.linalg.norm(eps_old[:, 3:] - eps_old[:, :3], dim=-1)
    move = torch.maximum(torch.linalg.norm(e1 - eps_old[:, :3], dim=-1),
                         torch.linalg.norm(e2 - eps_old[:, 3:], dim=-1))
    upd = lw.ln_valid & torch.isfinite(pluck).all(-1) & (move <= span + 0.2)
    state = state._replace(
        ln_pluck=scatter_set(state.ln_pluck, l_safe, pluck, upd),
        ln_endpoints=scatter_set(state.ln_endpoints, l_safe, torch.cat([e1, e2], dim=-1), upd),
    )
    updated = scatter_set(torch.zeros((L2,), dtype=torch.bool, device=state.device), l_safe,
                          upd, upd)
    return state, updated


def local_ba(camera, state: ms.MapState, current_kf, inv_sigma_sq_table, *,
             max_opt: int = 16, max_fix: int = 16, max_lms: int = 4096,
             with_lines: bool = False, max_lines: int = 128, ind=None,
             return_cams: bool = False, _xla: str = None):
    """Local bundle adjustment around ``current_kf``
    (local_bundle_adjuster.cc:73-135): optimized cameras = the top
    ``max_opt`` covisibles, landmarks = those they observe (first
    ``max_lms``), fixed cameras = other observers (first ``max_fix``).
    ``with_lines``: the joint point + line window
    (local_bundle_adjuster_extended_line.cc:69-) over the first
    ``max_lines`` lines the window observes. ``_xla``: the System's call
    site, ``"init"`` or ``"chain"`` (``ba_solve``'s XLA:CPU iteration).
    Returns (state, chi2[, window cameras with -1 padding])."""
    K = state.kf_pose.shape[0]
    L = state.lm_pos.shape[0]
    N = state.kf_xy.shape[1]
    dev = state.device
    max_opt = min(max_opt, K)
    max_fix = min(max_fix, K)
    max_lms = min(max_lms, L)
    if ind is None:
        ind = ms.observation_indicator(state)
    W_cur = torch.where(state.kf_valid, ind @ ind[current_kf], -1.0)
    W_cur[current_kf] = 1e9  # current always first (W_cur is a fresh tensor)
    _, opt_kfs = topk_stable(W_cur, max_opt)
    opt_ok = W_cur[opt_kfs] >= 15.0
    opt_ok[0] = True
    opt_mask = torch.zeros((K,), dtype=torch.bool, device=dev)
    opt_mask[opt_kfs] = opt_ok  # top-k ids are distinct
    lm_mask = ms.local_landmark_mask(state, opt_mask, ind)
    lm_idx = nonzero_static(lm_mask, max_lms, -1)
    lm_ok = lm_idx >= 0
    lm_safe = torch.clamp(lm_idx, 0, L - 1)

    sees_local = (ind @ lm_mask.to(torch.float32)) > 0
    fix_idx = nonzero_static(sees_local & state.kf_valid & ~opt_mask, max_fix, -1)
    fix_ok = fix_idx >= 0
    cams = torch.cat([opt_kfs, torch.clamp(fix_idx, 0, K - 1)])
    cam_ok = torch.cat([opt_ok, fix_ok])
    cam_fixed = torch.cat([
        torch.zeros((max_opt,), dtype=torch.bool, device=dev),
        torch.ones((max_fix,), dtype=torch.bool, device=dev),
    ]) | (cams == 0)

    g2l = scatter_set(torch.full((L + 1,), -1, dtype=torch.int64, device=dev),
                      lm_safe, torch.arange(max_lms, device=dev), lm_ok)
    C = max_opt + max_fix
    obs_lm_g = state.kf_lm_idx[cams]  # [C, N]
    obs_lm_l = g2l[torch.clamp(obs_lm_g, 0, L)]
    obs_valid = (
        (obs_lm_g >= 0) & (obs_lm_l >= 0) & state.kf_kp_valid[cams] & cam_ok[:, None]
    )
    # Compact each camera row to ``obs_cap`` slots; the stable sort keeps
    # pyramid-level order, so any overflow drops the coarsest observations.
    obs_cap = min(640, N)
    ord_ = torch.argsort((~obs_valid).to(torch.uint8), dim=1, stable=True)[:, :obs_cap]

    def take(a):
        return torch.gather(a, 1, ord_)

    obs_valid_c = take(obs_valid)
    obs_lm_l_c = take(obs_lm_l)
    obs_lm_g_c = take(obs_lm_g)
    obs_uv_c = torch.gather(state.kf_xy[cams], 1, ord_[:, :, None].expand(C, obs_cap, 2))
    lvl_c = take(state.kf_level[cams])
    info = inv_sigma_sq_table[torch.clamp(lvl_c, 0, inv_sigma_sq_table.shape[0] - 1)]
    prob = ba.BAProblem(
        cam_pose=state.kf_pose[cams],
        cam_fixed=cam_fixed,
        cam_valid=cam_ok,
        lm_pos=state.lm_pos[lm_safe],
        lm_valid=lm_ok,
        obs_cam=torch.arange(C, device=dev)[:, None].expand(C, obs_cap).reshape(-1),
        obs_lm=torch.clamp(obs_lm_l_c, 0, max_lms - 1).reshape(-1),
        obs_uv=obs_uv_c.reshape(-1, 2),
        obs_xr=take(state.kf_xr[cams]).reshape(-1),
        obs_inv_sigma_sq=info.reshape(-1),
        obs_valid=obs_valid_c.reshape(-1),
    )
    lw = l_safe = None
    if with_lines:
        lw, l_safe = _line_window(state, cams, cam_ok, inv_sigma_sq_table, max_lines)
    # 8 damped-GN iterations with the outlier cull after 4.
    result = ba.ba_solve(camera, prob, lw, obs_grid=True, num_iters=8, cull_at_iters=(4,),
                         _xla=_xla)

    write_cam = (~cam_fixed) & cam_ok
    old_pose = state.kf_pose
    new_pose = scatter_set(old_pose, cams, result.cam_pose, write_cam)
    new_lm = scatter_set(state.lm_pos, lm_safe, result.lm_pos, lm_ok)
    # Detach BA outliers (scatter back through the compaction order; every
    # other slot rewrites its own value, and a repeated camera row's last
    # write wins, as in the JAX package).
    bad_obs = obs_valid_c & ~result.obs_inlier.reshape(C, obs_cap)
    flat_idx = (cams[:, None] * N + ord_).reshape(-1)
    kf_lm = scatter_set(
        state.kf_lm_idx.reshape(-1), flat_idx,
        torch.where(bad_obs, -1, obs_lm_g_c).reshape(-1),
        torch.ones_like(flat_idx, dtype=torch.bool),
    ).reshape(K, N)
    state = state._replace(kf_pose=new_pose, lm_pos=new_lm, kf_lm_idx=kf_lm)
    ln_updated = torch.zeros_like(state.ln_valid)
    if with_lines:
        state, ln_updated = _write_back_lines(state, result, lw, l_safe)

    # Planes and the lines outside the window ride their reference
    # keyframe's pose delta (window lines are BA variables, like points).
    ones = torch.ones((K,), dtype=torch.float32, device=dev)
    state = pg.correct_map_structures(
        state, old_pose[:, :, :3], old_pose[:, :, 3], ones,
        new_pose[:, :, :3], new_pose[:, :, 3], ones,
        lm_mask=torch.zeros_like(state.lm_valid), ln_mask=state.ln_valid & ~ln_updated,
    )
    if return_cams:
        cams_out = torch.cat([torch.where(opt_ok, opt_kfs, -1),
                              torch.where(fix_ok, fix_idx, -1)])
        return state, result.chi2, cams_out
    return state, result.chi2
