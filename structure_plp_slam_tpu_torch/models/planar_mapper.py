"""Plane landmarks driven by instance-segmentation masks.

Port of structure_plp_slam_tpu/models/planar_mapper.py (reference
Planar_Mapping_module, planar_mapping_module.{h,cc}): the instance mask
(pixel value = instance id) buckets the keyframe's landmarks per
instance, each bucket is plane-fitted by RANSAC + SVD (all buckets at
once), and planes then go through merge, refine and point-snap
maintenance after each keyframe.
"""

from __future__ import annotations

import dataclasses

import torch

from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.ops import plane_fit
from structure_plp_slam_tpu_torch.utils import prng
from structure_plp_slam_tpu_torch.utils.types import scatter_set, topk_stable

MAX_INSTANCES = 8
MIN_INLIERS = 20          # min landmarks per plane candidate
INLIER_RATIO = 0.7        # planar_mapping_parameters.yaml's ratio
MAX_ID = 64               # instance ids bucketed by keypoint support


@dataclasses.dataclass(frozen=True)
class PlanarParams:
    """Planar-mapping thresholds, loadable from the reference's
    ``planar_mapping_parameters.yaml`` keys (load_configuration,
    planar_mapping_module.cc:1158-1184); any ``Threshold.*`` key present
    overrides the default."""

    max_instances: int = MAX_INSTANCES
    min_points: int = MIN_INLIERS
    inliers_ratio_thr: float = INLIER_RATIO
    plane_distance: float = 0.02
    dot_product_threshold: float = 0.985
    offset_delta_factor: float = 2.5
    snap_distance_factor: float = 3.0
    use_graph_cut: bool = True
    check_3x3_window: bool = True

    @staticmethod
    def from_raw(raw: dict) -> "PlanarParams":
        d = PlanarParams()
        g = raw.get
        return PlanarParams(
            max_instances=int(g("Threshold.max_instances", d.max_instances)),
            min_points=int(g("Threshold.min_number_points_before_ransac", d.min_points)),
            inliers_ratio_thr=float(g("Threshold.inliers_ratio_thr", d.inliers_ratio_thr)),
            plane_distance=float(g("Threshold.plane_distance_correction", d.plane_distance)),
            dot_product_threshold=float(g("Threshold.dot_product_threshold",
                                          d.dot_product_threshold)),
            offset_delta_factor=float(g("Threshold.offset_delta_factor",
                                        d.offset_delta_factor)),
            snap_distance_factor=float(g("Threshold.snap_distance_factor",
                                         d.snap_distance_factor)),
            use_graph_cut=bool(g("Threshold.use_graph_cut", d.use_graph_cut)),
            check_3x3_window=bool(g("Threshold.check_3x3_window", d.check_3x3_window)),
        )


def label_keypoints(seg_mask, kp_xy, kp_valid, check_3x3: bool = True):
    """Per-keypoint instance label; with ``check_3x3`` a keypoint counts
    only if its 3x3 neighbourhood is one instance (create_ColorToPlane,
    planar_mapping_module.cc:185-345). ``seg_mask``: i64 [H, W], 0 =
    background. Returns labels [N] (0 = none)."""
    H, W = seg_mask.shape
    xs = torch.clamp(kp_xy[:, 0].to(torch.int64), 1, W - 2)
    ys = torch.clamp(kp_xy[:, 1].to(torch.int64), 1, H - 2)
    center = seg_mask[ys, xs]
    consistent = torch.ones_like(center, dtype=torch.bool)
    if check_3x3:
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                consistent = consistent & (seg_mask[ys + dy, xs + dx] == center)
    return torch.where(kp_valid & consistent & (center > 0), center, torch.zeros_like(center))


def detect_planes(state: ms.MapState, kf, labels, base_plane_slot, key, scale, *,
                  max_instances: int = MAX_INSTANCES, coherent: bool = False,
                  params: PlanarParams = PlanarParams(), thr_mult: float = 1.0,
                  ratio_override: float = None):
    """Fit a plane per mask instance from keyframe ``kf``'s landmarks.

    ``labels``: [N] per-keypoint instance ids (:func:`label_keypoints`).
    ``scale``: the map scale; the RANSAC threshold is
    ``plane_distance * scale * thr_mult``. ``coherent`` selects the
    spatially coherent consensus (the reference's use_graph_cut).
    ``thr_mult`` / ``ratio_override`` relax the gates for two-view
    monocular clouds (``System._init_structures``); planes accepted so are
    flagged ``pl_needs_refresh``. Returns (state, num_created)."""
    L = state.lm_pos.shape[0]
    P = state.pl_coef.shape[0]
    dev = state.device
    lm = state.kf_lm_idx[kf]
    has_lm = (lm >= 0) & state.kf_kp_valid[kf]
    lm_safe = torch.clamp(lm, 0, L - 1)
    pts = state.lm_pos[lm_safe]
    unowned = state.lm_plane[lm_safe] < 0  # owned landmarks are not re-bucketed
    thr = params.plane_distance * scale * thr_mult

    # Arbitrary instance ids map to the top ``max_instances`` buckets by
    # keypoint support.
    cand = has_lm & unowned & (labels > 0)
    lbl = torch.clamp(labels, 0, MAX_ID - 1)
    id_counts = torch.zeros((MAX_ID,), dtype=torch.int64, device=dev)
    id_counts.index_add_(0, torch.where(cand, lbl, 0), torch.ones_like(lbl))
    id_counts[0] = 0
    _, top_ids = topk_stable(id_counts, max_instances)                    # [I]
    keys = prng.split(key, max_instances).to(dev)  # one copy to the card, not one per draw
    sel = cand[None] & (lbl[None] == top_ids[:, None]) & (top_ids[:, None] > 0)  # [I, N]
    if coherent:
        # One k-NN graph over the shared candidate points, per-instance
        # validity applied to its edges.
        graph = plane_fit.knn_graph(pts, has_lm & unowned)
        coefs, inls, n_inl = plane_fit.plane_ransac_coherent(pts, sel, keys, graph,
                                                             inlier_thr=thr)
    else:
        coefs, inls, n_inl = plane_fit.plane_ransac(pts, sel, keys, inlier_thr=thr)
    inls = inls & sel
    ratio = params.inliers_ratio_thr if ratio_override is None else ratio_override
    n_cand = torch.sum(sel, dim=-1)
    goods = (n_inl >= params.min_points) & (n_inl >= ratio * torch.clamp(n_cand, min=1))

    slots = base_plane_slot + torch.cumsum(goods.to(torch.int64), 0) - 1
    goods = goods & (slots < P)  # capacity gate
    state = state._replace(
        pl_coef=scatter_set(state.pl_coef, slots, coefs, goods),
        pl_valid=scatter_set(state.pl_valid, slots, goods, goods),
        # Relaxed-gate (mono init) planes demand a multi-view re-fit.
        pl_needs_refresh=scatter_set(state.pl_needs_refresh, slots,
                                     torch.full_like(goods, thr_mult > 1.0), goods),
        pl_ref_kf=scatter_set(state.pl_ref_kf, slots, torch.full_like(slots, int(kf)), goods),
    )
    # Landmark ownership (landmark.h:139-141, the owning-plane link).
    own = goods[:, None] & inls
    plane_of_kp = torch.amax(torch.where(own, slots[:, None], -1), dim=0)  # [N]
    write = (plane_of_kp >= 0) & has_lm
    state = state._replace(lm_plane=scatter_set(state.lm_plane, lm_safe, plane_of_kp, write))
    return state, torch.sum(goods)


def merge_planes(state: ms.MapState, scale, params: PlanarParams = PlanarParams()):
    """Merge coplanar pairs (parallel normals and a small offset
    difference, planar_mapping_module.cc:773-1004): the lower id absorbs
    the other. Returns (state, num_merged)."""
    P = state.pl_coef.shape[0]
    dev = state.device
    n = state.pl_coef[:, :3]
    d = state.pl_coef[:, 3]
    cos = torch.abs(n @ n.T)
    d_diff = torch.abs(torch.abs(d)[:, None] - torch.abs(d)[None, :])
    ids = torch.arange(P, device=dev)
    mergeable = (state.pl_valid[:, None] & state.pl_valid[None, :]
                 & (cos > params.dot_product_threshold)
                 & (d_diff < params.offset_delta_factor * params.plane_distance * scale)
                 & (ids[:, None] < ids[None, :]))
    # For each plane j, the smallest i it merges into (or itself); one step
    # of path compression covers pairwise chains.
    tgt = torch.amin(torch.where(mergeable, ids[:, None], P), dim=0)
    tgt = torch.where(tgt < P, tgt, ids)
    tgt = tgt[tgt]
    dies = tgt != ids
    owned = state.lm_plane >= 0
    new_owner = tgt[torch.clamp(state.lm_plane, 0, P - 1)]
    refresh = scatter_set(torch.zeros((P,), dtype=torch.bool, device=dev), tgt, dies,
                          torch.ones_like(dies))
    state = state._replace(
        lm_plane=torch.where(owned, new_owner, state.lm_plane),
        pl_valid=state.pl_valid & ~dies,
        pl_needs_refresh=state.pl_needs_refresh | refresh,
    )
    return state, torch.sum(dies)


def refine_planes(state: ms.MapState, scale, params: PlanarParams = PlanarParams()):
    """Refit every valid plane from its owned landmarks (all planes in one
    batched fit) and drop the planes that lost support."""
    P = state.pl_coef.shape[0]
    ids = torch.arange(P, device=state.device)
    w = ((state.lm_plane[None, :] == ids[:, None]) & state.lm_valid[None, :]).to(torch.float32)
    n, d = plane_fit.fit_plane_svd(state.lm_pos, w)
    counts = torch.sum(w, dim=-1)
    keep = state.pl_valid & (counts >= params.min_points * 0.5)
    state = state._replace(
        pl_coef=torch.where(keep[:, None], torch.cat([n, d[:, None]], dim=-1), state.pl_coef),
        pl_valid=keep,
        pl_needs_refresh=torch.zeros_like(state.pl_needs_refresh),
    )
    # Landmarks of dropped planes become orphans.
    owner_ok = keep[torch.clamp(state.lm_plane, 0, P - 1)]
    return state._replace(lm_plane=torch.where((state.lm_plane >= 0) & ~owner_ok, -1,
                                               state.lm_plane))


def snap_points_to_planes(state: ms.MapState, scale, params: PlanarParams = PlanarParams()):
    """Project owned landmarks onto their plane (refine_points_with_plane);
    owned points farther than the snap gate keep their place and lose
    their ownership."""
    P = state.pl_coef.shape[0]
    owned = (state.lm_plane >= 0) & state.lm_valid
    coef = state.pl_coef[torch.clamp(state.lm_plane, 0, P - 1)]
    dist = torch.einsum("li,li->l", coef[:, :3], state.lm_pos) + coef[:, 3]
    near = torch.abs(dist) <= params.snap_distance_factor * params.plane_distance * scale
    snapped = state.lm_pos - dist[:, None] * coef[:, :3]
    return state._replace(
        lm_pos=torch.where((owned & near)[:, None], snapped, state.lm_pos),
        lm_plane=torch.where(owned & ~near, -1, state.lm_plane),
    )
