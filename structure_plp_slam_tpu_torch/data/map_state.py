"""Device-resident SoA map state.

Port of structure_plp_slam_tpu/data/map_state.py: the whole map lives in
fixed-capacity tensors; allocation writes a slot and sets its valid bit,
deletion clears the bit. ``kf_lm_idx[k, i]`` (the landmark observed by
keypoint i of keyframe k, or -1) is the covisibility structure: counts
between keyframes are one indicator matmul away.

Dtypes: float32 geometry, bool masks, int64 ids and levels (torch's index
type), int32 descriptors holding the u32 bit patterns.

Writers are functional like the JAX package's (``.at[].set``): each
returns a new MapState whose touched fields are fresh tensors, so a state
handed to several callers (the tests do) is never changed under them.
:func:`from_numpy` / :func:`to_numpy` carry a state across from / to the
JAX package's field arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LINE_DESC_DIM = 128  # line band descriptor width (JAX ops/lines.DESC_DIM)

_DESC_FIELDS = ("kf_desc", "lm_desc")


class MapState(NamedTuple):
    """All map tensors. K = max keyframes, N = keypoint slots per keyframe,
    L = max landmarks."""

    # --- keyframes -------------------------------------------------------
    kf_pose: torch.Tensor       # [K, 3, 4] f32 world->cam (R|t)
    kf_valid: torch.Tensor      # [K] bool
    kf_timestamp: torch.Tensor  # [K] f32
    kf_xy: torch.Tensor         # [K, N, 2] f32 undistorted level-0 coords
    kf_xr: torch.Tensor         # [K, N] f32 right-image x (< 0: mono)
    kf_depth: torch.Tensor      # [K, N] f32 measured depth (<= 0: none)
    kf_level: torch.Tensor      # [K, N] i64 pyramid level
    kf_angle: torch.Tensor      # [K, N] f32 keypoint orientation
    kf_desc: torch.Tensor       # [K, N, 8] i32 packed ORB (u32 bits)
    kf_bearing: torch.Tensor    # [K, N, 3] f32 unit rays
    kf_kp_valid: torch.Tensor   # [K, N] bool
    kf_lm_idx: torch.Tensor     # [K, N] i64 landmark id per keypoint (-1 none)
    # --- landmarks (points) ---------------------------------------------
    lm_pos: torch.Tensor        # [L, 3] f32
    lm_valid: torch.Tensor      # [L] bool
    lm_desc: torch.Tensor       # [L, 8] i32 representative descriptor
    lm_normal: torch.Tensor     # [L, 3] f32 mean viewing direction
    lm_dist_min: torch.Tensor   # [L] f32 ORB scale-invariance bounds
    lm_dist_max: torch.Tensor   # [L] f32
    lm_ref_kf: torch.Tensor     # [L] i64 reference keyframe
    lm_n_vis: torch.Tensor      # [L] i64 num_observable
    lm_n_fnd: torch.Tensor      # [L] i64 num_observed
    lm_plane: torch.Tensor      # [L] i64 owning plane id (-1)
    # --- line landmarks + per-keyframe segment observations -------------
    kf_seg: torch.Tensor        # [K, ML, 4] f32
    kf_seg_depth: torch.Tensor  # [K, ML, 2] f32
    kf_seg_desc: torch.Tensor   # [K, ML, LD] f32
    kf_seg_valid: torch.Tensor  # [K, ML] bool
    kf_line_idx: torch.Tensor   # [K, ML] i64
    ln_pluck: torch.Tensor      # [L2, 6] f32 Plücker [m, d]
    ln_endpoints: torch.Tensor  # [L2, 6] f32
    ln_desc: torch.Tensor       # [L2, LD] f32
    ln_valid: torch.Tensor      # [L2] bool
    ln_ref_kf: torch.Tensor     # [L2] i64
    ln_n_vis: torch.Tensor      # [L2] i64
    ln_n_fnd: torch.Tensor      # [L2] i64
    # --- plane landmarks --------------------------------------------------
    pl_coef: torch.Tensor       # [P, 4] f32 (n, d)
    pl_valid: torch.Tensor      # [P] bool
    pl_needs_refresh: torch.Tensor  # [P] bool
    pl_ref_kf: torch.Tensor     # [P] i64

    @property
    def max_keyframes(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def max_kps(self) -> int:
        return self.kf_xy.shape[1]

    @property
    def max_landmarks(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kf_pose.device


def create(max_keyframes: int = 256, max_kps: int = 1024, max_landmarks: int = 16384,
           max_lines_per_kf: int = 64, max_line_landmarks: int = 2048,
           line_desc_dim: int | None = None, max_planes: int = 64, *, device):
    K, N, L = max_keyframes, max_kps, max_landmarks
    if line_desc_dim is None:
        line_desc_dim = LINE_DESC_DIM
    ML, L2, LD, P = max_lines_per_kf, max_line_landmarks, line_desc_dim, max_planes
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    b = dict(dtype=torch.bool, device=device)
    pose0 = torch.zeros((K, 3, 4), **f32)
    pose0[:, :, :3] = torch.eye(3, **f32)
    return MapState(
        kf_pose=pose0,
        kf_valid=torch.zeros((K,), **b),
        kf_timestamp=torch.zeros((K,), **f32),
        kf_xy=torch.zeros((K, N, 2), **f32),
        kf_xr=torch.full((K, N), -1.0, **f32),
        kf_depth=torch.zeros((K, N), **f32),
        kf_level=torch.zeros((K, N), **i64),
        kf_angle=torch.zeros((K, N), **f32),
        kf_desc=torch.zeros((K, N, 8), dtype=torch.int32, device=device),
        kf_bearing=torch.zeros((K, N, 3), **f32),
        kf_kp_valid=torch.zeros((K, N), **b),
        kf_lm_idx=torch.full((K, N), -1, **i64),
        lm_pos=torch.zeros((L, 3), **f32),
        lm_valid=torch.zeros((L,), **b),
        lm_desc=torch.zeros((L, 8), dtype=torch.int32, device=device),
        lm_normal=torch.zeros((L, 3), **f32),
        lm_dist_min=torch.zeros((L,), **f32),
        lm_dist_max=torch.zeros((L,), **f32),
        lm_ref_kf=torch.full((L,), -1, **i64),
        lm_n_vis=torch.zeros((L,), **i64),
        lm_n_fnd=torch.zeros((L,), **i64),
        lm_plane=torch.full((L,), -1, **i64),
        kf_seg=torch.zeros((K, ML, 4), **f32),
        kf_seg_depth=torch.zeros((K, ML, 2), **f32),
        kf_seg_desc=torch.zeros((K, ML, LD), **f32),
        kf_seg_valid=torch.zeros((K, ML), **b),
        kf_line_idx=torch.full((K, ML), -1, **i64),
        ln_pluck=torch.zeros((L2, 6), **f32),
        ln_endpoints=torch.zeros((L2, 6), **f32),
        ln_desc=torch.zeros((L2, LD), **f32),
        ln_valid=torch.zeros((L2,), **b),
        ln_ref_kf=torch.full((L2,), -1, **i64),
        ln_n_vis=torch.zeros((L2,), **i64),
        ln_n_fnd=torch.zeros((L2,), **i64),
        pl_coef=torch.zeros((P, 4), **f32),
        pl_valid=torch.zeros((P,), **b),
        pl_needs_refresh=torch.zeros((P,), **b),
        pl_ref_kf=torch.full((P,), -1, **i64),
    )


def from_numpy(arrays, device) -> MapState:
    """MapState from the JAX package's field arrays (a dict of numpy
    arrays keyed by field name): u32 descriptors become their int32 bit
    patterns, int32 ids and levels become int64."""
    fields = {}
    for name in MapState._fields:
        a = np.asarray(arrays[name])
        if name in _DESC_FIELDS:
            a = np.ascontiguousarray(a).view(np.int32)
        elif a.dtype == np.int32:
            a = a.astype(np.int64)
        fields[name] = torch.from_numpy(np.array(a)).to(device)
    return MapState(**fields)


def to_numpy(state: MapState) -> dict:
    """The inverse of :func:`from_numpy`: field arrays in the JAX
    package's dtypes (u32 descriptors, int32 ids)."""
    out = {}
    for name in MapState._fields:
        a = getattr(state, name).detach().cpu().numpy()
        if name in _DESC_FIELDS:
            a = np.ascontiguousarray(a).view(np.uint32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        out[name] = a
    return out


# ---------------------------------------------------------------------------
# Covisibility as matmul.
# ---------------------------------------------------------------------------


def _row_indicator(lm, ok, L):
    """``[R, L]`` f32: 1 where a row's valid observation names landmark l."""
    R = lm.shape[0]
    ind = torch.zeros((R, L + 1), dtype=torch.float32, device=lm.device)
    rows = torch.arange(R, device=lm.device)[:, None].expand_as(lm)
    ind[rows, torch.where(ok, lm, L)] = 1.0
    return ind[:, :L]


def observation_indicator(state: MapState):
    """``[K, L]`` f32 indicator: keyframe k observes landmark l."""
    L = state.lm_pos.shape[0]
    lm = state.kf_lm_idx
    ok = (lm >= 0) & state.kf_kp_valid & state.kf_valid[:, None]
    return _row_indicator(lm, ok, L) * state.lm_valid[None, :].to(torch.float32)


def indicator_update_rows(ind, state: MapState, rows):
    """Recompute only the given keyframe ROWS of an observation indicator
    and re-apply the global validity masks (returns a new tensor)."""
    K = state.kf_lm_idx.shape[0]
    L = state.lm_pos.shape[0]
    rows = torch.as_tensor(rows, device=ind.device).reshape(-1)
    rows_safe = torch.clamp(rows, 0, K - 1)
    lm = state.kf_lm_idx[rows_safe]
    ok = (lm >= 0) & state.kf_kp_valid[rows_safe] & state.kf_valid[rows_safe][:, None]
    row_ind = _row_indicator(lm, ok, L)
    ind = ind.clone()
    # Duplicate rows carry identical content, so their order is immaterial.
    ind[rows_safe] = row_ind
    return (
        ind
        * state.lm_valid[None, :].to(torch.float32)
        * state.kf_valid[:, None].to(torch.float32)
    )


def covisibility_matrix(state: MapState, ind=None):
    """``[K, K]`` i64 shared-landmark counts (diag = own landmark count)."""
    ind = observation_indicator(state) if ind is None else ind
    return (ind @ ind.T).to(torch.int64)


def landmark_observation_counts(state: MapState, ind=None):
    """``[L]`` i64 — number of keyframes observing each landmark."""
    if ind is None:
        ind = observation_indicator(state)
    return torch.sum(ind, dim=0).to(torch.int64)


def local_landmark_mask(state: MapState, kf_mask, ind=None):
    """Landmarks observed by any keyframe in ``kf_mask`` (``[K]`` bool)."""
    if ind is None:
        ind = observation_indicator(state)
    return ((kf_mask.to(torch.float32) @ ind) > 0) & state.lm_valid


# ---------------------------------------------------------------------------
# Functional writers.
# ---------------------------------------------------------------------------


def with_row(t, slot, value):
    """A copy of ``t`` with row ``slot`` set to ``value`` (``.at[slot].set``)."""
    out = t.clone()
    out[slot] = value
    return out


def add_keyframe(state: MapState, slot, pose, timestamp, feats, lm_idx):
    """Write one keyframe into ``slot`` from the frame feature dict
    (xy/xr/depth/level/angle/desc/bearing/valid padded to max_kps; with
    lines also seg/seg_desc/seg_valid and optionally seg_depth, and the
    keyframe's segment-to-line row reset to -1)."""
    if "seg" in feats:
        seg_depth = feats.get("seg_depth")
        state = state._replace(
            kf_seg=with_row(state.kf_seg, slot, feats["seg"]),
            kf_seg_depth=with_row(state.kf_seg_depth, slot,
                                  0.0 if seg_depth is None else seg_depth),
            kf_seg_desc=with_row(state.kf_seg_desc, slot, feats["seg_desc"]),
            kf_seg_valid=with_row(state.kf_seg_valid, slot, feats["seg_valid"]),
            kf_line_idx=with_row(state.kf_line_idx, slot, -1),
        )
    return state._replace(
        kf_pose=with_row(state.kf_pose, slot, pose),
        kf_valid=with_row(state.kf_valid, slot, True),
        kf_timestamp=with_row(state.kf_timestamp, slot, float(timestamp)),
        kf_xy=with_row(state.kf_xy, slot, feats["xy"]),
        kf_xr=with_row(state.kf_xr, slot, feats["xr"]),
        kf_depth=with_row(state.kf_depth, slot, feats["depth"]),
        kf_level=with_row(state.kf_level, slot, feats["level"]),
        kf_angle=with_row(state.kf_angle, slot, feats["angle"]),
        kf_desc=with_row(state.kf_desc, slot, feats["desc"]),
        kf_bearing=with_row(state.kf_bearing, slot, feats["bearing"]),
        kf_kp_valid=with_row(state.kf_kp_valid, slot, feats["valid"]),
        kf_lm_idx=with_row(state.kf_lm_idx, slot, lm_idx),
    )


def add_landmarks(state: MapState, slots, pos, desc, normal, dist_min, dist_max,
                  ref_kf, valid):
    """Write a batch of new landmarks into ``slots`` (``[M]``); rows with
    ``valid=False`` or a slot past capacity write nothing. Valid slots are
    distinct (every creation site allocates them by a running count)."""
    L = state.lm_pos.shape[0]
    w = valid & (slots >= 0) & (slots < L)
    s = slots[w]

    def put(arr, vals):
        out = arr.clone()
        out[s] = vals[w].to(arr.dtype)
        return out

    ones = torch.ones_like(slots)
    return state._replace(
        lm_pos=put(state.lm_pos, pos),
        lm_valid=put(state.lm_valid, valid),
        lm_desc=put(state.lm_desc, desc),
        lm_normal=put(state.lm_normal, normal),
        lm_dist_min=put(state.lm_dist_min, dist_min),
        lm_dist_max=put(state.lm_dist_max, dist_max),
        lm_ref_kf=put(state.lm_ref_kf, ref_kf),
        lm_n_vis=put(state.lm_n_vis, ones),
        lm_n_fnd=put(state.lm_n_fnd, ones),
        lm_plane=put(state.lm_plane, -ones),
    )


def remove_landmarks(state: MapState, lm_mask):
    """Invalidate landmarks where ``lm_mask`` is True and detach their
    observations (reference: landmark::prepare_for_erasing)."""
    lm_idx = state.kf_lm_idx
    gone = (lm_idx >= 0) & lm_mask[torch.clamp(lm_idx, min=0)]
    return state._replace(
        lm_valid=state.lm_valid & ~lm_mask,
        kf_lm_idx=torch.where(gone, -1, lm_idx),
    )


def remove_keyframes(state: MapState, kf_mask):
    """Invalidate keyframes where ``kf_mask`` is True."""
    return state._replace(
        kf_valid=state.kf_valid & ~kf_mask,
        kf_kp_valid=state.kf_kp_valid & ~kf_mask[:, None],
        kf_lm_idx=torch.where(kf_mask[:, None], -1, state.kf_lm_idx),
    )
