"""Capacity growth for the SoA map state.

Port of structure_plp_slam_tpu/data/map_database.py. The reference's map
grows without bound (heap objects, data/map_database.h:59-270); here
capacities are fixed tensor shapes, so growth is a reallocation: a fresh
MapState at the larger capacity with the old tensors copied into its
prefix. Slot ids never move, so no host bookkeeping (trajectory records,
reference keyframes) needs fixing up, and capacities double, so a
sequence of any length pays O(log) growth events.
"""

from __future__ import annotations

from structure_plp_slam_tpu_torch.data import map_state as ms


def grow(state: ms.MapState, *, grow_kf: bool = False, grow_lm: bool = False,
         grow_ln: bool = False, grow_pl: bool = False, factor: int = 2) -> ms.MapState:
    """A state with the selected capacities (keyframes, landmarks, line
    landmarks, planes) multiplied by ``factor``; existing slots keep their
    indices and contents."""
    K, N = state.kf_pose.shape[0], state.kf_xy.shape[1]
    L, L2, P = state.lm_pos.shape[0], state.ln_pluck.shape[0], state.pl_coef.shape[0]
    new = ms.create(
        max_keyframes=K * factor if grow_kf else K,
        max_kps=N,
        max_landmarks=L * factor if grow_lm else L,
        max_lines_per_kf=state.kf_seg.shape[1],
        max_line_landmarks=L2 * factor if grow_ln else L2,
        line_desc_dim=state.ln_desc.shape[1],
        max_planes=P * factor if grow_pl else P,
        device=state.device,
    )
    out = {}
    for name in state._fields:
        old, fresh = getattr(state, name), getattr(new, name)
        if old.shape == fresh.shape:
            out[name] = old
        else:
            fresh[tuple(slice(0, s) for s in old.shape)] = old
            out[name] = fresh
    return ms.MapState(**out)
