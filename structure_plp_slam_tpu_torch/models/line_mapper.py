"""Line landmarks: frame matching, creation, culling and pose refinement.

Port of structure_plp_slam_tpu/models/line_mapper.py (reference tracking
and mapping line paths, module/two_view_triangulator_line.cc,
match::projection line variants, data/landmark_line.{h,cc}). Batched over
segment slots; every gate stays on the device (``torch.where``), so no
function here waits for the host.
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.ops import lie, linalg, robust
from structure_plp_slam_tpu_torch.ops import line_geometry as lg
from structure_plp_slam_tpu_torch.ops import lines as line_ops
from structure_plp_slam_tpu_torch.utils.types import scatter_set, topk_stable


def _unit2(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)


def _row(t, k):
    """Row ``k`` of ``t``; ``k`` an int or a device scalar (gathered: a 0-d
    tensor index would wait for the card)."""
    return t[k] if isinstance(k, int) else t.index_select(0, k.reshape(1))[0]


def _with_row(t, k, value):
    """A copy of ``t`` with row ``k`` set to ``value`` (``k`` as in
    :func:`_row`)."""
    if isinstance(k, int):
        return ms.with_row(t, k, value)
    return t.index_copy(0, k.reshape(1), value[None].to(t.dtype))


def _seg_dir(seg):
    return _unit2(torch.stack([seg[..., 2] - seg[..., 0], seg[..., 3] - seg[..., 1]], dim=-1))


def match_lines_to_frame(camera, state: ms.MapState, seg, seg_desc, seg_valid, R, t, *,
                         max_desc_dist: float = 0.4, max_px_dist: float = 12.0):
    """Associate detected segments with map lines under pose (R, t): the
    segment midpoint's distance to the projected infinite line, direction
    agreement and descriptor distance. Returns ``seg_line_idx [ML]``."""
    l_img = lg.project_line(camera, lg.transform_line(state.ln_pluck, R, t))  # [L2, 3]
    ep_w = state.ln_endpoints
    e1c = ep_w[:, :3] @ R.T + t
    e2c = ep_w[:, 3:] @ R.T + t
    vis = state.ln_valid & (e1c[:, 2] > 0.05) & (e2c[:, 2] > 0.05)
    mid = torch.stack([(seg[:, 0] + seg[:, 2]) * 0.5, (seg[:, 1] + seg[:, 3]) * 0.5], dim=1)
    n = torch.sqrt(torch.clamp(l_img[:, 0] ** 2 + l_img[:, 1] ** 2, min=1e-12))
    d_mid = torch.abs(l_img[:, 0:1] * mid[None, :, 0] + l_img[:, 1:2] * mid[None, :, 1]
                      + l_img[:, 2:3]) / n[:, None]                          # [L2, ML]
    line_dir = _unit2(torch.stack([l_img[:, 1], -l_img[:, 0]], dim=1))
    cosang = torch.abs(line_dir @ _seg_dir(seg).T)
    desc_d = line_ops.line_descriptor_distance_matrix(state.ln_desc, seg_desc, vis, seg_valid)
    cost = torch.where((d_mid <= max_px_dist) & (cosang >= 0.985) & (desc_d <= max_desc_dist),
                       desc_d + d_mid * 0.01, torch.full_like(desc_d, 1e9))
    best_line = torch.argmin(cost, dim=0)  # first minimum, as jnp.argmin
    best_cost = torch.amin(cost, dim=0)
    ok = (best_cost < 1e8) & seg_valid
    return torch.where(ok, best_line, -1)


def update_line_stats(camera, state: ms.MapState, seg_line_idx, R, t):
    """Per-frame observed/observable counts of the lines (the line analog
    of landmark::increase_num_observable/observed; feeds culling)."""
    L2 = state.ln_pluck.shape[0]
    e1c = state.ln_endpoints[:, :3] @ R.T + t
    e2c = state.ln_endpoints[:, 3:] @ R.T + t
    mid = 0.5 * (e1c + e2c)
    z = torch.clamp(mid[:, 2], min=1e-6)
    u = camera.fx * mid[:, 0] / z + camera.cx
    v = camera.fy * mid[:, 1] / z + camera.cy
    vis = (state.ln_valid & (e1c[:, 2] > 0.05) & (e2c[:, 2] > 0.05)
           & (u >= 0) & (u < camera.cols) & (v >= 0) & (v < camera.rows))
    fnd = scatter_set(torch.zeros((L2,), dtype=torch.bool, device=state.device),
                      torch.clamp(seg_line_idx, 0, L2 - 1), seg_line_idx >= 0,
                      torch.ones_like(seg_line_idx, dtype=torch.bool))
    return state._replace(ln_n_vis=state.ln_n_vis + vis.to(torch.int64),
                          ln_n_fnd=state.ln_n_fnd + (fnd & state.ln_valid).to(torch.int64))


def cull_lines(state: ms.MapState, current_kf):
    """Remove unreliable lines: observed ratio < 0.3 once seen 4 times, or
    registered in <= 1 keyframe at age >= 3
    (local_map_cleaner::remove_redundant_landmarks_line,
    local_map_cleaner.cc:133). Returns (state, num_culled)."""
    L2 = state.ln_pluck.shape[0]
    counts = torch.zeros((L2 + 1,), dtype=torch.int64, device=state.device)
    li = state.kf_line_idx.reshape(-1)
    counts.index_add_(0, torch.where(li >= 0, li, L2), torch.ones_like(li))
    counts = counts[:L2]
    ratio = state.ln_n_fnd.to(torch.float32) / torch.clamp(state.ln_n_vis.to(torch.float32),
                                                           min=1.0)
    age = current_kf - state.ln_ref_kf
    bad = state.ln_valid & (((state.ln_n_vis >= 4) & (ratio < 0.3))
                            | ((age >= 3) & (counts <= 1)))
    kli = state.kf_line_idx
    kli = torch.where(bad[torch.clamp(kli, 0, L2 - 1)] & (kli >= 0), -1, kli)
    return state._replace(ln_valid=state.ln_valid & ~bad, kf_line_idx=kli), torch.sum(bad)


def line_pose_residuals(camera, R, t, pluck_w, seg):
    """Endpoint-to-projected-line residuals ``[M, 2]`` under pose (R, t)."""
    l = lg.project_line(camera, lg.transform_line(pluck_w, R, t))
    return lg.endpoint_line_distances(l, seg[..., 0:2], seg[..., 2:4])


def _backproj(camera, x, y, z):
    return torch.stack([(x - camera.cx) / camera.fx * z, (y - camera.cy) / camera.fy * z, z],
                       dim=-1)


def _inner_points(seg):
    """The image points at 10% and 90% along each segment (where the
    frontend sampled the endpoint depths)."""
    x1 = seg[..., 0] + 0.1 * (seg[..., 2] - seg[..., 0])
    y1 = seg[..., 1] + 0.1 * (seg[..., 3] - seg[..., 1])
    x2 = seg[..., 0] + 0.9 * (seg[..., 2] - seg[..., 0])
    y2 = seg[..., 1] + 0.9 * (seg[..., 3] - seg[..., 1])
    return x1, y1, x2, y2


def _write_lines(state, kf, good, base_slot, pluck, e1w, e2w):
    """Allocate line slots for the ``good`` segments of keyframe ``kf`` in
    order from ``base_slot`` (capacity-gated) and register them in its
    row. Returns (state, the written mask, the slots)."""
    L2 = state.ln_pluck.shape[0]
    slots = base_slot + torch.cumsum(good.to(torch.int64), 0) - 1
    good = good & (slots < L2)
    state = state._replace(
        ln_pluck=scatter_set(state.ln_pluck, slots, pluck, good),
        ln_endpoints=scatter_set(state.ln_endpoints, slots, torch.cat([e1w, e2w], dim=-1), good),
        ln_desc=scatter_set(state.ln_desc, slots, state.kf_seg_desc[kf], good),
        ln_valid=scatter_set(state.ln_valid, slots, good, good),
        ln_ref_kf=scatter_set(state.ln_ref_kf, slots, torch.full_like(slots, int(kf)), good),
    )
    row = torch.where(good, slots, state.kf_line_idx[kf])
    state = state._replace(kf_line_idx=ms.with_row(state.kf_line_idx, kf, row))
    return state, good, slots


def lines_from_depth(camera, state: ms.MapState, kf, base_slot):
    """3D lines straight from keyframe ``kf``'s endpoint depths (RGB-D and
    stereo), extrapolated from the 10% / 90% sample points to the whole
    segment. Returns (state, num_created)."""
    seg = state.kf_seg[kf]
    d = state.kf_seg_depth[kf]
    free = state.kf_seg_valid[kf] & (state.kf_line_idx[kf] < 0)
    ok_d = (d[:, 0] > 0.05) & (d[:, 1] > 0.05) & (d[:, 1] < camera.true_depth_threshold + 1e9)
    x1, y1, x2, y2 = _inner_points(seg)
    p1c = _backproj(camera, x1, y1, d[:, 0])
    p2c = _backproj(camera, x2, y2, d[:, 1])
    R, t = state.kf_pose[kf, :, :3], state.kf_pose[kf, :, 3]
    p1w = (p1c - t) @ R
    p2w = (p2c - t) @ R
    good = free & ok_d & (torch.linalg.norm(p2c - p1c, dim=-1) > 0.05)
    state, good, _ = _write_lines(state, kf, good, base_slot,
                                  lg.plucker_from_endpoints(p1w, p2w), p1w, p2w)
    return state, torch.sum(good)


def refresh_lines(camera, state: ms.MapState):
    """Re-derive each line from its reference keyframe's stored segment
    and endpoint depths under the current keyframe poses (the line
    vertices of local_bundle_adjuster_extended_line.cc and the post-BA
    endpoint re-trimming, loop_bundle_adjuster.h:87)."""
    K, ML = state.kf_line_idx.shape
    L2 = state.ln_pluck.shape[0]
    d = state.kf_seg_depth
    li = state.kf_line_idx
    R = state.kf_pose[:, :, :3]
    t = state.kf_pose[:, :, 3]
    x1, y1, x2, y2 = _inner_points(state.kf_seg)
    p1c = _backproj(camera, x1, y1, d[..., 0])
    p2c = _backproj(camera, x2, y2, d[..., 1])
    p1w = torch.einsum("kij,kmi->kmj", R, p1c - t[:, None, :])
    p2w = torch.einsum("kij,kmi->kmj", R, p2c - t[:, None, :])
    # Only the observation in the line's own reference keyframe, with
    # depth, refreshes it.
    kf_ids = torch.arange(K, device=state.device)[:, None].expand(K, ML)
    is_ref = ((li >= 0) & (state.ln_ref_kf[torch.clamp(li, 0, L2 - 1)] == kf_ids)
              & (d[..., 0] > 0.05) & (d[..., 1] > 0.05)
              & state.kf_seg_valid & state.kf_valid[:, None])
    tgt = li.reshape(-1)
    ok = is_ref.reshape(-1)
    p1f, p2f = p1w.reshape(-1, 3), p2w.reshape(-1, 3)
    return state._replace(
        ln_pluck=scatter_set(state.ln_pluck, tgt, lg.plucker_from_endpoints(p1f, p2f), ok),
        ln_endpoints=scatter_set(state.ln_endpoints, tgt, torch.cat([p1f, p2f], dim=-1), ok),
    )


def _seg_abc(seg):
    """Coefficients of the image line through a segment's endpoints."""
    a = seg[:, 1] - seg[:, 3]
    b = seg[:, 2] - seg[:, 0]
    c = seg[:, 0] * seg[:, 3] - seg[:, 2] * seg[:, 1]
    return a, b, c, torch.sqrt(torch.clamp(a * a + b * b, min=1e-12))


def _along(seg, xy):
    """Segment lengths and the projections ``[ML, N]`` of ``xy`` along
    each segment from its first endpoint."""
    seg_len = torch.clamp(torch.linalg.norm(seg[:, 2:4] - seg[:, 0:2], dim=-1), min=1e-6)
    ux = (seg[:, 2] - seg[:, 0]) / seg_len
    uy = (seg[:, 3] - seg[:, 1]) / seg_len
    t_al = ((xy[None, :, 0] - seg[:, 0:1]) * ux[:, None]
            + (xy[None, :, 1] - seg[:, 1:2]) * uy[:, None])
    return seg_len, t_al


def lines_from_points(camera, state: ms.MapState, kf, base_slot):
    """3D lines anchored on co-located point landmarks (the monocular
    path): a weighted least-squares fit of inverse depth, linear along
    the image segment, over the landmarks projecting onto the segment
    gives its endpoint depths; the supported extent bounds the endpoints,
    and the supports on the two sides of the segment must agree in depth
    (no occlusion boundary). Returns (state, num_created)."""
    Lp = state.lm_pos.shape[0]
    seg = state.kf_seg[kf]
    free = state.kf_seg_valid[kf] & (state.kf_line_idx[kf] < 0)
    R, t = state.kf_pose[kf, :, :3], state.kf_pose[kf, :, 3]
    lm_idx = state.kf_lm_idx[kf]
    has_lm = (lm_idx >= 0) & state.kf_kp_valid[kf]
    z_lm = (state.lm_pos[torch.clamp(lm_idx, 0, Lp - 1)] @ R.T + t)[:, 2]
    xy = state.kf_xy[kf]
    a, b, c, nrm = _seg_abc(seg)
    signed = a[:, None] * xy[None, :, 0] + b[:, None] * xy[None, :, 1] + c[:, None]
    d_perp = torch.abs(signed) / nrm[:, None]
    seg_len, t_al = _along(seg, xy)
    w = (has_lm[None, :] & (z_lm[None, :] > 1e-6) & (d_perp <= 4.0) & (t_al >= -3.0)
         & (t_al <= seg_len[:, None] + 3.0)).to(torch.float32)
    tau = t_al / seg_len[:, None]
    rho = 1.0 / torch.clamp(z_lm[None, :], min=1e-6)
    side = signed > 0.0
    S0 = torch.sum(w, dim=1)
    S1 = torch.sum(w * tau, dim=1)
    S2 = torch.sum(w * tau * tau, dim=1)
    Sr = torch.sum(w * rho, dim=1)
    Str = torch.sum(w * tau * rho, dim=1)
    det = S0 * S2 - S1 * S1
    safe_det = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    r1 = (S0 * Str - S1 * Sr) / safe_det
    S0c = torch.clamp(S0, min=1e-6)
    r0 = (Sr - r1 * S1) / S0c
    pred = r0[:, None] + r1[:, None] * tau
    resid = torch.sum(w * (rho - pred) ** 2, dim=1) / S0c
    mean_rho = Sr / S0c
    spread = S2 / S0c - (S1 / S0c) ** 2
    # Endpoints span the supported extent, slightly extended.
    inf = torch.full_like(tau, float("inf"))
    t_lo = torch.clamp(torch.amin(torch.where(w > 0, tau, inf), dim=1) - 0.15, 0.0, 1.0)
    t_hi = torch.clamp(torch.amax(torch.where(w > 0, tau, -inf), dim=1) + 0.15, 0.0, 1.0)
    rho0 = r0 + r1 * t_lo
    rho1 = r0 + r1 * t_hi
    wl = w * side.to(torch.float32)
    wr = w * (~side).to(torch.float32)
    nl = torch.sum(wl, dim=1)
    nr = torch.sum(wr, dim=1)
    rho_l = torch.sum(wl * rho, dim=1) / torch.clamp(nl, min=1e-6)
    rho_r = torch.sum(wr * rho, dim=1) / torch.clamp(nr, min=1e-6)
    sides_agree = ((nl < 1.0) | (nr < 1.0)
                   | (torch.abs(rho_l - rho_r) <= 0.15 * torch.clamp(mean_rho, min=1e-6)))
    good = (free & (S0 >= 3.0) & (spread >= 0.06) & (t_hi - t_lo >= 0.5)
            & (resid <= (0.08 * mean_rho) ** 2) & sides_agree & (rho0 > 1e-6) & (rho1 > 1e-6))

    def backproj_w(u, v, z):
        return (_backproj(camera, u, v, z) - t) @ R

    e1w = backproj_w(seg[:, 0] + t_lo * (seg[:, 2] - seg[:, 0]),
                     seg[:, 1] + t_lo * (seg[:, 3] - seg[:, 1]),
                     1.0 / torch.clamp(rho0, min=1e-6))
    e2w = backproj_w(seg[:, 0] + t_hi * (seg[:, 2] - seg[:, 0]),
                     seg[:, 1] + t_hi * (seg[:, 3] - seg[:, 1]),
                     1.0 / torch.clamp(rho1, min=1e-6))
    state, good, _ = _write_lines(state, kf, good, base_slot,
                                  lg.plucker_from_endpoints(e1w, e2w), e1w, e2w)
    return state, torch.sum(good)


def triangulate_lines_pair(camera, state: ms.MapState, kf1, kf2, base_slot, enable=True):
    """3D lines from the unassociated segments of two keyframes
    (mapping_module.cc:407-408, two_view_triangulator_line): every segment
    pair is triangulated at once, and the symmetric along-line overlap of
    the endpoint transfer between the views joins the descriptor in the
    match cost; mutual best pairs that pass the gates and agree with the
    depths of co-located point landmarks become lines.
    Returns (state, num_created)."""
    ML = state.kf_seg.shape[1]
    Lp = state.lm_pos.shape[0]
    dev = state.device
    free1 = state.kf_seg_valid[kf1] & (state.kf_line_idx[kf1] < 0)
    free2 = _row(state.kf_seg_valid, kf2) & (_row(state.kf_line_idx, kf2) < 0)
    desc_d = line_ops.line_descriptor_distance_matrix(state.kf_seg_desc[kf1],
                                                      _row(state.kf_seg_desc, kf2), free1, free2)
    R1, t1 = state.kf_pose[kf1, :, :3], state.kf_pose[kf1, :, 3]
    P2 = _row(state.kf_pose, kf2)
    R2, t2 = P2[:, :3], P2[:, 3]
    s1 = state.kf_seg[kf1][:, None, :].expand(ML, ML, 4)
    s2 = _row(state.kf_seg, kf2)[None, :, :].expand(ML, ML, 4)
    pl_w, tri_ok = lg.triangulate_line_two_view(camera, s1, s2, R1, t1, R2, t2)

    def transfer(R_from, t_from, seg_from, R_to, t_to, seg_to):
        """Trim against ``seg_from``, reproject into the other view, and
        the 1D overlap with ``seg_to`` along its direction (overlap, since
        border clipping puts the views' endpoints at different points)."""
        eps_c, depth_ok = lg.trim_endpoints(camera, lg.transform_line(pl_w, R_from, t_from),
                                            seg_from)
        e1w = torch.einsum("...i,ij->...j", eps_c[..., 0, :] - t_from, R_from)
        e2w = torch.einsum("...i,ij->...j", eps_c[..., 1, :] - t_from, R_from)

        def proj(pw):
            pc = torch.einsum("...j,ij->...i", pw, R_to) + t_to
            z = torch.clamp(pc[..., 2], min=1e-6)
            return torch.stack([camera.fx * pc[..., 0] / z + camera.cx,
                                camera.fy * pc[..., 1] / z + camera.cy], dim=-1), pc[..., 2]

        p1, z1 = proj(e1w)
        p2, z2 = proj(e2w)
        a, b = seg_to[..., 0:2], seg_to[..., 2:4]
        length = torch.clamp(torch.linalg.norm(b - a, dim=-1), min=1e-6)
        u = (b - a) / length[..., None]
        tp1 = torch.sum((p1 - a) * u, dim=-1)
        tp2 = torch.sum((p2 - a) * u, dim=-1)
        lo, hi = torch.minimum(tp1, tp2), torch.maximum(tp1, tp2)
        inter = torch.minimum(hi, length) - torch.clamp(lo, min=0.0)
        ov = inter / torch.clamp(torch.minimum(hi - lo, length), min=1e-6)
        return ov, depth_ok & (z1 > 0.05) & (z2 > 0.05), e1w, e2w

    ov12, ok12, e1w, e2w = transfer(R1, t1, s1, R2, t2, s2)
    ov21, ok21, _, _ = transfer(R2, t2, s2, R1, t1, s1)
    # 2D orientation agreement (mod pi), the segment analog of the
    # rotation-consistency histogram.
    dir_cos = torch.abs(torch.sum(_seg_dir(s1) * _seg_dir(s2), dim=-1))
    pair_ok = (free1[:, None] & free2[None, :] & tri_ok & ok12 & ok21 & (desc_d <= 0.8)
               & (dir_cos > 0.966) & (ov12 > 0.5) & (ov21 > 0.5))
    cost = torch.where(pair_ok, (2.0 - ov12 - ov21) + desc_d, torch.full_like(desc_d, float("inf")))
    best = torch.argmin(cost, dim=1)
    best_cost = torch.gather(cost, 1, best[:, None])[:, 0]
    rev = torch.argmin(cost, dim=0)
    rows = torch.arange(ML, device=dev)
    good = torch.isfinite(best_cost) & (rev[best] == rows)
    pl_sel = pl_w[rows, best]
    e1_sel = e1w[rows, best]
    e2_sel = e2w[rows, best]

    # Depth prior from the point map: keypoint landmarks of kf1 lying on
    # the segment must mostly agree with the line's depth there.
    seg1 = state.kf_seg[kf1]
    a, b, c, nrm = _seg_abc(seg1)
    xy = state.kf_xy[kf1]
    lm_idx = state.kf_lm_idx[kf1]
    has_lm = (lm_idx >= 0) & state.kf_kp_valid[kf1]
    z_lm = (state.lm_pos[torch.clamp(lm_idx, 0, Lp - 1)] @ R1.T + t1)[:, 2]
    d_perp = torch.abs(a[:, None] * xy[None, :, 0] + b[:, None] * xy[None, :, 1]
                       + c[:, None]) / nrm[:, None]
    seg_len, t_along = _along(seg1, xy)
    frac = torch.clamp(t_along / seg_len[:, None], 0.0, 1.0)
    on_seg = (has_lm[None, :] & (d_perp <= 6.0) & (t_along >= -5.0)
              & (t_along <= seg_len[:, None] + 5.0) & (z_lm[None, :] > 1e-6))
    z1_sel = (e1_sel @ R1.T + t1)[:, 2]
    z2_sel = (e2_sel @ R1.T + t1)[:, 2]
    z_line_at = z1_sel[:, None] + frac * (z2_sel - z1_sel)[:, None]
    agree = on_seg & (torch.abs(z_lm[None, :] - z_line_at)
                      <= 0.35 * torch.clamp(z_lm[None, :], min=1e-6))
    n_on = torch.sum(on_seg, dim=1)
    n_agree = torch.sum(agree, dim=1)
    depth_prior_ok = (n_on < 2) | (n_agree.to(torch.float32) >= 0.5 * n_on.to(torch.float32))
    good = good & depth_prior_ok & enable

    state, good, slots = _write_lines(state, kf1, good, base_slot, pl_sel, e1_sel, e2_sel)
    col2 = scatter_set(_row(state.kf_line_idx, kf2), best, slots, good)
    state = state._replace(kf_line_idx=_with_row(state.kf_line_idx, kf2, col2))
    return state, torch.sum(good)


def triangulate_lines_with_neighbors(camera, state: ms.MapState, slot, base_slot, *,
                                     num_neighbors: int = 3, ind=None):
    """Two-view line triangulation against the covisible neighbours of
    ``slot`` with the widest baselines (at least 3% of the map scale),
    chosen on the device (mapping_module.cc:359-418).
    Returns (state, num_created)."""
    from structure_plp_slam_tpu_torch.models import mapper

    W = ms.covisibility_matrix(state, ind)[slot].clone()
    W[slot] = 0
    C = -torch.einsum("kji,kj->ki", state.kf_pose[:, :, :3], state.kf_pose[:, :, 3])
    base = torch.linalg.norm(C - C[slot], dim=-1)
    min_base = 0.03 * mapper.map_scale(state, slot)
    eligible = (W >= 15) & state.kf_valid & (base >= min_base)
    s_top, nbs = topk_stable(torch.where(eligible, base, torch.full_like(base, -1.0)),
                             num_neighbors)
    next_ln = base_slot
    for i in range(num_neighbors):
        state, n_new = triangulate_lines_pair(camera, state, slot, nbs[i], next_ln,
                                              enable=s_top[i] > 0.0)
        next_ln = next_ln + n_new
    return state, next_ln - base_slot


def track_lines(camera, state: ms.MapState, seg, seg_desc, seg_valid, pts_w, obs_uv,
                obs_info, pts_valid, R, t):
    """Per-frame line tracking: associate the segments with map lines,
    refine the pose jointly with the points when >= 3 lines matched
    (pose_optimizer_extended_line), update the line statistics. The gate
    is a device value: with fewer matches the input pose passes through.
    Returns (state, R, t, seg_line_idx)."""
    L2 = state.ln_pluck.shape[0]
    seg_lines = match_lines_to_frame(camera, state, seg, seg_desc, seg_valid, R, t)
    gate = torch.sum(seg_lines >= 0) >= 3
    pl = state.ln_pluck[torch.clamp(seg_lines, 0, L2 - 1)]
    R2, t2, line_inl = refine_pose_with_lines(camera, R, t, pts_w, obs_uv, obs_info,
                                              pts_valid, pl, seg, (seg_lines >= 0) & gate)
    R_out = torch.where(gate, R2, R)
    t_out = torch.where(gate, t2, t)
    seg_lines = torch.where(gate & ~line_inl, -1, seg_lines)
    state = update_line_stats(camera, state, seg_lines, R_out, t_out)
    return state, R_out, t_out, seg_lines


def refine_pose_with_lines(camera, R0, t0, pts_w, obs_uv, obs_info, pts_valid, pluck_w, seg,
                           line_valid, *, num_iters: int = 6, line_weight: float = 1.0):
    """Joint point + line motion-only Gauss-Newton from the point-only
    optimum (pose_optimizer_extended_line.cc): analytic point terms,
    forward-mode Jacobians of the endpoint-to-line residuals with respect
    to the se(3) perturbation. Returns (R, t, line inliers)."""
    M = pluck_w.shape[0]
    dev = R0.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    R, t = R0, t0
    for _ in range(num_iters):
        pc = pts_w @ R.T + t
        z = torch.where(torch.abs(pc[:, 2]) < 1e-9, torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
        u = camera.fx * pc[:, 0] / z + camera.cx
        v = camera.fy * pc[:, 1] / z + camera.cy
        r_uv = torch.stack([u, v], -1) - obs_uv
        chi2 = torch.sum(r_uv * r_uv, -1) * obs_info
        w = torch.where(pts_valid & (pc[:, 2] > 1e-6),
                        robust.huber_weight(chi2, robust.CHI2_2D) * obs_info, zero)
        iz = 1.0 / z
        iz2 = iz * iz
        zz = torch.zeros_like(z)
        J_uv_pc = torch.stack([
            torch.stack([camera.fx * iz, zz, -camera.fx * pc[:, 0] * iz2], -1),
            torch.stack([zz, camera.fy * iz, -camera.fy * pc[:, 1] * iz2], -1),
        ], dim=-2)
        dpc = torch.cat([eye3.expand(pc.shape[0], 3, 3), -lie.hat(pc)], dim=-1)
        J = J_uv_pc @ dpc
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        b = -torch.einsum("nri,nr->i", Jw, r_uv)

        def line_res(xi, R=R, t=t):
            dR, dt = lie.se3_exp(xi)
            R2, t2 = lie.se3_compose(dR, dt, R, t)
            return line_pose_residuals(camera, R2, t2, pluck_w, seg)

        rl, Jl = linalg.jacobian_fwd(line_res, torch.zeros((M, 6), dtype=torch.float32, device=dev), 6)
        chi2_l = torch.sum(rl * rl, -1)
        wl = torch.where(line_valid, robust.huber_weight(chi2_l, robust.CHI2_2D) * line_weight,
                         zero)
        Jlw = Jl * wl[:, None, None]
        H = H + torch.einsum("mri,mrj->ij", Jlw, Jl)
        b = b - torch.einsum("mri,mr->i", Jlw, rl)
        H = H + 1e-5 * torch.trace(H) / 6.0 * eye6
        xi = linalg.solve(H, b)
        xi = torch.where(torch.isfinite(xi).all(), xi, zero)
        R, t = lie.se3_update(R, t, xi)
    rl = line_pose_residuals(camera, R, t, pluck_w, seg)
    return R, t, line_valid & (torch.sum(rl * rl, -1) <= robust.CHI2_2D)
