"""Full-map global bundle adjustment (pair-based sparse Schur).

Port of structure_plp_slam_tpu/models/global_ba.py (reference
optimize/global_bundle_adjuster.cc, the whole-map BA run after a loop
closure). The windowed solver's dense ``[M, C, 6, 3]`` coupling does not
scale to a whole map, so this one follows BA's sparsity:

  S = Hcc_diag - sum_m W_m Hll_m^-1 W_m^T

couples camera PAIRS that co-observe a landmark. The host enumerates the
observations and the observation pairs (o1, o2 on the same landmark) once
per run (numpy); per Gauss-Newton iteration the device computes the
per-observation Jacobian blocks, scatters ``-U_o1 Hll^-1 U_o2^T`` over the
pair list into the block camera system ``[K, K, 6, 6]``
(``index_put_(accumulate=True)``), Cholesky-solves it and back-substitutes
the landmarks. ``solve_pcg`` applies the same Schur operator matrix-free
inside a PCG for large K. The landmark-sharded solve over several devices
(``mesh``) is ROADMAP A17.

Scatter-add order: on the card the sums of ``index_add_`` /
``index_put_(accumulate=True)`` run in no fixed order, so the normal
equations differ from the JAX package's at about 1e-6 relative; on the
CPU the order is the indices' order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.models import pose_graph as pg
from structure_plp_slam_tpu_torch.ops import lie, robust
from structure_plp_slam_tpu_torch.utils.types import rdiv

MAX_OBS_PER_LM = 12  # observations per landmark that enter the pair list
MIN_OBS = 100        # fewer observations than this: no global BA


class GlobalBAData(NamedTuple):
    """The host-prepared index structure of one global BA run (padded to
    power-of-two buckets, as the JAX package does; ``obs_info = 0`` marks
    a dead row, padded pairs name a dead observation)."""

    obs_cam: torch.Tensor    # [O] i64 keyframe slot per observation
    obs_lm: torch.Tensor     # [O] i64 landmark slot
    obs_uv: torch.Tensor     # [O, 2]
    obs_xr: torch.Tensor     # [O]
    obs_info: torch.Tensor   # [O]
    pair_o1: torch.Tensor    # [P] i64 observation index
    pair_o2: torch.Tensor    # [P] i64 observation index (same landmark)
    num_obs: int
    num_pairs: int


def prepare(state, inv_sigma_sq_table) -> GlobalBAData:
    """Enumerate observations and pairs from a MapState (reads it back to
    the host; the System's deferred BA uses :func:`prepare_from_arrays` on
    copies it started earlier)."""
    def host(t):
        return t.detach().cpu().numpy()

    return prepare_from_arrays(
        host(state.kf_valid), host(state.kf_kp_valid), host(state.kf_lm_idx),
        host(state.lm_valid), host(state.kf_xy), host(state.kf_xr), host(state.kf_level),
        host(torch.as_tensor(inv_sigma_sq_table)), device=state.kf_pose.device,
    )


def prepare_from_arrays(kf_valid, kp_valid, lm_idx, lm_valid, xy, xr, level, table,
                        device="cpu") -> GlobalBAData:
    """Observations and co-observation pairs from host arrays (numpy).
    Only the first ``MAX_OBS_PER_LM`` observations of a landmark enter the
    pair list; all of them enter Hcc, Hll and b."""
    ks, ns = np.nonzero((lm_idx >= 0) & kp_valid & kf_valid[:, None])
    lms = lm_idx[ks, ns]
    keep = lm_valid[lms]
    ks, ns, lms = ks[keep], ns[keep], lms[keep]
    O = len(ks)
    obs_uv = xy[ks, ns]
    obs_xr = xr[ks, ns]
    obs_info = table[np.clip(level[ks, ns], 0, len(table) - 1)]

    # Pairs grouped by landmark: sort + segment offsets.
    if O > 0:
        order = np.argsort(lms, kind="stable")
        lms_s = lms[order]
        change = np.r_[True, lms_s[1:] != lms_s[:-1]]
        group_id = np.cumsum(change) - 1
        rank = np.arange(O) - np.nonzero(change)[0][group_id]
        keep2 = rank < MAX_OBS_PER_LM
        idx = order[keep2]
        gid = group_id[keep2]
        sizes = np.bincount(gid)
        off = np.concatenate([[0], np.cumsum(sizes)])
        counts = sizes[gid]
        pair_o1 = np.repeat(idx, counts)
        cum = np.cumsum(counts)
        pos = np.arange(int(counts.sum())) - np.repeat(cum - counts, counts)
        pair_o2 = idx[np.repeat(off[gid], counts) + pos]
    else:
        pair_o1 = pair_o2 = np.zeros(0, np.int64)

    # O_pad > O strictly: slot O_pad - 1 is a dead observation for padded
    # pairs to name.
    O_pad = 1 << max(10, int(O).bit_length())
    P = len(pair_o1)
    P_pad = 1 << max(10, int(P).bit_length())

    def padded(a, fill, dtype):
        out = np.full((O_pad,) + np.asarray(a).shape[1:], fill, dtype)
        out[:O] = a
        return torch.from_numpy(out).to(device)

    def pairs(a):
        out = np.full(P_pad, O_pad - 1, np.int64)
        out[:P] = a
        return torch.from_numpy(out).to(device)

    return GlobalBAData(
        obs_cam=padded(ks, 0, np.int64), obs_lm=padded(lms, 0, np.int64),
        obs_uv=padded(obs_uv, 0.0, np.float32), obs_xr=padded(obs_xr, -1.0, np.float32),
        obs_info=padded(obs_info, 0.0, np.float32),
        pair_o1=pairs(pair_o1), pair_o2=pairs(pair_o2), num_obs=O, num_pairs=P,
    )


def _segment_sum(ids, vals, n):
    return vals.new_zeros((n,) + tuple(vals.shape[1:])).index_add_(0, ids, vals)


def _normal_blocks(camera, cam_pose, lm_pos, data: GlobalBAData, damping):
    """Per-observation camera-landmark blocks ``U_o [O, 6, 3]`` and the
    summed Hcc ``[K, 6, 6]``, bc ``[K, 6]``, damped Hll^-1 ``[L, 3, 3]``
    and bl ``[L, 3]`` at the current estimate."""
    K, L = cam_pose.shape[0], lm_pos.shape[0]
    has_stereo = data.obs_xr >= 0.0
    R = cam_pose[data.obs_cam, :, :3]
    t = cam_pose[data.obs_cam, :, 3]
    pc = torch.einsum("oij,oj->oi", R, lm_pos[data.obs_lm]) + t
    uv, _ = cam_base.project(camera, pc)
    r_uv = cam_base.uv_residual(camera, uv, data.obs_uv)
    z = torch.where(torch.abs(pc[:, 2]) < 1e-9, torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
    r_xr = (uv[..., 0] - rdiv(camera.focal_x_baseline, z)) - data.obs_xr
    chi2 = torch.sum(r_uv * r_uv, -1) * data.obs_info + torch.where(
        has_stereo, r_xr * r_xr * data.obs_info, 0.0)
    delta_sq = torch.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D).to(torch.float32)
    w = torch.where(cam_base.cheirality(camera, pc),
                    robust.huber_weight(chi2, delta_sq) * data.obs_info, 0.0)

    iz = 1.0 / z
    iz2 = iz * iz
    J_uv_pc = cam_base.project_jacobian(camera, pc)
    J_xr_pc = torch.stack([camera.fx * iz, torch.zeros_like(z),
                           -camera.fx * pc[:, 0] * iz2 + camera.focal_x_baseline * iz2], -1)
    eye3 = torch.eye(3, dtype=pc.dtype, device=pc.device)
    dpc = torch.cat([eye3.expand(pc.shape[0], 3, 3), -lie.hat(pc)], dim=-1)
    Jc2 = J_uv_pc @ dpc
    Jl2 = J_uv_pc @ R
    Jc3 = (J_xr_pc[:, None, :] @ dpc)[:, 0]
    Jl3 = (J_xr_pc[:, None, :] @ R)[:, 0]
    w_st = torch.where(has_stereo, w, 0.0)
    Jc2w = Jc2 * w[:, None, None]
    Jl2w = Jl2 * w[:, None, None]
    Jc3w = Jc3 * w_st[:, None]
    Jl3w = Jl3 * w_st[:, None]

    Hcc_o = torch.einsum("ori,orj->oij", Jc2w, Jc2) + torch.einsum("oi,oj->oij", Jc3w, Jc3)
    Hll_o = torch.einsum("ori,orj->oij", Jl2w, Jl2) + torch.einsum("oi,oj->oij", Jl3w, Jl3)
    U_o = torch.einsum("ori,orj->oij", Jc2w, Jl2) + torch.einsum("oi,oj->oij", Jc3w, Jl3)
    bc_o = -(torch.einsum("ori,or->oi", Jc2w, r_uv) + Jc3 * (w_st * r_xr)[:, None])
    bl_o = -(torch.einsum("ori,or->oi", Jl2w, r_uv) + Jl3 * (w_st * r_xr)[:, None])

    Hcc = _segment_sum(data.obs_cam, Hcc_o, K)
    bc = _segment_sum(data.obs_cam, bc_o, K)
    Hll = _segment_sum(data.obs_lm, Hll_o, L)
    bl = _segment_sum(data.obs_lm, bl_o, L)
    lam_l = damping * torch.clamp(
        torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, min=1e-6)
    Hll_inv = torch.linalg.inv_ex(Hll + lam_l * eye3)[0]
    return U_o, Hcc, bc, Hll_inv, bl


def _schur_rhs(data, U_o, bc, Hll_inv, bl):
    """bc - sum_m W_m Hll_m^-1 bl_m, summed per observation."""
    K = bc.shape[0]
    UHinv = torch.einsum("oij,ojk->oik", U_o, Hll_inv[data.obs_lm])
    rhs_o = torch.einsum("oij,oj->oi", UHinv, bl[data.obs_lm])
    return bc - _segment_sum(data.obs_cam, rhs_o, K), UHinv


def _step(cam_pose, lm_pos, lm_valid, free, data, U_o, Hll_inv, bl, dx_c):
    """Back-substitute the landmarks (dX_m = Hll_m^-1 (bl_m - sum_o U_o^T
    dx_c(o))), reject a non-finite step, clamp and apply it."""
    L = lm_pos.shape[0]
    Ut_dxc = _segment_sum(data.obs_lm, torch.einsum("oij,oi->oj", U_o, dx_c[data.obs_cam]), L)
    dx_l = torch.einsum("lij,lj->li", Hll_inv, bl - Ut_dxc)
    ok = torch.isfinite(dx_c).all() & torch.isfinite(dx_l).all()
    zero = torch.zeros((), dtype=dx_c.dtype, device=dx_c.device)
    dx_c = torch.where(ok, lie.clamp_tangent(dx_c, 0.3, 5.0), zero)
    dx_l = torch.where(ok, torch.clamp(dx_l, -5.0, 5.0), zero)
    R_new, t_new = lie.se3_update(cam_pose[:, :, :3], cam_pose[:, :, 3], dx_c)
    cam_pose = torch.where(free[:, None, None], lie.pack_pose(R_new, t_new), cam_pose)
    lm_pos = torch.where(lm_valid[:, None], lm_pos + dx_l, lm_pos)
    return cam_pose, lm_pos


def _finish(cam_pose, cam_pose0, free):
    cam_pose = lie.pack_pose(lie.orthonormalize(cam_pose[:, :, :3]), cam_pose[:, :, 3])
    return torch.where(free[:, None, None], cam_pose, cam_pose0)


def solve(camera, cam_pose0, cam_valid, cam_fixed, lm_pos0, lm_valid, data: GlobalBAData, *,
          num_iters: int = 10, damping: float = 1e-4):
    """Global BA with the explicit reduced camera system and a dense
    Cholesky. Returns (cam_pose [K, 3, 4], lm_pos [L, 3])."""
    K = cam_pose0.shape[0]
    dev = cam_pose0.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    diag = torch.arange(K, device=dev)
    free = (~cam_fixed) & cam_valid
    free_f = free.to(torch.float32)
    c1 = data.obs_cam[data.pair_o1]
    c2 = data.obs_cam[data.pair_o2]
    lm_p = data.obs_lm[data.pair_o1]
    cam_pose, lm_pos = cam_pose0, lm_pos0
    for _ in range(num_iters):
        U_o, Hcc, bc, Hll_inv, bl = _normal_blocks(camera, cam_pose, lm_pos, data, damping)
        S_pair = -torch.einsum("pij,pjk,plk->pil", U_o[data.pair_o1], Hll_inv[lm_p],
                               U_o[data.pair_o2])
        S = torch.zeros((K, K, 6, 6), dtype=torch.float32, device=dev)
        S.index_put_((c1, c2), S_pair, accumulate=True)
        S[diag, diag] += Hcc
        rhs, _ = _schur_rhs(data, U_o, bc, Hll_inv, bl)

        S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
        S[diag, diag] += torch.where(free[:, None, None], 0.0, 1.0) * eye6
        tr = torch.diagonal(S[diag, diag], dim1=-2, dim2=-1).sum(-1)
        S[diag, diag] += (damping * torch.clamp(tr / 6.0, min=1e-6))[:, None, None] * eye6
        rhs = rhs * free_f[:, None]

        S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        L_chol, info = torch.linalg.cholesky_ex(S_dense)
        dx_c = torch.cholesky_solve(rhs.reshape(6 * K, 1), L_chol).reshape(K, 6)
        dx_c = torch.where(info == 0, dx_c, torch.nan)  # failed factor: drop the step
        cam_pose, lm_pos = _step(cam_pose, lm_pos, lm_valid, free, data, U_o, Hll_inv, bl, dx_c)
    return _finish(cam_pose, cam_pose0, free), lm_pos


def prepare_chain_pairs(data: GlobalBAData, kf_valid):
    """Co-observation pairs between CONSECUTIVE valid keyframes, the chain
    blocks of the Schur complement that the PCG preconditioner keeps.
    Returns (chain_o1, chain_o2, raw_of_comp) as numpy, with
    comp(cam(o2)) == comp(cam(o1)) + 1."""
    kf_valid = np.asarray(kf_valid)
    valid_ids = np.where(kf_valid)[0]
    K = len(kf_valid)
    comp_of_raw = np.full(K, -1, np.int64)
    comp_of_raw[valid_ids] = np.arange(len(valid_ids))
    raw_of_comp = np.full(K, -1, np.int64)
    raw_of_comp[:len(valid_ids)] = valid_ids
    obs_cam = data.obs_cam.cpu().numpy()
    o1, o2 = data.pair_o1.cpu().numpy(), data.pair_o2.cpu().numpy()
    sel = comp_of_raw[obs_cam[o2]] == comp_of_raw[obs_cam[o1]] + 1
    return o1[sel], o2[sel], raw_of_comp


def pad_chain_pairs(c1, c2):
    """Pad the chain-pair lists to a power-of-two bucket (>= 1024) with -1
    rows, which ``solve_pcg`` drops: the JAX package's one padding rule
    for every caller, kept so both packages see the same pair lists."""
    P = len(c1)
    P_pad = 1 << max(10, (max(P, 1) - 1).bit_length())
    pad = np.full(P_pad - P, -1, np.int64)
    return np.concatenate([c1, pad]), np.concatenate([c2, pad])


def solve_pcg(camera, cam_pose0, cam_valid, cam_fixed, lm_pos0, lm_valid, data: GlobalBAData,
              chain_o1, chain_o2, raw_of_comp, *, num_iters: int = 10, cg_iters: int = 40,
              damping: float = 1e-4):
    """Global BA with a matrix-free Schur solve for large K: per CG step

        S x = Hcc x - sum_o U_o Hll^-1_lm(o) (sum_{o'~lm(o)} U_o'^T x_c(o'))

    from the observation lists (no pair list, no ``[K, K]`` blocks),
    preconditioned by the exact chain part of S (``chain_o1/o2``; -1 rows
    are padding) solved by block cyclic reduction."""
    K, L = cam_pose0.shape[0], lm_pos0.shape[0]
    dev = cam_pose0.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    comp_ok = raw_of_comp >= 0
    comp_idx = torch.clamp(raw_of_comp, 0, K - 1)
    free = (~cam_fixed) & cam_valid
    free_f = free.to(torch.float32)
    # comp_of_cam: keyframe slot -> chain position.
    comp_of_cam = torch.zeros((K + 1,), dtype=torch.int64, device=dev)
    comp_of_cam[torch.where(comp_ok, comp_idx, K)] = torch.where(
        comp_ok, torch.arange(K, device=dev), 0)
    chain_pair_ok = chain_o1 >= 0
    O = data.obs_cam.shape[0]
    o1s = torch.clamp(chain_o1, 0, O - 1)
    o2s = torch.clamp(chain_o2, 0, O - 1)
    c_pos = torch.where(chain_pair_ok, comp_of_cam[data.obs_cam[o1s]], K)
    cam_pose, lm_pos = cam_pose0, lm_pos0
    for _ in range(num_iters):
        U_o, Hcc, bc, Hll_inv, bl = _normal_blocks(camera, cam_pose, lm_pos, data, damping)
        Hcc_d = Hcc + (damping * torch.clamp(
            torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1) / 6.0, min=1e-6))[:, None, None] * eye6
        rhs, UHinv = _schur_rhs(data, U_o, bc, Hll_inv, bl)
        rhs = rhs * free_f[:, None]

        def matvec(x):
            xf = x * free_f[:, None]
            g = _segment_sum(data.obs_lm, torch.einsum("oij,oi->oj", U_o, xf[data.obs_cam]), L)
            y_o = torch.einsum("oik,ok->oi", UHinv, g[data.obs_lm])
            y = torch.einsum("kij,kj->ki", Hcc_d, xf) - _segment_sum(data.obs_cam, y_o, K)
            return torch.where(free[:, None], y * free_f[:, None], x)

        # The block diagonal of S (self-pair terms) and the chain's
        # off-diagonal blocks, gated on both cameras free.
        D = Hcc_d - _segment_sum(data.obs_cam, torch.einsum("oik,ojk->oij", UHinv, U_o), K)
        D = torch.where(free[:, None, None], D, eye6)
        f12 = free_f[data.obs_cam[o1s]] * free_f[data.obs_cam[o2s]] * chain_pair_ok
        S_chain = -torch.einsum("pik,pjk->pij", UHinv[o1s], U_o[o2s]) * f12[:, None, None]
        C_t = _segment_sum(c_pos, S_chain, K + 1)[:K]
        precond = pg._chain_preconditioner(D, C_t, comp_idx, comp_ok)
        dx_c = pg.pcg(matvec, precond, rhs, cg_iters)
        cam_pose, lm_pos = _step(cam_pose, lm_pos, lm_valid, free, data, U_o, Hll_inv, bl, dx_c)
    return _finish(cam_pose, cam_pose0, free), lm_pos


def run_global_ba(camera, state, inv_sigma_sq_table, anchor_kf: int = 0,
                  num_iters: int = 10, mesh=None):
    """Prepare the index lists, solve (dense up to K = 512, PCG beyond) and
    write the poses and points back. ``mesh`` (a landmark-sharded solve
    over several devices) is not ported yet (ROADMAP A17)."""
    if mesh is not None:
        raise NotImplementedError("global BA over a device mesh is not ported yet (ROADMAP A17)")
    data = prepare(state, inv_sigma_sq_table)
    if data.num_obs < MIN_OBS:
        return state
    K = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    cam_fixed = torch.arange(K, device=dev) == anchor_kf
    if K > 512:
        c1, c2, raw_of_comp = prepare_chain_pairs(data, state.kf_valid.cpu().numpy())
        c1, c2 = pad_chain_pairs(c1, c2)
        cam_pose, lm_pos = solve_pcg(
            camera, state.kf_pose, state.kf_valid, cam_fixed, state.lm_pos, state.lm_valid,
            data, *(torch.from_numpy(a).to(dev) for a in (c1, c2, raw_of_comp)),
            num_iters=num_iters,
        )
    else:
        cam_pose, lm_pos = solve(camera, state.kf_pose, state.kf_valid, cam_fixed,
                                 state.lm_pos, state.lm_valid, data, num_iters=num_iters)
    return state._replace(kf_pose=cam_pose, lm_pos=lm_pos)
