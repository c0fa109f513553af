"""Full-map global bundle adjustment (pair-based sparse Schur).

Port of structure_plp_slam_tpu/models/global_ba.py (reference
optimize/global_bundle_adjuster.cc, the whole-map BA run after a loop
closure). The windowed solver's dense ``[M, C, 6, 3]`` coupling does not
scale to a whole map, so this one follows BA's sparsity:

  S = Hcc_diag - sum_m W_m Hll_m^-1 W_m^T

couples camera PAIRS that co-observe a landmark. The host enumerates the
observations and the observation pairs (o1, o2 on the same landmark) once
per run (numpy); per Gauss-Newton iteration the device computes the
per-observation Jacobian blocks, sums ``-U_o1 Hll^-1 U_o2^T`` over the
pair list into the block camera system ``[K, K, 6, 6]``, Cholesky-solves
it and back-substitutes the landmarks. ``solve_pcg`` applies the same
Schur operator matrix-free inside a PCG for large K. With a ``mesh`` of more than one landmark shard
:func:`run_global_ba` runs the landmark-sharded solve instead
(``parallel/distributed_ba``, :func:`_run_global_ba_sharded`). The JAX
package caches each mesh solve's jitted executable (``_DIST_BA_CACHE``);
eager torch has nothing to cache, so the port has no such cache.

Every sum by camera, landmark or camera pair is ``utils/types.segment_sum``:
on the CPU ``index_add_``, which adds in the indices' order; on the card
one fixed order, the same on every run, from summation plans built once
per solve (:func:`with_plans`), which leave the padding rows out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structure_plp_slam_tpu_torch.camera import base as cam_base
from structure_plp_slam_tpu_torch.models import pose_graph as pg
from structure_plp_slam_tpu_torch.ops import lie, linalg, robust
from structure_plp_slam_tpu_torch.utils.types import (SegmentPlan, rdiv, resolve_device,
                                                      segment_plan, segment_sum)

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
    # The card's summation plans over obs_cam, obs_lm and the pairs'
    # camera blocks (with_plans); without them each sum builds its own.
    cam_plan: SegmentPlan = None
    lm_plan: SegmentPlan = None
    pair_plan: SegmentPlan = None


def prepare(state, inv_sigma_sq_table, max_obs_per_lm: int = 12) -> GlobalBAData:
    """Enumerate observations and pairs from a MapState (reads it back to
    the host; the System's deferred BA uses :func:`prepare_from_arrays` on
    copies it started earlier)."""
    def host(t):
        return t.detach().cpu().numpy()

    return prepare_from_arrays(
        host(state.kf_valid), host(state.kf_kp_valid), host(state.kf_lm_idx),
        host(state.lm_valid), host(state.kf_xy), host(state.kf_xr), host(state.kf_level),
        host(torch.as_tensor(inv_sigma_sq_table)), max_obs_per_lm=max_obs_per_lm,
        device=state.kf_pose.device,
    )


def prepare_from_arrays(kf_valid, kp_valid, lm_idx, lm_valid, xy, xr, level, table,
                        max_obs_per_lm: int = 12, device=None) -> GlobalBAData:
    """Observations and co-observation pairs from host arrays (numpy).
    Only the first ``max_obs_per_lm`` observations of a landmark enter the
    pair list; all of them enter Hcc, Hll and b. The tensors go to
    ``device``: CUDA unless asked (``utils/types.resolve_device``)."""
    device = resolve_device(device)
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
        keep2 = rank < max_obs_per_lm
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


def _pair_ids(data, K):
    """Each pair's (cam(o1), cam(o2)) block of the ``[K, K]`` camera system."""
    return data.obs_cam[data.pair_o1] * K + data.obs_cam[data.pair_o2]


def with_plans(data: GlobalBAData, K: int, L: int, live=None, pair_valid=None) -> GlobalBAData:
    """``data`` with its summation plans for ``K`` cameras and ``L``
    landmarks (``utils/types.segment_plan``; none on the CPU). ``live`` /
    ``pair_valid``: the observations and pairs that may add something (by
    default the first ``num_obs`` / ``num_pairs``); the others weigh 0."""
    dev = data.obs_cam.device
    if live is None:
        live = torch.arange(data.obs_cam.shape[0], device=dev) < data.num_obs
    if pair_valid is None:
        pair_valid = torch.arange(data.pair_o1.shape[0], device=dev) < data.num_pairs
    return data._replace(cam_plan=segment_plan(data.obs_cam, K, keep=live),
                         lm_plan=segment_plan(data.obs_lm, L, keep=live),
                         pair_plan=segment_plan(_pair_ids(data, K), K * K, keep=pair_valid))


def _cam_sum(data, vals, K):
    return segment_sum(data.obs_cam, vals, K, plan=data.cam_plan)


def _lm_sum(data, vals, L):
    return segment_sum(data.obs_lm, vals, L, plan=data.lm_plan)


def _normal_blocks(camera, cam_pose, lm_pos, data: GlobalBAData, damping, live=None):
    """Per-observation camera-landmark blocks ``U_o [O, 6, 3]`` and the
    summed Hcc ``[K, 6, 6]``, bc ``[K, 6]``, damped Hll^-1 ``[L, 3, 3]``
    and bl ``[L, 3]`` at the current estimate. ``live`` (a landmark
    shard's observations): rows that are not live weigh 0."""
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
    front = cam_base.cheirality(camera, pc)
    w = torch.where(front if live is None else live & front,
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

    Hcc = _cam_sum(data, Hcc_o, K)
    bc = _cam_sum(data, bc_o, K)
    Hll = _lm_sum(data, Hll_o, L)
    bl = _lm_sum(data, bl_o, L)
    lam_l = damping * torch.clamp(
        torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, min=1e-6)
    Hll_inv = linalg.inv(Hll + lam_l * eye3)
    return U_o, Hcc, bc, Hll_inv, bl


def _schur_reduction(data, U_o, Hll_inv, bl, K):
    """sum_m W_m Hll_m^-1 bl_m per camera, summed per observation (the
    Schur right-hand side is bc minus it), and ``U_o Hll^-1 [O, 6, 3]``."""
    UHinv = torch.einsum("oij,ojk->oik", U_o, Hll_inv[data.obs_lm])
    rhs_o = torch.einsum("oij,oj->oi", UHinv, bl[data.obs_lm])
    return _cam_sum(data, rhs_o, K), UHinv


def _pair_blocks(data, U_o, Hll_inv, K, pair_valid=None):
    """sum over the pair list of U_o1 Hll^-1 U_o2^T into the (cam(o1),
    cam(o2)) blocks of ``[K, K, 6, 6]``; the reduced camera system is Hcc
    on the diagonal minus it. Pairs where ``pair_valid`` is False add 0."""
    S_pair = torch.einsum("pij,pjk,plk->pil", U_o[data.pair_o1],
                          Hll_inv[data.obs_lm[data.pair_o1]], U_o[data.pair_o2])
    if pair_valid is not None:
        S_pair = torch.where(pair_valid[:, None, None], S_pair, 0.0)
    return segment_sum(_pair_ids(data, K), S_pair, K * K,
                       plan=data.pair_plan).reshape(K, K, 6, 6)


def _camera_solve(S_red, Hcc, rhs, free, damping):
    """The camera step from the reduced system S = diag(Hcc) - S_red:
    fixed and invalid cameras get identity rows and a zero right-hand
    side, the diagonal is damped, and a dense Cholesky solves it. A
    failed factor gives NaN (the step is then dropped)."""
    K = Hcc.shape[0]
    eye6 = torch.eye(6, dtype=torch.float32, device=Hcc.device)
    diag = torch.arange(K, device=Hcc.device)
    free_f = free.to(torch.float32)
    S = -S_red
    S[diag, diag] += Hcc
    S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
    S[diag, diag] += torch.where(free[:, None, None], 0.0, 1.0) * eye6
    tr = torch.diagonal(S[diag, diag], dim1=-2, dim2=-1).sum(-1)
    S[diag, diag] += (damping * torch.clamp(tr / 6.0, min=1e-6))[:, None, None] * eye6
    rhs = rhs * free_f[:, None]
    return linalg.block_cholesky_solve(S, rhs)


def _damped(Hcc, damping):
    """Hcc with each diagonal block raised by damping * max(trace / 6, 1e-6)."""
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    tr = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    return Hcc + (damping * torch.clamp(tr / 6.0, min=1e-6))[:, None, None] * eye6


def _offdiag_product(data, U_o, UHinv, xf, L, K):
    """sum_o U_o Hll^-1_lm(o) (sum_{o'~lm(o)} U_o'^T xf_c(o')) per camera:
    the part of the Schur product S xf that Hcc does not give."""
    g = _lm_sum(data, torch.einsum("oij,oi->oj", U_o, xf[data.obs_cam]), L)
    return _cam_sum(data, torch.einsum("oik,ok->oi", UHinv, g[data.obs_lm]), K)


def _apply_reduced(Hcc_d, x, offdiag, free):
    """S x from its off-diagonal part on the free cameras; x itself on the
    others (their rows are identity)."""
    f = free.to(torch.float32)[:, None]
    return torch.where(free[:, None], (torch.einsum("kij,kj->ki", Hcc_d, x * f) - offdiag) * f,
                       x)


def _self_blocks(data, U_o, UHinv, K):
    """The self-pair terms sum_o U_o Hll^-1 U_o^T per camera: S's block
    diagonal is the damped Hcc minus them."""
    return _cam_sum(data, torch.einsum("oik,ojk->oij", UHinv, U_o), K)


def _chain_ids(chain_o1, chain_pos, K):
    """Each chain pair's bin: its position, or K (dropped) for a padding
    row (o1 < 0) or a position of K or beyond."""
    return torch.where((chain_o1 >= 0) & (chain_pos < K), chain_pos, K)


def chain_plan(chain_o1, chain_pos, K):
    """The card's summation plan of :func:`_chain_blocks` (none on the CPU)."""
    ids = _chain_ids(chain_o1, chain_pos, K)
    return segment_plan(ids, K + 1, keep=ids < K)


def _chain_blocks(data, U_o, UHinv, free_f, chain_o1, chain_o2, chain_pos, K, plan=None):
    """The chain couplings ``[K, 6, 6]`` of the PCG preconditioner: each
    chain pair's -U_o1 Hll^-1 U_o2^T (zero unless both cameras are free)
    summed at its position; a padding row (o1 < 0) or a position of K or
    beyond adds nothing (a K + 1 buffer, cut). ``plan``: from
    :func:`chain_plan`."""
    O = data.obs_cam.shape[0]
    ok = chain_o1 >= 0
    o1s, o2s = torch.clamp(chain_o1, 0, O - 1), torch.clamp(chain_o2, 0, O - 1)
    f12 = free_f[data.obs_cam[o1s]] * free_f[data.obs_cam[o2s]] * ok
    S_chain = -torch.einsum("pik,pjk->pij", UHinv[o1s], U_o[o2s]) * f12[:, None, None]
    return segment_sum(_chain_ids(chain_o1, chain_pos, K), S_chain, K + 1, plan=plan)[:K]


def _step(cam_pose, lm_pos, lm_valid, free, data, U_o, Hll_inv, bl, dx_c):
    """Back-substitute the landmarks (dX_m = Hll_m^-1 (bl_m - sum_o U_o^T
    dx_c(o))), reject a non-finite step, clamp and apply it."""
    L = lm_pos.shape[0]
    Ut_dxc = _lm_sum(data, torch.einsum("oij,oi->oj", U_o, dx_c[data.obs_cam]), L)
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
    free = (~cam_fixed) & cam_valid
    data = with_plans(data, K, lm_pos0.shape[0])
    cam_pose, lm_pos = cam_pose0, lm_pos0
    for _ in range(num_iters):
        U_o, Hcc, bc, Hll_inv, bl = _normal_blocks(camera, cam_pose, lm_pos, data, damping)
        S_red = _pair_blocks(data, U_o, Hll_inv, K)
        rhs_red, _ = _schur_reduction(data, U_o, Hll_inv, bl, K)
        dx_c = _camera_solve(S_red, Hcc, bc - rhs_red, free, damping)
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


def chain_positions(obs_cam, chain_o1, raw_of_comp):
    """Each chain pair's chain position, that of its first keyframe
    (``comp_of_cam[obs_cam[o1]]``): where the PCG preconditioner sums its
    block. Padding rows (o1 < 0) and pairs whose first keyframe is on no
    chain get K, which ``_chain_blocks`` drops."""
    K = raw_of_comp.shape[0]
    dev = raw_of_comp.device
    comp_ok = raw_of_comp >= 0
    comp_of_cam = torch.full((K + 1,), K, dtype=torch.int64, device=dev)
    comp_of_cam[torch.where(comp_ok, raw_of_comp, K)] = torch.where(
        comp_ok, torch.arange(K, device=dev), K)
    pos = comp_of_cam[obs_cam[torch.clamp(chain_o1, 0, obs_cam.shape[0] - 1)]]
    return torch.where(chain_o1 >= 0, pos, K)


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
    chain_pos = chain_positions(data.obs_cam, chain_o1, raw_of_comp)
    c_plan = chain_plan(chain_o1, chain_pos, K)
    data = with_plans(data, K, L)
    cam_pose, lm_pos = cam_pose0, lm_pos0
    for _ in range(num_iters):
        U_o, Hcc, bc, Hll_inv, bl = _normal_blocks(camera, cam_pose, lm_pos, data, damping)
        Hcc_d = _damped(Hcc, damping)
        rhs_red, UHinv = _schur_reduction(data, U_o, Hll_inv, bl, K)
        rhs = (bc - rhs_red) * free_f[:, None]

        def matvec(x):
            return _apply_reduced(
                Hcc_d, x, _offdiag_product(data, U_o, UHinv, x * free_f[:, None], L, K), free)

        D = torch.where(free[:, None, None], Hcc_d - _self_blocks(data, U_o, UHinv, K), eye6)
        C_t = _chain_blocks(data, U_o, UHinv, free_f, chain_o1, chain_o2, chain_pos, K,
                            plan=c_plan)
        precond = pg._chain_preconditioner(D, C_t, comp_idx, comp_ok)
        dx_c = pg.pcg(matvec, precond, rhs, cg_iters)
        cam_pose, lm_pos = _step(cam_pose, lm_pos, lm_valid, free, data, U_o, Hll_inv, bl, dx_c)
    return _finish(cam_pose, cam_pose0, free), lm_pos


def run_global_ba(camera, state, inv_sigma_sq_table, anchor_kf: int = 0,
                  num_iters: int = 10, mesh=None):
    """Prepare the index lists, solve (dense up to K = 512, PCG beyond) and
    write the poses and points back. ``mesh``: a
    :class:`~structure_plp_slam_tpu_torch.parallel.distributed_ba.LandmarkMesh`;
    with more than one shard the solve runs landmark-sharded over it (one
    reduction of the camera system per iteration), else on the map's
    device."""
    data = prepare(state, inv_sigma_sq_table)
    if data.num_obs < MIN_OBS:
        return state
    K = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    cam_fixed = torch.arange(K, device=dev) == anchor_kf
    if mesh is not None and mesh.n_shards > 1:
        return _run_global_ba_sharded(camera, state, data, cam_fixed, mesh, num_iters)
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


def _run_global_ba_sharded(camera, state, data: GlobalBAData, cam_fixed, mesh, num_iters: int):
    """Full-map BA over a landmark mesh: pack the prepared observation
    lists into a BAProblem (a power-of-two bucket of at least 1024 rows,
    the JAX package's; the pads name landmark 0, so they all land on shard
    0), landmark-shard it, run the sharded solve (dense up to K = 512,
    matrix-free PCG beyond) and undo the block-cyclic landmark layout on
    the device."""
    from structure_plp_slam_tpu_torch.models.bundle_adjustment import BAProblem
    from structure_plp_slam_tpu_torch.parallel import distributed_ba as dba

    n = mesh.n_shards
    dev0 = mesh.devices[0]
    O = int(data.num_obs)
    # prepare_from_arrays pads to a bucket at least this large, with the
    # JAX package's pad values (camera 0, landmark 0, x_r -1, weight 0).
    O_pad = 1 << max(10, (O - 1).bit_length())
    prob = BAProblem(
        cam_pose=state.kf_pose, cam_fixed=cam_fixed, cam_valid=state.kf_valid,
        lm_pos=state.lm_pos, lm_valid=state.lm_valid,
        obs_cam=data.obs_cam[:O_pad], obs_lm=data.obs_lm[:O_pad], obs_uv=data.obs_uv[:O_pad],
        obs_xr=data.obs_xr[:O_pad], obs_inv_sigma_sq=data.obs_info[:O_pad],
        obs_valid=torch.arange(O_pad) < O,
    )
    K = state.kf_pose.shape[0]
    if K > 512:
        sp, obs_map = dba.shard_problem(prob, n, return_map=True, device=dev0)
        c1, c2, raw_of_comp = prepare_chain_pairs(data, state.kf_valid.cpu().numpy())
        pos = chain_positions(data.obs_cam.cpu(), torch.from_numpy(c1),
                              torch.from_numpy(raw_of_comp))
        chain = dba.shard_chain_pairs(c1, c2, obs_map, n, pos.numpy(), device=dev0)
        comp_ok = torch.from_numpy(raw_of_comp >= 0).to(dev0)
        comp_idx = torch.from_numpy(np.clip(raw_of_comp, 0, K - 1)).to(dev0)
        run = dba.make_distributed_ba_pcg(mesh, camera, num_iters=num_iters)
        cam_pose, lm_flat = run(sp, *chain, comp_idx, comp_ok)
    else:
        sp = dba.shard_problem(prob, n, device=dev0)
        cam_pose, lm_flat = dba.make_distributed_ba(mesh, camera, num_iters=num_iters)(sp)
    # Landmark m lives on shard m % n at slot m // n.
    dev = state.kf_pose.device
    m = torch.arange(state.lm_pos.shape[0], device=dev)
    lm_pos = lm_flat.to(dev)[(m % n) * (lm_flat.shape[0] // n) + m // n]
    cam_pose = torch.where(state.kf_valid[:, None, None], cam_pose.to(dev), state.kf_pose)
    lm_pos = torch.where(state.lm_valid[:, None], lm_pos, state.lm_pos)
    return state._replace(kf_pose=cam_pose, lm_pos=lm_pos)
