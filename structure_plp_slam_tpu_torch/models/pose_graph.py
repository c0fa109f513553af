"""Sim3 pose-graph ("essential graph") optimization and Sim3 corrections.

Port of structure_plp_slam_tpu/models/pose_graph.py (reference
optimize/graph_optimizer.cc: a g2o Sim3 pose graph over the spanning tree,
loop edges and strong covisibility edges). Up to a few hundred keyframes
the normal system ``[7K, 7K]`` is dense: per-edge Jacobian blocks come
from ``torch.func.vmap(torch.func.jacfwd(...))`` of the Sim3 residual, are
scattered into ``[K, K, 7, 7]`` blocks (``index_put_(accumulate=True)``)
and one Cholesky solves the graph per Gauss-Newton step. Beyond that,
``optimize_pose_graph_pcg`` runs matrix-free PCG with the chain part of
the Hessian as a block-tridiagonal preconditioner, solved by block cyclic
reduction.

Edge residual (g2o's sim3 edge): for a measurement S_ji (pose of i in j
when the edge was made) and variables S_i, S_j (world->camera Sim3s),
``r = log_sim3(S_ji^-1 ∘ S_j ∘ S_i^-1)`` in R^7.

The correction helpers (``correct_*``) move landmarks, lines and planes
through their reference keyframes' Sim3 deltas.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_plp_slam_tpu_torch.ops import lie, linalg


class PoseGraphProblem(NamedTuple):
    # Variables: world->camera Sim3 per keyframe.
    R: torch.Tensor            # [K, 3, 3]
    t: torch.Tensor            # [K, 3]
    s: torch.Tensor            # [K]
    fixed: torch.Tensor        # [K] bool (the loop keyframe anchors the graph)
    valid: torch.Tensor        # [K] bool
    # Edges.
    edge_i: torch.Tensor       # [E] i64
    edge_j: torch.Tensor       # [E] i64
    edge_R: torch.Tensor       # [E, 3, 3] measured S_ji rotation
    edge_t: torch.Tensor       # [E, 3]
    edge_s: torch.Tensor       # [E]
    edge_valid: torch.Tensor   # [E] bool
    edge_weight: torch.Tensor  # [E] f32


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, xi_i, xi_j):
    """The residual under left-multiplied perturbations exp(xi) of each
    variable (xi = 0 at the linearization point)."""
    Ri2, ti2, si2 = lie.sim3_compose(*lie.sim3_exp(xi_i), Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(*lie.sim3_exp(xi_j), Rj, tj, sj)
    Rji, tji, sji = lie.sim3_compose(Rj2, tj2, sj2, *lie.sim3_inverse(Ri2, ti2, si2))
    Re, te, se = lie.sim3_compose(*lie.sim3_inverse(Rm, tm, sm), Rji, tji, sji)
    return lie.sim3_log(Re, te, se)


def _residual_and_jacobians(prob: PoseGraphProblem, R, t, s):
    """Per edge: the residual ``[E, 7]`` and its Jacobians with respect to
    the perturbations of i and j ``[E, 7, 7]``: forward mode, one
    ``torch.func.jvp`` of the batched residual per tangent direction (the
    edges are independent, so direction k of every edge at once gives
    column k of every edge's Jacobian), the directions under
    ``torch.func.vmap``. (Per-edge ``jacfwd`` under ``vmap`` works on 0-d
    tensors, whose tangents torch promotes to f64 through ``torch.where``
    with a Python scalar.)"""
    ei, ej = prob.edge_i, prob.edge_j
    E = ei.shape[0]
    poses = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], prob.edge_R, prob.edge_t, prob.edge_s)
    zeros = torch.zeros((E, 7), dtype=t.dtype, device=t.device)
    dirs = torch.eye(7, dtype=t.dtype, device=t.device)[:, None, :].expand(7, E, 7)

    def res(xi, xj):
        return _edge_residual(*poses, xi, xj)

    r, Ji = torch.func.vmap(lambda v: torch.func.jvp(res, (zeros, zeros), (v, zeros)))(dirs)
    _, Jj = torch.func.vmap(lambda v: torch.func.jvp(res, (zeros, zeros), (zeros, v)))(dirs)
    return r[0], Ji.permute(1, 2, 0), Jj.permute(1, 2, 0)


def _update(prob, R, t, s, dx, free):
    """Apply the step (zero if any entry is not finite) to the free
    keyframes."""
    dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
    R2, t2, s2 = lie.sim3_compose(*lie.sim3_exp(dx), R, t, s)
    return (torch.where(free[:, None, None], R2, R), torch.where(free[:, None], t2, t),
            torch.where(free, s2, s))


def optimize_pose_graph(prob: PoseGraphProblem, *, num_iters: int = 20,
                        damping: float = 1e-6):
    """Gauss-Newton on the Sim3 pose graph with a dense Cholesky per step.
    Returns (R, t, s, chi2 of the last linearization)."""
    K = prob.R.shape[0]
    dev = prob.t.device
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    diag = torch.arange(K, device=dev)
    free = prob.valid & ~prob.fixed
    free_f = free.to(torch.float32)
    ei, ej = prob.edge_i, prob.edge_j
    R, t, s = prob.R, prob.t, prob.s
    chi2 = None
    for _ in range(num_iters):
        r, Ji, Jj = _residual_and_jacobians(prob, R, t, s)
        w = torch.where(prob.edge_valid, prob.edge_weight, 0.0)
        JiT_w = Ji * w[:, None, None]
        JjT_w = Jj * w[:, None, None]
        H = torch.zeros((K, K, 7, 7), dtype=torch.float32, device=dev)
        H.index_put_((ei, ei), torch.einsum("eri,erj->eij", JiT_w, Ji), accumulate=True)
        H.index_put_((ej, ej), torch.einsum("eri,erj->eij", JjT_w, Jj), accumulate=True)
        H.index_put_((ei, ej), torch.einsum("eri,erj->eij", JiT_w, Jj), accumulate=True)
        H.index_put_((ej, ei), torch.einsum("eri,erj->eij", JjT_w, Ji), accumulate=True)
        b = torch.zeros((K, 7), dtype=torch.float32, device=dev)
        b.index_put_((ei,), -torch.einsum("eri,er->ei", JiT_w, r), accumulate=True)
        b.index_put_((ej,), -torch.einsum("eri,er->ei", JjT_w, r), accumulate=True)

        H = H * free_f[:, None, None, None] * free_f[None, :, None, None]
        H[diag, diag] += torch.where(free[:, None, None], 0.0, 1.0) * eye7
        tr = torch.diagonal(H[diag, diag], dim1=-2, dim2=-1).sum(-1)
        H[diag, diag] += (damping * torch.clamp(tr / 7.0, min=1e-6))[:, None, None] * eye7
        b = b * free_f[:, None]

        # A failed factorization gives NaNs (as jax's cho_factor does); the
        # finite check in _update then drops the whole step.
        dx = linalg.block_cholesky_solve(H, b)
        R, t, s = _update(prob, R, t, s, dx, free)
        chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
    return R, t, s, chi2


# ---------------------------------------------------------------------------
# Large-K path: matrix-free PCG with a block-tridiagonal (chain)
# preconditioner solved by cyclic reduction.
# ---------------------------------------------------------------------------


def _shift_right(arr, fill):
    return torch.cat([fill[None], arr[:-1]], dim=0)


def _shift_left(arr, fill):
    return torch.cat([arr[1:], fill[None]], dim=0)


def _inv(A):
    """Batched inverse without the error check's host sync."""
    return linalg.inv(A)


def _bcr_factor(B, A, C):
    """Block-cyclic-reduction factorization of a block-tridiagonal matrix:
    ``B [n, d, d]`` diagonal blocks, ``A`` the (i, i-1) couplings (A[0]
    unused), ``C`` the (i, i+1) couplings (C[n-1] unused). A size that is
    not a power of two is padded with identity blocks and zero couplings
    (an independent identity system, so the leading solve is exact).
    log2(n) batched elimination levels; factor once, apply to many
    right-hand sides (:func:`_bcr_apply`)."""
    d = B.shape[-1]
    eyed = torch.eye(d, dtype=B.dtype, device=B.device)
    zerod = torch.zeros((d, d), dtype=B.dtype, device=B.device)
    n = B.shape[0]
    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        pad = n2 - n
        B = torch.cat([B, eyed.expand(pad, d, d)])
        A = torch.cat([A, zerod.expand(pad, d, d)])
        C = torch.cat([C, zerod.expand(pad, d, d)])
    levels = []
    while B.shape[0] > 1:
        B_e, B_o = B[0::2], B[1::2]
        A_e, A_o = A[0::2], A[1::2]
        C_e, C_o = C[0::2], C[1::2]
        A_o_prev = _shift_right(A_o, zerod)
        C_o_prev = _shift_right(C_o, zerod)
        inv_B_o = _inv(B_o)
        alpha = A_e @ _shift_right(inv_B_o, eyed)  # couples even i to odd i-1
        gamma = C_e @ inv_B_o                     # couples even i to odd i+1
        levels.append((alpha, gamma, inv_B_o, A_o, C_o))
        B = B_e - alpha @ C_o_prev - gamma @ A_o
        A = -alpha @ A_o_prev
        C = -gamma @ C_o
    return levels, _inv(B[0])


def _bcr_apply(factor, b):
    """Solve T x = b with ``factor`` from :func:`_bcr_factor`; a ``b``
    shorter than the factored size is zero-padded, the solution cut back."""
    levels, inv_B_root = factor
    n_in = b.shape[0]
    n_fac = 2 ** len(levels)
    if n_fac != n_in:
        b = torch.cat([b, b.new_zeros((n_fac - n_in, b.shape[-1]))])
    zerov = b.new_zeros((b.shape[-1],))
    rhs_stack = []
    for alpha, gamma, _, _, _ in levels:
        b_e, b_o = b[0::2], b[1::2]
        rhs_stack.append(b_o)
        b = (b_e - torch.einsum("nij,nj->ni", alpha, _shift_right(b_o, zerov))
             - torch.einsum("nij,nj->ni", gamma, b_o))
    x = (inv_B_root @ b[0])[None]
    for (_, _, inv_B_o, A_o, C_o), b_o in zip(reversed(levels), reversed(rhs_stack)):
        rhs = (b_o - torch.einsum("nij,nj->ni", A_o, x)
               - torch.einsum("nij,nj->ni", C_o, _shift_left(x, zerov)))
        x_o = torch.einsum("nij,nj->ni", inv_B_o, rhs)
        x = torch.stack([x, x_o], dim=1).reshape(-1, x.shape[-1])
    return x[:n_in]


def _chain_preconditioner(D, C_t, comp_idx, comp_ok):
    """The preconditioner z = T^-1 r in keyframe-slot space: T is the
    block-tridiagonal matrix in compacted (valid-order) space with the
    block diagonal ``D`` and chain couplings ``C_t``."""
    K, d = D.shape[0], D.shape[-1]
    eye = torch.eye(d, dtype=D.dtype, device=D.device)
    B_t = torch.where(comp_ok[:, None, None], D[comp_idx], eye)
    A_t = _shift_right(C_t.transpose(-1, -2), torch.zeros((d, d), dtype=D.dtype, device=D.device))
    factor = _bcr_factor(B_t, A_t, C_t)
    dst = torch.where(comp_ok, comp_idx, K)

    def precond(rv):
        zc = _bcr_apply(factor, rv[comp_idx] * comp_ok[:, None])
        z = rv.new_zeros((K + 1, d))
        z[dst] = torch.where(comp_ok[:, None], zc, 0.0)
        return z[:K]

    return precond


def _safe(v):
    return torch.where(torch.abs(v) < 1e-20, torch.ones_like(v), v)


def cg_start(precond, b):
    """The PCG state (x, r, p, r.z) before the first step, from 0."""
    z = precond(b)
    return torch.zeros_like(b), b, z, torch.sum(b * z)


def cg_step(x, rv, p, rz, Hp, precond):
    """One step of preconditioned conjugate gradients given ``Hp = A p``
    (the JAX package's scalar recurrence; a zero denominator is taken as
    1). Returns the next (x, r, p, r.z)."""
    a = rz / _safe(torch.sum(p * Hp))
    x = x + a * p
    rv = rv - a * Hp
    z = precond(rv)
    rz_new = torch.sum(rv * z)
    return x, rv, z + rz_new / _safe(rz) * p, rz_new


def pcg(matvec, precond, b, iters: int):
    """``iters`` steps of preconditioned conjugate gradients from 0 (the
    JAX package's fixed-count scan)."""
    x, rv, p, rz = cg_start(precond, b)
    for _ in range(iters):
        x, rv, p, rz = cg_step(x, rv, p, rz, matvec(p), precond)
    return x


def optimize_pose_graph_pcg(prob: PoseGraphProblem, raw_of_comp, edge_chain_pos, *,
                            num_iters: int = 20, cg_iters: int = 30, damping: float = 1e-6):
    """Pose-graph Gauss-Newton whose linear solves run matrix-free PCG
    instead of a dense ``[7K, 7K]`` Cholesky: memory stays O(K + E).
    ``raw_of_comp [K]`` maps chain position -> keyframe slot (-1 past the
    valid count); ``edge_chain_pos [E]`` is an edge's chain position (c
    for the edge linking positions c and c+1) or -1 for other edges."""
    K = prob.R.shape[0]
    dev = prob.t.device
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    free = prob.valid & ~prob.fixed
    free_f = free.to(torch.float32)
    comp_ok = raw_of_comp >= 0
    comp_idx = torch.clamp(raw_of_comp, 0, K - 1)
    chain_ok = edge_chain_pos >= 0
    chain_dst = torch.where(chain_ok, torch.clamp(edge_chain_pos, 0, K - 1), K)
    ei, ej = prob.edge_i, prob.edge_j
    R, t, s = prob.R, prob.t, prob.s
    chi2 = None
    for _ in range(num_iters):
        r, Ji, Jj = _residual_and_jacobians(prob, R, t, s)
        w = torch.where(prob.edge_valid, prob.edge_weight, 0.0)
        # Blocks touching fixed or invalid keyframes are zero (their rows
        # and columns are identity in the projected system).
        f_i, f_j = free_f[ei], free_f[ej]
        JiT_w = Ji * (w * f_i)[:, None, None]
        JjT_w = Jj * (w * f_j)[:, None, None]
        A_ii = torch.einsum("eri,erj->eij", JiT_w, Ji * f_i[:, None, None])
        A_jj = torch.einsum("eri,erj->eij", JjT_w, Jj * f_j[:, None, None])
        A_ij = torch.einsum("eri,erj->eij", JiT_w, Jj * f_j[:, None, None])

        b = torch.zeros((K, 7), dtype=torch.float32, device=dev)
        b.index_put_((ei,), -torch.einsum("eri,er->ei", JiT_w, r), accumulate=True)
        b.index_put_((ej,), -torch.einsum("eri,er->ei", JjT_w, r), accumulate=True)
        b = b * free_f[:, None]

        # The block diagonal (damping, and the preconditioner's diagonal).
        D = torch.zeros((K, 7, 7), dtype=torch.float32, device=dev)
        D.index_put_((ei,), A_ii, accumulate=True)
        D.index_put_((ej,), A_jj, accumulate=True)
        lam = damping * torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) / 7.0, min=1e-6)
        D = torch.where(free[:, None, None], D + lam[:, None, None] * eye7, eye7)

        def matvec(x):
            xf = x * free_f[:, None]
            y = torch.einsum("kij,kj->ki", D, xf)
            y = y.index_put((ei,), torch.einsum("eij,ej->ei", A_ij, xf[ej]), accumulate=True)
            y = y.index_put((ej,), torch.einsum("eji,ej->ei", A_ij, xf[ei]), accumulate=True)
            return torch.where(free[:, None], y, x)

        C_t = torch.zeros((K + 1, 7, 7), dtype=torch.float32, device=dev)
        C_t.index_put_((chain_dst,), torch.where(chain_ok[:, None, None], A_ij, 0.0),
                       accumulate=True)
        precond = _chain_preconditioner(D, C_t[:K], comp_idx, comp_ok)
        dx = pcg(matvec, precond, b, cg_iters)
        R, t, s = _update(prob, R, t, s, dx, free)
        chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
    return R, t, s, chi2


# ---------------------------------------------------------------------------
# Sim3 corrections of map structures through their reference keyframes.
# ---------------------------------------------------------------------------


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
