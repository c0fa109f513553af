"""Batched-hypothesis RANSAC solvers: essential and homography.

Port of structure_plp_slam_tpu/ops/ransac.py (reference solve/
essential_solver.cc, homography_solver.cc and the GC-RANSAC variants):
every hypothesis is generated and scored at once —

  sample S minimal sets -> batched SVD model fit [S, ...] ->
  score all S x N residuals in one pass -> argmax of the MSAC score.

The minimal sets come from ``utils/prng.choice_weighted``, bit-equal to
the JAX package's ``jax.random.choice`` draws for the same key. Pose
recovery from E (4 candidates) and H (8 Faugeras motions) triangulates
every correspondence under every candidate; the candidate with the most
cheirality- and parallax-consistent points wins.

Signs (ROADMAP C, trap "SVD and eigh signs"): every score and residual
here is invariant to the signs of the SVD's and eigh's vectors, and H is
normalized by H[2, 2], since the card's cuSOLVER picks its own signs. On
the CPU the factorizations are LAPACK's (``ops/linalg``), which XLA:CPU
calls, so the signs there are the JAX package's own.
"""

from __future__ import annotations

import math

import torch

from structure_plp_slam_tpu_torch.ops import linalg as _linalg
from structure_plp_slam_tpu_torch.ops import triangulation
from structure_plp_slam_tpu_torch.utils import prng
from structure_plp_slam_tpu_torch.utils.types import rdiv, topk_stable

NUM_HYPOTHESES = 256  # minimal sets scored per RANSAC call (the default)
H_INLIER_THR = 11.98  # 2 * 5.99: two chi2-gated transfer errors at sigma = 1 (px^2)
# The coherent consensus (GC-RANSAC's stand-in) takes a k-NN graph size
# (num_neighbors, 8), mean-field sweeps (num_sweeps, 4) and the weight of
# the neighbours' vote (smoothness, 2.0). A triangulated point counts when
# both rays agree with its direction within reproj_cos (0.9998, the
# perspective init's; the equirectangular init passes cos(5 px /
# focal_like)) and the rays' parallax exceeds min_parallax_deg (1.0).


def sample_minimal_sets(key, num_sets: int, set_size: int, num_points: int, valid):
    """``[S, k]`` random indices drawn from the valid points (with
    replacement; a degenerate set scores 0, see :func:`distinct_sets`)."""
    p = valid.to(torch.float32)
    p = p / torch.clamp(torch.sum(p), min=1.0)
    return prng.choice_weighted(key, num_points, (num_sets, set_size), p)


def distinct_sets(idx):
    """``[S]``: whether each minimal set of ``idx [S, k]`` drew k distinct
    points. A repeated draw leaves the minimal solver's null space more
    than one-dimensional, and which vector of it the SVD returns differs
    between XLA, LAPACK and cuSOLVER; such a model can still win the race
    (ROADMAP C16). Its score is set to 0 here, as the JAX package's
    sampler docstring intends ("a degenerate set simply scores 0
    inliers"), which the JAX solvers do not enforce."""
    k = idx.shape[-1]
    return torch.sum(idx[..., :, None] == idx[..., None, :], dim=(-1, -2)) == k


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Essential matrix (8-point) on bearing vectors.
# ---------------------------------------------------------------------------


def _project_essential(E):
    """Closest essential matrix: singular values (s, s, 0)."""
    U, S, Vt = _linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S_new = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return _linalg.matmul(U, S_new[..., :, None] * Vt)


def essential_8pt(b1, b2):
    """Batched 8-point algorithm. ``b1, b2: [S, 8, 3]`` -> E ``[S, 3, 3]``
    with the rank-2 projection. Row 3i+j of the constraint is b2_i * b1_j."""
    A = torch.einsum("ski,skj->skij", b2, b1).reshape(*b1.shape[:-2], 8, 9)
    _, _, Vt = _linalg.svd(A, full_matrices=True)
    E = Vt[..., -1, :].reshape(*b1.shape[:-2], 3, 3)
    return _project_essential(E)


def epipolar_error_angular(E, b1, b2):
    """Squared angular epipolar residual per correspondence ``[..., N]``
    (symmetric form, essential_solver.cc check_inliers)."""
    Eb1 = torch.einsum("...ij,...nj->...ni", E, b1)
    Etb2 = torch.einsum("...ji,...nj->...ni", E, b2)
    num = torch.einsum("...ni,...ni->...n", b2, Eb1)
    d1 = torch.clamp(torch.sum(Eb1 * Eb1, dim=-1), min=1e-12)
    d2 = torch.clamp(torch.sum(Etb2 * Etb2, dim=-1), min=1e-12)
    return num * num * (1.0 / d1 + 1.0 / d2)


def _msac(err, valid, inlier_thr, idx):
    """Mask invalid points, score every hypothesis (0 for a set of
    ``idx`` that repeats a point), pick the best (first on ties, as
    ``jnp.argmax``)."""
    err = torch.where(valid[None, :], err, torch.full_like(err, math.inf))
    score = torch.sum(torch.clamp(inlier_thr - err, min=0.0), dim=-1)
    score = torch.where(distinct_sets(idx), score, torch.zeros_like(score))
    best = torch.argmax(score)
    return best, err[best], score[best]


def essential_ransac(b1, b2, valid, key, *, num_hypotheses: int = NUM_HYPOTHESES,
                     inlier_thr: float = 1e-6):
    """MSAC over ``num_hypotheses`` batched 8-point hypotheses. ``b1, b2:
    [N, 3]`` bearings. Returns (E [3,3], inlier_mask [N], score)."""
    N = b1.shape[0]
    idx = sample_minimal_sets(key, num_hypotheses, 8, N, valid)
    E = essential_8pt(b1[idx], b2[idx])
    best, err, score = _msac(epipolar_error_angular(E, b1[None], b2[None]), valid,
                             inlier_thr, idx)
    return E[best], (err <= inlier_thr) & valid, score


def _match_knn_graph(uv, valid, k: int):
    """k-NN graph over frame-1 keypoint image positions (the neighbourhood
    GC-RANSAC's smoothness term uses); lower index first on ties."""
    N = uv.shape[0]
    d2 = torch.sum((uv[:, None, :] - uv[None, :, :]) ** 2, dim=-1)
    inf = torch.full_like(d2, math.inf)
    d2 = torch.where(valid[None, :] & valid[:, None], d2, inf)
    d2 = d2 + torch.where(torch.eye(N, dtype=torch.bool, device=uv.device), inf,
                          torch.zeros_like(d2))
    neg, nbr = topk_stable(-d2, k)
    return nbr, torch.isfinite(-neg)


def _weighted_nullvec9(A, w):
    """Smallest eigenvector of A^T diag(w) A for ``[N, 9]`` design rows (the
    weighted DLT / 8-point refit)."""
    M = torch.einsum("ni,nj->ij", A * w[:, None], A)
    _, V = _linalg.eigh(M)
    return V[:, 0]


def _coherent_field(x, nbr, nbr_ok):
    votes = torch.where(nbr_ok, 2.0 * x[nbr] - 1.0, torch.zeros_like(nbr_ok, dtype=x.dtype))
    return torch.sum(votes, dim=1) / torch.clamp(torch.sum(nbr_ok, dim=1), min=1)


def _coherent_tail(err, x, valid, inlier_thr):
    inl = (x > 0.5) & (err <= 2.0 * inlier_thr) & valid
    masked = torch.where(valid, err, torch.full_like(err, math.inf))
    return inl, torch.sum(torch.clamp(inlier_thr - masked, min=0.0))


def essential_ransac_coherent(b1, b2, uv1, valid, key, *,
                              inlier_thr: float = 1e-6,
                              num_hypotheses: int = NUM_HYPOTHESES,
                              num_neighbors: int = 8,
                              num_sweeps: int = 4,
                              smoothness: float = 2.0):
    """Spatially coherent essential-matrix consensus: the MSAC seed, then
    mean-field smoothing of the inlier labels over the match k-NN graph
    alternating with a weighted 8-point refit (the reference's GC-RANSAC,
    initialize/perspective.cc:70-85)."""
    E, inl0, _ = essential_ransac(b1, b2, valid, key, num_hypotheses=num_hypotheses,
                                  inlier_thr=inlier_thr)
    nbr, nbr_ok = _match_knn_graph(uv1, valid, num_neighbors)
    tau = 0.5 * inlier_thr
    A = torch.einsum("ni,nj->nij", b2, b1).reshape(-1, 9)
    x = inl0.to(torch.float32)
    for _ in range(num_sweeps):
        err = epipolar_error_angular(E, b1, b2)
        unary = (inlier_thr - err) / tau
        x = torch.sigmoid(unary + smoothness * _coherent_field(x, nbr, nbr_ok))
        x = _where0(valid, x)
        E = _project_essential(_weighted_nullvec9(A, x).reshape(3, 3))
    inl, score = _coherent_tail(epipolar_error_angular(E, b1, b2), x, valid, inlier_thr)
    return E, inl, score


def decompose_essential(E):
    """E -> 4 candidate poses (R ``[4,3,3]``, t ``[4,3]`` unit norm)."""
    U, _, Vt = _linalg.svd(E)
    U = U * torch.sign(_linalg.det3(U))[..., None, None]
    Vt = Vt * torch.sign(_linalg.det3(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = _linalg.matmul(_linalg.matmul(U, W), Vt)
    R2 = _linalg.matmul(_linalg.matmul(U, W.T), Vt)
    t = U[..., :, 2]
    t = t / torch.clamp(_linalg.norm(t)[..., None], min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


# ---------------------------------------------------------------------------
# Homography (4-point DLT) on undistorted pixel coordinates.
# ---------------------------------------------------------------------------


def _normalize_pts(pts):
    """Hartley normalization. ``[..., N, 2]`` -> (normed, T [..., 3, 3]).
    On the CPU a minimal set's mean distance sums its four distances as
    XLA:CPU's vectorized row reduction does, ((0 + 2) + (1 + 3))."""
    mean = torch.mean(pts, dim=-2, keepdim=True)
    if pts.device.type == "cpu" and pts.shape[-2] == 4:
        n = _linalg.norm(pts - mean)
        d = ((n[..., 0] + n[..., 2]) + (n[..., 1] + n[..., 3])) * 0.25
    else:
        d = torch.mean(torch.linalg.norm(pts - mean, dim=-1), dim=-1)
    s = rdiv(math.sqrt(2.0), torch.clamp(d, min=1e-9))
    normed = (pts - mean) * s[..., None, None]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zeros, -s * mean[..., 0, 0]], -1),
            torch.stack([zeros, s, -s * mean[..., 0, 1]], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        dim=-2,
    )
    return normed, T


def _dlt_rows(p, q):
    """The two DLT rows per correspondence p -> q: ``[..., 2N, 9]``."""
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    return torch.cat([r1, r2], dim=-2)


def _normalize_h(H):
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)


def homography_4pt(p1, p2):
    """Batched DLT homography. ``p1, p2: [S, 4, 2]`` -> H ``[S, 3, 3]``
    with H p1 ~ p2."""
    n1, T1 = _normalize_pts(p1)
    n2, T2 = _normalize_pts(p2)
    _, _, Vt = _linalg.svd(_dlt_rows(n1, n2), full_matrices=True)
    Hn = Vt[..., -1, :].reshape(*p1.shape[:-2], 3, 3)
    return _normalize_h(_linalg.matmul(_linalg.matmul(_linalg.inv3x3(T2), Hn), T1))


def homography_transfer_error(H, p1, p2):
    """Symmetric transfer error (squared px) ``[..., N]``."""

    def fwd(H, p, q):
        ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
        Hp = torch.einsum("...ij,...nj->...ni", H, ph)
        w = Hp[..., 2:3]
        w = torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)
        return torch.sum((Hp[..., :2] / w - q) ** 2, dim=-1)

    return fwd(H, p1, p2) + fwd(_linalg.inv3x3(H), p2, p1)


def homography_ransac(p1, p2, valid, key, *, num_hypotheses: int = NUM_HYPOTHESES,
                      inlier_thr: float = H_INLIER_THR):
    """MSAC over ``num_hypotheses`` batched 4-point homographies on pixel
    coordinates (inliers within ``inlier_thr``, 2 * 5.99 px^2). Returns
    (H [3,3], inliers [N], score)."""
    N = p1.shape[0]
    idx = sample_minimal_sets(key, num_hypotheses, 4, N, valid)
    H = homography_4pt(p1[idx], p2[idx])
    best, err, score = _msac(homography_transfer_error(H, p1[None], p2[None]), valid,
                             inlier_thr, idx)
    return H[best], (err <= inlier_thr) & valid, score


def homography_ransac_coherent(p1, p2, valid, key, *,
                               inlier_thr: float = H_INLIER_THR,
                               num_hypotheses: int = NUM_HYPOTHESES,
                               num_neighbors: int = 8,
                               num_sweeps: int = 4,
                               smoothness: float = 2.0):
    """Spatially coherent homography consensus (see
    :func:`essential_ransac_coherent`); weighted-DLT refit."""
    H, inl0, _ = homography_ransac(p1, p2, valid, key, num_hypotheses=num_hypotheses,
                                   inlier_thr=inlier_thr)
    nbr, nbr_ok = _match_knn_graph(p1, valid, num_neighbors)
    tau = 0.5 * inlier_thr
    p1n, T1 = _normalize_pts(p1)
    p2n, T2 = _normalize_pts(p2)
    A = _dlt_rows(p1n, p2n)
    T2_inv = _linalg.inv3x3(T2)
    x = inl0.to(torch.float32)
    for _ in range(num_sweeps):
        err = homography_transfer_error(H, p1, p2)
        unary = (inlier_thr - err) / tau
        x = torch.sigmoid(unary + smoothness * _coherent_field(x, nbr, nbr_ok))
        x = _where0(valid, x)
        Hn = _weighted_nullvec9(A, torch.cat([x, x])).reshape(3, 3)
        H = _normalize_h(_linalg.matmul(_linalg.matmul(T2_inv, Hn), T1))
    inl, score = _coherent_tail(homography_transfer_error(H, p1, p2), x, valid, inlier_thr)
    return H, inl, score


def _inv3x3_folded(K):
    """``linalg.inv3x3(K)`` with every op rounded: K is a constant of the
    JAX package's jitted init, and XLA folds a constant's inverse at
    compile time without fusing products into multiply-adds, so on the
    CPU the camera matrix's inverse is the adjugate's plain arithmetic."""
    a, b, c = K[0, 0], K[0, 1], K[0, 2]
    d, e, f = K[1, 0], K[1, 1], K[1, 2]
    g, h, i = K[2, 0], K[2, 1], K[2, 2]
    A, B, Cc = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * Cc
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([torch.stack([A, -(b * i - c * h), b * f - c * e]),
                       torch.stack([B, a * i - c * g, -(a * f - c * d)]),
                       torch.stack([Cc, -(a * h - b * g), a * e - b * d])])
    return adj * inv_det


def decompose_homography(H, K):
    """H (pixel frame) -> 8 candidate (R, t) motions by Faugeras' SVD
    method (initialize/perspective.cc reconstruct_with_H). Returns
    (R [8,3,3], t [8,3]); t is unit norm."""
    A = _linalg.matmul(_linalg.matmul(_inv3x3_folded(K), H), K)
    U, S, Vt = _linalg.svd(A)
    s = _linalg.det3(U) * _linalg.det3(Vt)
    d1, d2, d3 = S[0], S[1], S[2]

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)

    def root(x):
        return _linalg.sqrt(torch.clamp(x, min=0.0))

    # Each difference or sum of two products fuses one of them on the CPU,
    # as XLA:CPU compiles each of these values: a square that two terms
    # share is rounded first.
    fma, fms = _linalg.fma, _linalg.fms
    d1sq, d2sq, d3sq = d1 * d1, d2 * d2, d3 * d3
    x1m = root(fma(-d2, d2, d1sq) / safe(fma(-d3, d3, d1sq)))
    x3m = root(fms(d2, d2, d3sq) / safe(fms(d1, d1, d3sq)))
    prod = root(fms(d1, d1, d2sq) * fma(-d3, d3, d2sq))
    # d' = +d2: rotation about y by theta.
    aux_st = prod / safe((d1 + d3) * d2)
    ct = fma(d1, d3, d2sq) / safe((d1 + d3) * d2)
    # d' = -d2: rotation by phi with a reflection.
    aux_sp = prod / safe((d1 - d3) * d2)
    cp = fms(d1, d3, d2sq) / safe((d1 - d3) * d2)

    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * aux_st
            Rp = torch.stack([torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]),
                              torch.stack([st, zero, ct])])
            tp = (d1 - d3) * torch.stack([e1 * x1m, zero, -e3 * x3m])
            Rs.append(_linalg.matmul(_linalg.matmul(s * U, Rp), Vt))
            ts.append(_linalg.matmul(U, tp[:, None])[:, 0])
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * aux_sp
            Rp = torch.stack([torch.stack([cp, zero, sp]), torch.stack([zero, -one, zero]),
                              torch.stack([sp, zero, -cp])])
            tp = (d1 + d3) * torch.stack([e1 * x1m, zero, e3 * x3m])
            Rs.append(_linalg.matmul(_linalg.matmul(s * U, Rp), Vt))
            ts.append(_linalg.matmul(U, tp[:, None])[:, 0])
    ts = torch.stack(ts)
    ts = ts / torch.clamp(_linalg.norm(ts)[..., None], min=1e-12)
    return torch.stack(Rs), ts


# ---------------------------------------------------------------------------
# Pose selection by cheirality.
# ---------------------------------------------------------------------------


def _dircos(p, b):
    d = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-12)
    return torch.sum(d * b, dim=-1)


def select_pose_by_cheirality(Rs, ts, b1, b2, valid, *,
                              min_parallax_deg: float = 1.0,
                              spherical: bool = False,
                              reproj_cos: float = 0.9998):
    """Pick the (R, t) candidate with the most valid triangulations.

    ``Rs [C,3,3], ts [C,3]``: candidate poses of camera 2 wrt camera 1
    (x2 = R x1 + t); ``b1, b2 [N, 3]`` bearings; ``valid [N]``. A point
    counts when it lies in front of both cameras, both rays agree with
    its direction within ``reproj_cos`` and the ray parallax exceeds
    ``min_parallax_deg`` (initialize/base.cc check_pose). ``spherical``
    (full-sphere bearings, equirectangular): points behind the camera are
    observable, so "in front" is along the ray (point . bearing > 0) in
    both cameras instead of z > 0 (initialize/bearing_vector.cc).
    Returns (R, t, points_c1 [N,3], good_mask [N], num_good); the first
    candidate wins a tie."""
    max_cos = math.cos(math.radians(min_parallax_deg))
    pts_all, good_all = [], []
    for c in range(Rs.shape[0]):
        R, t = Rs[c], ts[c]
        pts = triangulation.triangulate_dlt(b1, b2, R, t)
        pts_c2 = pts @ R.T + t
        if spherical:
            depth_ok = ((torch.sum(pts * b1, dim=-1) > 1e-6)
                        & (torch.sum(pts_c2 * b2, dim=-1) > 1e-6))
        else:
            depth_ok = (pts[:, 2] > 1e-6) & (pts_c2[:, 2] > 1e-6)
        reproj_ok = (_dircos(pts, b1) > reproj_cos) & (_dircos(pts_c2, b2) > reproj_cos)
        parallax_ok = torch.sum((b1 @ R.T) * b2, dim=-1) < max_cos
        pts_all.append(pts)
        good_all.append(depth_ok & reproj_ok & parallax_ok & valid)
    pts_all = torch.stack(pts_all)
    good_all = torch.stack(good_all)
    counts = torch.sum(good_all, dim=-1)
    best = torch.argmax(counts)
    return Rs[best], ts[best], pts_all[best], good_all[best], counts[best]
