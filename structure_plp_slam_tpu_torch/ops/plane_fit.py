"""Plane fitting: weighted SVD fit and batched-hypothesis RANSAC.

Port of structure_plp_slam_tpu/ops/plane_fit.py (reference
planar_mapping_module.cc:412-591 sequential RANSAC, :735-771
estimate_plane_SVD, and the Graph-Cut RANSAC of :1006-1156, re-expressed
as mean-field label smoothing over a k-NN graph).

Every function takes one or several instances at once: ``valid`` is
``[N]`` or ``[I, N]`` over one shared point set ``[N, 3]`` and ``key`` is
``[2]`` or ``[I, 2]``, each instance drawing from its own key as the JAX
package's ``vmap`` does. ``fit_plane_svd`` takes the smallest eigenvector
of a 3x3 covariance, whose sign no library pins (LAPACK, cuSOLVER and XLA
may return ``-n``): every score here is invariant to it, stored
coefficients are equal up to a joint sign of (n, d) (ROADMAP C10).
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.ops import linalg
from structure_plp_slam_tpu_torch.ops.ransac import sample_minimal_sets
from structure_plp_slam_tpu_torch.utils.types import topk_stable

NUM_HYPOTHESES = 128
NUM_NEIGHBORS = 8
NUM_SWEEPS = 4
SMOOTHNESS = 2.0


def fit_plane_svd(points, weights):
    """Weighted total-least-squares plane through ``points [N, 3]`` with
    ``weights [..., N]``. Returns (n [..., 3] unit, d [...]) with
    n.x + d = 0 on the plane."""
    w = torch.clamp(weights, min=0.0)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu = torch.sum(points * w[..., None], dim=-2) / wsum[..., None]
    X = (points - mu[..., None, :]) * torch.sqrt(w)[..., None]
    cov = X.transpose(-1, -2) @ X
    _, eigvec = linalg.eigh(cov)
    n = eigvec[..., :, 0]  # smallest eigenvalue -> normal
    return n, -torch.sum(n * mu, dim=-1)


def point_plane_distance(coef, points):
    """|n.x + d| for coef ``[..., 4]`` and points ``[..., N, 3]``."""
    return torch.abs(torch.einsum("...i,...ni->...n", coef[..., :3], points)
                     + coef[..., 3:4])


def _coef(n, d):
    return torch.cat([n, d[..., None]], dim=-1)


def _batched(valid, key):
    single = valid.dim() == 1
    return single, (valid[None] if single else valid), (key[None] if single else key)


def _ransac(points, valid, keys, inlier_thr, num_hypotheses):
    """``valid [I, N]``, ``keys [I, 2]`` -> (coef [I, 4], inliers [I, N])."""
    N = points.shape[0]
    idx = torch.stack([sample_minimal_sets(k, num_hypotheses, 3, N, v)
                       for k, v in zip(keys, valid)])                     # [I, S, 3]
    p = points[idx]                                                        # [I, S, 3, 3]
    n = torch.linalg.cross(p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :])
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    d = -torch.sum(n * p[..., 0, :], dim=-1)
    dist = point_plane_distance(_coef(n, d), points)                       # [I, S, N]
    ok = (dist <= inlier_thr) & valid[:, None, :]
    # Degenerate (collinear or repeated) samples have |n| ~ 0: score 0.
    score = torch.where(norm[..., 0] > 1e-9, torch.sum(ok, dim=-1), 0)
    best = torch.argmax(score, dim=-1)
    inl = ok[torch.arange(ok.shape[0], device=ok.device), best]
    # SVD refit on the consensus set, then re-gate (one reweighted round).
    for _ in range(2):
        n1, d1 = fit_plane_svd(points, inl.to(torch.float32))
        coef = _coef(n1, d1)
        inl = (point_plane_distance(coef, points) <= inlier_thr) & valid
    return coef, inl


def plane_ransac(points, valid, key, *, inlier_thr, num_hypotheses: int = NUM_HYPOTHESES):
    """Batched 3-point plane RANSAC and SVD consensus refit. Returns
    (coef [..., 4], inliers [..., N], num_inliers [...])."""
    single, valid, keys = _batched(valid, key)
    coef, inl = _ransac(points, valid, keys, inlier_thr, num_hypotheses)
    if single:
        coef, inl = coef[0], inl[0]
    return coef, inl, torch.sum(inl, dim=-1)


def knn_graph(points, valid, num_neighbors: int = NUM_NEIGHBORS):
    """k-NN graph among valid points (3D Euclidean), lower index first on
    ties. Returns (nbr [N, K] i64, nbr_ok [N, K] bool)."""
    N = points.shape[0]
    d2m = torch.sum((points[:, None] - points[None]) ** 2, dim=-1)
    big = 1e30
    d2m = torch.where(valid[None] & valid[:, None], d2m, torch.full_like(d2m, big))
    d2m = d2m + torch.eye(N, dtype=d2m.dtype, device=d2m.device) * big  # no self-edges
    _, nbr = topk_stable(-d2m, num_neighbors)
    return nbr, torch.gather(d2m, 1, nbr) < big


def plane_ransac_coherent(points, valid, key, graph=None, *, inlier_thr,
                          num_hypotheses: int = NUM_HYPOTHESES,
                          num_neighbors: int = NUM_NEIGHBORS,
                          num_sweeps: int = NUM_SWEEPS, smoothness: float = SMOOTHNESS):
    """Spatially coherent plane consensus: the batched MSAC seed, then
    ``num_sweeps`` mean-field sweeps of the soft inlier labels over the
    k-NN graph (sigmoid(unary + smoothness * neighbour field)), each
    followed by a weighted SVD refit: GC-RANSAC's energy
    (GCRANSAC.h:50) without the sequential min-cut.

    ``graph``: an optional ``knn_graph`` over a superset of ``valid``
    (per-instance validity is applied to its edges); built per call
    otherwise (one instance only). Returns like :func:`plane_ransac`."""
    single, valid, keys = _batched(valid, key)
    coef, inl0 = _ransac(points, valid, keys, inlier_thr, num_hypotheses)
    if graph is None:
        nbr, nbr_ok = knn_graph(points, valid[0], num_neighbors)
        nbr_ok = nbr_ok[None]
    else:
        nbr, nbr_ok = graph
        nbr_ok = nbr_ok[None] & valid[:, nbr]                               # [I, N, K]
    tau = 0.5 * inlier_thr
    x = inl0.to(torch.float32)
    deg = torch.clamp(torch.sum(nbr_ok, dim=-1), min=1)
    for _ in range(num_sweeps):
        dist = point_plane_distance(coef, points)
        unary = (inlier_thr - dist) / tau
        votes = torch.where(nbr_ok, 2.0 * x[:, nbr] - 1.0, torch.zeros_like(x[:, nbr]))
        field = torch.sum(votes, dim=-1) / deg
        x = torch.sigmoid(unary + smoothness * field)
        x = torch.where(valid, x, torch.zeros_like(x))
        coef = _coef(*fit_plane_svd(points, x))
    dist = point_plane_distance(coef, points)
    # Accept by smoothed label, with a hard residual cap: coherence can
    # recruit boundary points (<= 2 thr) but never gross outliers.
    inl = (x > 0.5) & (dist <= 2.0 * inlier_thr) & valid
    if single:
        coef, inl = coef[0], inl[0]
    return coef, inl, torch.sum(inl, dim=-1)
