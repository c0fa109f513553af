"""Closed-form and blocked dense linear algebra.

Port of structure_plp_slam_tpu/ops/linalg.py: adjugate 3x3 inverses, a
3x3-Schur 6x6 SPD inverse, the equilibrated 6x6 solve used inside the
per-frame LM loop, and the recursive block SPD inverse + preconditioned
CG solve. Same arithmetic, so the port's LM iterates follow the JAX
package's. ``block_cholesky_solve``: the dense Cholesky solve of a
block system, in one summation order on the CPU at any torch thread
count. ``jacobian_fwd``: forward-mode Jacobians of row-wise batched
residuals (the line terms).
"""

from __future__ import annotations

import torch


def inv3x3(H):
    """Closed-form batched 3x3 inverse via the adjugate."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([Cc, -(a * h - b * g), a * e - b * d], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def inv6x6_spd(H):
    """Batched symmetric 6x6 inverse via one level of 3x3 Schur blocks."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    Ai = inv3x3(A)
    AiB = Ai @ B
    Sd = D - B.transpose(-1, -2) @ AiB
    Sdi = inv3x3(Sd)
    AiB_Sdi = AiB @ Sdi
    TL = Ai + AiB_Sdi @ AiB.transpose(-1, -2)
    TR = -AiB_Sdi
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.transpose(-1, -2), Sdi], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_inverse(S, base: int = 6):
    """Inverse of an SPD matrix ``[n, n]`` (n = base * 2^k) by recursive
    2x2-block Schur partitioning, symmetrized at every level."""
    n = S.shape[-1]
    if n <= base or n % 2 == 1:
        if n == 6:
            return inv6x6_spd(S)
        if n == 3:
            return inv3x3(S)
        return torch.linalg.inv(S)
    h = n // 2
    A = S[..., :h, :h]
    B = S[..., :h, h:]
    D = S[..., h:, h:]
    Ai = spd_inverse(A, base)
    AiB = Ai @ B
    Sd = D - B.transpose(-1, -2) @ AiB
    Sd = 0.5 * (Sd + Sd.transpose(-1, -2))
    Sdi = spd_inverse(Sd, base)
    AiB_Sdi = AiB @ Sdi
    TL = Ai + AiB_Sdi @ AiB.transpose(-1, -2)
    TL = 0.5 * (TL + TL.transpose(-1, -2))
    TR = -AiB_Sdi
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.transpose(-1, -2), Sdi], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _mv(A, v):
    return torch.einsum("...ij,...j->...i", A, v)


def solve3(A, b):
    """Batched 3x3 solve via the adjugate inverse."""
    return _mv(inv3x3(A), b)


def solve6_spd(H, b, refine: int = 2):
    """Batched damped-SPD 6x6 solve: Jacobi equilibration, closed-form
    Schur inverse, ``refine`` iterative-refinement steps."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    dinv = 1.0 / d
    He = H * dinv[..., :, None] * dinv[..., None, :]
    be = b * dinv
    Hi = inv6x6_spd(He)
    x = _mv(Hi, be)
    for _ in range(refine):
        r = be - _mv(He, x)
        x = x + _mv(Hi, r)
    return x * dinv


def spd_solve(S, rhs, base: int = 6, refine: int = 2):
    """Solve ``S x = rhs`` for SPD ``S``: symmetrize, equilibrate, pad to
    base * 2^k with identity, then ``4 * refine`` CG steps preconditioned
    by :func:`spd_inverse`."""
    n = S.shape[-1]
    S = 0.5 * (S + S.transpose(-1, -2))
    d = torch.sqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1), min=1e-12))
    dinv = 1.0 / d
    S = S * dinv[..., :, None] * dinv[..., None, :]
    rhs = rhs * dinv
    target = base
    while target < n:
        target *= 2
    if target != n:
        Sp = torch.eye(target, dtype=S.dtype, device=S.device).expand(
            S.shape[:-2] + (target, target)
        ).clone()
        Sp[..., :n, :n] = S
        rp = torch.zeros(S.shape[:-2] + (target,), dtype=rhs.dtype, device=rhs.device)
        rp[..., :n] = rhs
        S, rhs = Sp, rp
    Si = spd_inverse(S, base)

    def dot(a, b):
        return torch.sum(a * b, dim=-1, keepdim=True)

    def safe(x):
        return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30), x)

    x = torch.zeros_like(rhs)
    r = rhs
    z = _mv(Si, r)
    p = z
    rz = dot(r, z)
    for _ in range(max(refine, 1) * 4):
        Ap = _mv(S, p)
        alpha = rz / safe(dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = _mv(Si, r)
        rz_new = dot(r, z)
        beta = rz_new / safe(rz)
        p = z + beta * p
        rz = rz_new
    return x[..., :n] * dinv


# Largest diagonal block ``block_cholesky_solve`` factors at once on the CPU.
CHOL_BLOCK = 24


def block_cholesky_solve(S, rhs):
    """Solve ``S x = rhs`` for the SPD block matrix ``S [C, C, b, b]``
    (block (i, j) at rows i, columns j), ``rhs [C, b]``; ``x [C, b]``, all
    NaN where the factorization fails (as jax's ``cho_factor`` gives).

    On the card: ``cholesky_ex`` and ``cholesky_solve`` of the dense
    ``[Cb, Cb]`` matrix. On the CPU MKL's factorization of a matrix past
    ~128 rows splits its updates by thread, so its last bits follow
    torch's thread count; there the factorization runs block column by
    block column instead (right-looking, over diagonal blocks of up to
    ``CHOL_BLOCK`` rows: each diagonal block factored alone, the blocks
    below it by a batched triangular solve, the trailing blocks and the
    right-hand side updated by elementwise products summed along one
    axis), then the back substitution block by block, which gives one
    result at any thread count."""
    C, b = S.shape[0], S.shape[-1]
    if S.device.type != "cpu":
        L, info = torch.linalg.cholesky_ex(S.permute(0, 2, 1, 3).reshape(C * b, C * b))
        x = torch.cholesky_solve(rhs.reshape(C * b, 1), L).reshape(C, b)
        return torch.where(info == 0, x, torch.nan)
    g = max(k for k in range(1, C + 1) if C % k == 0 and k * b <= max(CHOL_BLOCK, b))
    n, m = C // g, g * b
    A = S.reshape(n, g, n, g, b, b).permute(0, 2, 1, 4, 3, 5).reshape(n, n, m, m).clone()
    y = rhs.reshape(n, m).clone()
    diag = []
    fail = torch.zeros((), dtype=torch.bool)
    for j in range(n):
        Ljj, info = torch.linalg.cholesky_ex(A[j, j])
        fail = fail | (info != 0)
        diag.append(Ljj)
        y[j] = torch.linalg.solve_triangular(Ljj, y[j, :, None], upper=False)[:, 0]
        if j + 1 < n:
            # L[i, j] = A[i, j] Ljj^-T below the diagonal block.
            Lij = torch.linalg.solve_triangular(
                Ljj, A[j + 1 :, j].transpose(-1, -2), upper=False).transpose(-1, -2)
            A[j + 1 :, j] = Lij
            A[j + 1 :, j + 1 :] -= (Lij[:, None, :, None, :] * Lij[None, :, None, :, :]).sum(-1)
            y[j + 1 :] -= (Lij * y[j]).sum(-1)
    for j in range(n - 1, -1, -1):  # L^T x = y
        y[j] = torch.linalg.solve_triangular(diag[j].T, y[j, :, None], upper=True)[:, 0]
        if j:
            y[:j] -= (A[j, :j] * y[j][None, :, None]).sum(-2)
    return torch.where(fail, torch.nan, y.reshape(C, b))


def jacobian_fwd(fn, x0, n: int):
    """Forward-mode Jacobian of a batched ``fn: [B, n] -> [B, r]`` at
    ``x0 [B, n]``, where row b of the output depends on row b of the input
    only: ``[B, r, n]``, one ``torch.func.jvp`` per tangent direction
    (vmapped), every tensor at least 1-d (ROADMAP C21)."""
    dirs = torch.eye(n, dtype=x0.dtype, device=x0.device)[:, None, :].expand(n, *x0.shape)
    r, J = torch.func.vmap(lambda v: torch.func.jvp(fn, (x0,), (v,)))(dirs)
    return r[0], J.permute(1, 2, 0)
