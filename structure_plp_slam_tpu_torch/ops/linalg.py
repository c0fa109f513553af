"""Closed-form and blocked dense linear algebra.

Port of structure_plp_slam_tpu/ops/linalg.py: adjugate 3x3 inverses, a
3x3-Schur 6x6 SPD inverse, the equilibrated 6x6 solve used inside the
per-frame LM loop, and the recursive block SPD inverse + preconditioned
CG solve. Same arithmetic, so the port's LM iterates follow the JAX
package's. ``block_cholesky_solve``: the dense Cholesky solve of a
block system. ``jacobian_fwd``: forward-mode Jacobians of row-wise batched
residuals (the line terms).

The factorizations (``svd``, ``eigh``, ``cho_factor`` / ``cho_solve``,
``inv``, ``solve``) are one function per JAX call. On the card each is
the ``torch.linalg`` op. On the CPU each loops over the leading batch axes
into the LAPACK / BLAS routine that XLA:CPU calls for the JAX op
(``sgesdd``, ``ssyevd``, ``spotrf`` then two ``strsm``, ``sgetrf`` then
two ``strsm``), through ``scipy.linalg``: jaxlib's CPU kernels call the
same library, so the port's CPU results, signs included, are the JAX
package's (ROADMAP C45, C10/C23). scipy's OpenBLAS does not follow
torch's thread count. Where LAPACK reports a failure the result is what
JAX gives (NaN), never another route's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def inv3x3(H):
    """Closed-form batched 3x3 inverse via the adjugate. On the CPU each
    difference of two products fuses the first (:func:`fms`), as XLA:CPU
    compiles the jitted function."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = fms(e, i, f * h)
    B = -fms(d, i, f * g)
    Cc = fms(d, h, e * g)
    det = fma(c, Cc, fma(a, A, b * B))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A, -fms(b, i, c * h), fms(b, f, c * e)], -1),
            torch.stack([B, fms(a, i, c * g), -fms(a, f, c * d)], -1),
            torch.stack([Cc, -fms(a, h, b * g), fms(a, e, b * d)], -1),
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
    AiB = matmul(Ai, B)
    Sd = D - matmul(B.transpose(-1, -2), AiB)
    Sdi = inv3x3(Sd)
    AiB_Sdi = matmul(AiB, Sdi)
    TL = Ai + matmul(AiB_Sdi, AiB.transpose(-1, -2))
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
        return inv(S)
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
    return einsum_fma("...ij,...j->...i", A, v)


def solve3(A, b):
    """Batched 3x3 solve via the adjugate inverse."""
    return _mv(inv3x3(A), b)


def solve6_spd(H, b, refine: int = 2):
    """Batched damped-SPD 6x6 solve: Jacobi equilibration, closed-form
    Schur inverse, ``refine`` iterative-refinement steps."""
    d = sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
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


def _lapack(name, dtype):
    """The scipy LAPACK / BLAS routine ``name`` for ``dtype`` (``s`` or ``d``
    prefix); scipy is imported here, on the CPU route only."""
    from scipy.linalg import blas, lapack

    prefix = {torch.float32: "s", torch.float64: "d"}[dtype]
    return getattr(blas if name == "trsm" else lapack, prefix + name)


@functools.lru_cache(maxsize=None)
def _gesdd_lwork(dtype, m: int, n: int, full_matrices: bool) -> int:
    """The workspace size of a workspace query, as jaxlib's ``gesdd``
    takes it."""
    work, info = _lapack("gesdd_lwork", dtype)(m, n, compute_uv=1,
                                               full_matrices=int(full_matrices))
    assert info == 0, info
    return max(int(work), 1)


def _matrices(a):
    """``a [..., m, n]`` as a C-ordered numpy stack ``[B, m, n]``."""
    return np.ascontiguousarray(a.detach().reshape(-1, *a.shape[-2:]).numpy())


def _nan_where(bad, *arrays):
    for x in arrays:
        x[bad] = np.nan
    return arrays


def svd(a, full_matrices: bool = True):
    """``jnp.linalg.svd(a, full_matrices)``: (U, S, Vt) over the leading
    axes of ``a [..., m, n]``; on the CPU ``gesdd``, NaN where it fails."""
    if a.device.type != "cpu":
        return torch.linalg.svd(a, full_matrices=full_matrices)
    m, n = a.shape[-2:]
    k = min(m, n)
    mats = _matrices(a)
    B = mats.shape[0]
    gesdd = _lapack("gesdd", a.dtype)
    lwork = _gesdd_lwork(a.dtype, m, n, full_matrices)
    U = np.empty((B, m, m if full_matrices else k), mats.dtype)
    S = np.empty((B, k), mats.dtype)
    Vt = np.empty((B, n if full_matrices else k, n), mats.dtype)
    bad = np.zeros(B, bool)
    for i in range(B):
        U[i], S[i], Vt[i], info = gesdd(mats[i], compute_uv=1,
                                        full_matrices=int(full_matrices), lwork=lwork)
        bad[i] = info != 0
    _nan_where(bad, U, S, Vt)
    lead = a.shape[:-2]
    return (torch.from_numpy(U).reshape(*lead, *U.shape[1:]),
            torch.from_numpy(S).reshape(*lead, k),
            torch.from_numpy(Vt).reshape(*lead, *Vt.shape[1:]))


def eigh(a):
    """``jnp.linalg.eigh(a)``: (ascending eigenvalues, eigenvectors as
    columns) of ``a [..., n, n]``; on the CPU ``syevd`` on the lower
    triangle of the symmetric part ``(a + a^T) / 2``, as JAX symmetrizes
    it, NaN where it fails."""
    if a.device.type != "cpu":
        return torch.linalg.eigh(a)
    a = (a + a.transpose(-1, -2)) / 2
    n = a.shape[-1]
    mats = _matrices(a)
    B = mats.shape[0]
    syevd = _lapack("syevd", a.dtype)
    W = np.empty((B, n), mats.dtype)
    V = np.empty((B, n, n), mats.dtype)
    bad = np.zeros(B, bool)
    for i in range(B):
        W[i], V[i], info = syevd(mats[i], compute_v=1, lower=1)
        bad[i] = info != 0
    _nan_where(bad, W, V)
    return (torch.from_numpy(W).reshape(*a.shape[:-1]),
            torch.from_numpy(V).reshape(a.shape))


def cho_factor(a):
    """``jax.scipy.linalg.cho_factor(a, lower=True)[0]``: the lower
    Cholesky factor of ``a [..., n, n]`` (its lower triangle only; zeros
    above), the lower triangle NaN where the factorization fails."""
    if a.device.type != "cpu":
        L, info = torch.linalg.cholesky_ex(a)
        return torch.where((info == 0)[..., None, None], L, torch.nan).tril()
    mats = _matrices(a)
    potrf = _lapack("potrf", a.dtype)
    out = np.empty_like(mats)
    bad = np.zeros(mats.shape[0], bool)
    for i in range(mats.shape[0]):
        out[i], info = potrf(mats[i], lower=1, clean=1)
        bad[i] = info != 0
    out[bad] = np.where(np.tri(a.shape[-1], dtype=bool), np.nan, 0.0)
    return torch.from_numpy(out).reshape(a.shape)


def _trsm_left(trsm, A, b, *, lower: bool, trans: bool, unit: bool = False):
    """``op(A)^-1 b`` for ``b [n]`` or ``[n, k]`` by one BLAS ``trsm``."""
    x = trsm(1.0, A, b.reshape(b.shape[0], -1), side=0, lower=int(lower),
             trans_a=int(trans), diag=int(unit))
    return x.reshape(b.shape)


def cho_solve(L, b):
    """``jax.scipy.linalg.cho_solve((L, True), b)`` for the factor of
    :func:`cho_factor`: ``b [..., n]`` or ``[..., n, k]`` over the leading
    axes of ``L [..., n, n]``; on the CPU two ``trsm``, as JAX's."""
    if L.device.type != "cpu":
        vec = b.dim() == L.dim() - 1
        x = torch.cholesky_solve(b[..., None] if vec else b, L)
        return x[..., 0] if vec else x
    trsm = _lapack("trsm", L.dtype)
    Ls = _matrices(L)
    bs = b.detach().reshape(Ls.shape[0], *b.shape[L.dim() - 2:]).numpy()
    out = np.empty_like(bs)
    for i in range(Ls.shape[0]):
        y = _trsm_left(trsm, Ls[i], bs[i], lower=True, trans=False)
        out[i] = _trsm_left(trsm, Ls[i], y, lower=True, trans=True)
    return torch.from_numpy(out).reshape(b.shape)


def _lu_solve_cpu(a, b):
    """``jnp.linalg.solve`` on the CPU: ``getrf``, the pivots applied to
    ``b`` as a permutation, then the unit-lower and upper ``trsm``; NaN
    where ``getrf`` reports a bad argument (a singular matrix divides by
    its zero pivot, as in JAX)."""
    getrf = _lapack("getrf", a.dtype)
    trsm = _lapack("trsm", a.dtype)
    mats = _matrices(a)
    n = a.shape[-1]
    bs = b.detach().reshape(mats.shape[0], *b.shape[a.dim() - 2:]).numpy()
    out = np.empty_like(bs)
    for i in range(mats.shape[0]):
        lu, piv, info = getrf(mats[i])
        if info < 0:
            out[i] = np.nan
            continue
        perm = np.arange(n)
        for j, p in enumerate(piv):
            perm[[j, p]] = perm[[p, j]]
        x = _trsm_left(trsm, lu, bs[i][perm], lower=True, trans=False, unit=True)
        out[i] = _trsm_left(trsm, lu, x, lower=False, trans=False)
    return torch.from_numpy(out).reshape(b.shape)


def solve(a, b):
    """``jnp.linalg.solve(a, b)``: ``b [..., n]`` (one right-hand side) or
    ``[..., n, k]`` over the leading axes of ``a [..., n, n]``; on the
    CPU the LU route of :func:`_lu_solve_cpu`."""
    if a.device.type != "cpu":
        return torch.linalg.solve_ex(a, b)[0]
    return _lu_solve_cpu(a, b)


def inv(a):
    """``jnp.linalg.inv(a)`` over the leading axes of ``a [..., n, n]``: on
    the CPU the solve of the identity, as JAX computes it."""
    if a.device.type != "cpu":
        return torch.linalg.inv_ex(a)[0]
    eye = torch.eye(a.shape[-1], dtype=a.dtype).expand(a.shape)
    return _lu_solve_cpu(a, eye)


def _fma_round(p, acc):
    """``p + acc`` rounded once to f32, for an f64 ``p`` that is an exact
    product of two f32 values and an f32 ``acc``. The f64 sum rounds
    first; where that lands exactly halfway between two f32 values, the
    sum's rounding error (two-sum) says which way the exact value lies."""
    a = acc.double()
    s = p + a
    r = s.float()
    # Only an f64 sum whose low 29 bits are 1 followed by zeros sits
    # halfway between two normal f32 values.
    half = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    tiny = (r != 0) & (torch.abs(r) < torch.finfo(torch.float32).tiny)
    if not bool(torch.any(half | tiny)):
        return r
    z = s - p
    err = (p - (s - z)) + (a - z)
    r64 = r.double()
    away = torch.nextafter(r, torch.where(s > r64, torch.inf, -torch.inf).to(r.dtype))
    tie = (s != r64) & (s == (r64 + away.double()) * 0.5) & (err != 0)
    return torch.where(tie & ((err > 0) == (away > r)), away, r)


def fma(x, y, acc):
    """``x * y + acc``. On the CPU rounded once to f32, as XLA:CPU compiles
    a product that feeds a sum in one fusion (a fused multiply-add); on
    the card the two ops."""
    if x.device.type != "cpu":
        return x * y + acc
    return _fma_round(x.double() * y.double(), acc)


def fms(x, y, z):
    """``x * y - z``, fused on the CPU as :func:`fma`; on the card the two
    ops."""
    if x.device.type != "cpu":
        return x * y - z
    return _fma_round(x.double() * y.double(), -z)


def matvec(a, v):
    """``a @ v`` of a small matrix and a vector; on the CPU one fused
    multiply-add chain per output, as XLA:CPU's gemv sums it (:func:`einsum_fma`);
    on the card ``a @ v``."""
    if a.device.type != "cpu":
        return a @ v
    return einsum_fma("...ij,...j->...i", a, v)


def vecmat(v, a):
    """``v @ a`` of a vector and a small matrix, summed on the CPU as
    :func:`matvec`; on the card ``v @ a``."""
    if a.device.type != "cpu":
        return v @ a
    return einsum_fma("...j,...jk->...k", v, a)


def div_const(x, c: float):
    """``x / c`` for a Python number ``c``. XLA:CPU folds a division by a
    constant into a product with the constant's f32 reciprocal, and so does
    the CPU here; on the card the division."""
    if x.device.type != "cpu":
        return x / c
    return x * (torch.tensor(1.0, dtype=x.dtype) / torch.tensor(c, dtype=x.dtype))


def rows_matmul3(a, m):
    """``a @ m`` for rows ``a [..., 3]`` and a matrix ``m [3, 3]``. On the
    CPU as XLA:CPU's kernel for this dot computes it on AVX-512 (the SLP
    vectorizer packs the first two output columns): columns 0 and 1 as
    three rounded products added left to right from 0, column 2 one fused
    multiply-add chain from 0; on the card ``a @ m``."""
    if a.device.type != "cpu":
        return a @ m
    p = a[..., :, None] * m  # [..., k, j]: a_k m_kj
    c01 = ((0.0 + p[..., 0, :2]) + p[..., 1, :2]) + p[..., 2, :2]
    c2 = fma(a[..., 2], m[2, 2], fma(a[..., 1], m[1, 2], a[..., 0] * m[0, 2]))
    return torch.cat([c01, c2[..., None]], dim=-1)


def matmul(a, b):
    """``a @ b`` of small matrices; on the CPU summed as XLA:CPU sums it
    (:func:`einsum_fma`)."""
    if a.device.type != "cpu":
        return a @ b
    return einsum_fma("...ij,...jk->...ik", a, b)


def sqrt(x):
    """``torch.sqrt``, correctly rounded on the CPU as XLA's is (torch's f32
    CPU sqrt is not always; the f64 root rounds to the right f32)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def sq_norm(v):
    """``jnp.sum(v ** 2, axis=-1)``: on the CPU one fused multiply-add chain
    in increasing order, as XLA:CPU computes it; on the card the plain
    sum."""
    if v.device.type != "cpu":
        return torch.sum(v * v, dim=-1)
    acc = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = fma(v[..., k], v[..., k], acc)
    return acc


def norm(v):
    """``jnp.linalg.norm(v, axis=-1)``: on the CPU the squares summed in one
    fused multiply-add chain in increasing order (:func:`sq_norm`) and a
    correctly rounded root, as XLA:CPU computes it; on the card
    ``torch.linalg.norm``."""
    if v.device.type != "cpu":
        return torch.linalg.norm(v, dim=-1)
    return sqrt(sq_norm(v))


def gemv_sum(a, b):
    """``jnp.einsum("kl,kl->l", a, b)``: the sum over the first axis of
    ``a * b``. On the CPU as XLA:CPU's column-major gemv kernel sums it
    (read at 32 rows): the first tile of 8 products rounded and added in
    order, each later product fused into the sum (rows of ``a`` that are
    all zero add exact zeros to finite ``b`` and are skipped); on the card
    the plain sum."""
    if a.device.type != "cpu":
        return torch.sum(a * b, dim=0)
    acc = torch.zeros(a.shape[1:], dtype=a.dtype)
    for k in torch.nonzero(torch.any(a.reshape(a.shape[0], -1) != 0, dim=1)).flatten().tolist():
        acc = acc + a[k] * b[k] if k < 8 else fma(a[k], b[k], acc)
    return acc


def tree_sum(x, dim: int = -1):
    """``torch.sum(x, dim)``. On the CPU the reduce XLA:CPU emits for
    ``jnp.sum`` over that axis (its tree-reduction rewrite, as
    ``csrc/pose_solve_cpu.c`` sums): while more than 32 values are left,
    windows of 32 with the zero padding split around them (the lower half
    in front), each window summed in order from 0; then the last values in
    order from 0. On the card ``torch.sum``."""
    if x.device.type != "cpu":
        return torch.sum(x, dim=dim)
    x = x.movedim(dim, -1)
    while x.shape[-1] > 32:
        pad = -x.shape[-1] % 32
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, 32)
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype)
        for j in range(32):
            acc = acc + x[..., j]
        x = acc
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def tree_mean(x, dim: int = -1):
    """``torch.mean(x, dim)``. On the CPU ``jnp.mean`` as XLA:CPU computes
    it: :func:`tree_sum` times the count's f32 reciprocal
    (:func:`div_const`); on the card ``torch.mean``."""
    if x.device.type != "cpu":
        return torch.mean(x, dim=dim)
    return div_const(tree_sum(x, dim=dim), x.shape[dim])


def einsum_fma(eq, a, b):
    """``torch.einsum(eq, a, b)`` with one contracted index. On the CPU
    summed as XLA:CPU's dot of these small shapes: each output one fused
    multiply-add chain over the contracted index in increasing order,
    from 0 (:func:`fma`; a slice of ``a`` that is all zero adds exact zeros
    to finite ``b`` and is skipped); on the card the einsum."""
    if a.device.type != "cpu":
        return torch.einsum(eq, a, b)
    ins, out = eq.replace("...", "").split("->")
    sa, sb = ins.split(",")
    (c,) = [ch for ch in sa if ch in sb and ch not in out]
    da, db = sa.index(c) - len(sa), sb.index(c) - len(sb)
    eq1 = eq.replace(c, "")
    acc = None
    for k in range(a.shape[da]):
        ak = a.select(da, k)
        if acc is not None and not bool(torch.any(ak != 0)):
            continue
        prod = torch.einsum(eq1, ak.double(), b.select(db, k).double())
        acc = prod.float() if acc is None else _fma_round(prod, acc)
    return acc


def det3(a):
    """``jnp.linalg.det`` of ``a [..., 3, 3]``: on the CPU JAX's closed form
    (``_det_3x3``) as XLA:CPU compiles it, the first product rounded and
    each later one fused into the sum; on the card ``torch.linalg.det``."""
    if a.device.type != "cpu":
        return torch.linalg.det(a)
    e = [[a[..., i, j] for j in range(3)] for i in range(3)]
    d = fma(e[0][0] * e[1][1], e[2][2], e[0][1] * e[1][2] * e[2][0])
    d = fma(e[0][2] * e[1][0], e[2][1], d)
    d = fma(-(e[0][2] * e[1][1]), e[2][0], d)
    d = fma(-(e[0][0] * e[1][2]), e[2][1], d)
    return fma(-(e[0][1] * e[1][0]), e[2][2], d)


def block_cholesky_solve(S, rhs):
    """Solve ``S x = rhs`` for the SPD block matrix ``S [C, C, b, b]``
    (block (i, j) at rows i, columns j), ``rhs [C, b]``; ``x [C, b]``, all
    NaN where the factorization fails (as jax's ``cho_factor`` gives): the
    dense ``[Cb, Cb]`` Cholesky solve of the BA's, the global BA's and the
    pose graph's camera systems, by :func:`cho_factor` and
    :func:`cho_solve` (on the CPU JAX's LAPACK routines, whose OpenBLAS
    does not follow torch's thread count; ROADMAP C45)."""
    C, b = S.shape[0], S.shape[-1]
    Sd = S.permute(0, 2, 1, 3).reshape(C * b, C * b)
    return cho_solve(cho_factor(Sd), rhs.reshape(C * b)).reshape(C, b)


def jacobian_fwd(fn, x0, n: int):
    """Forward-mode Jacobian of a batched ``fn: [B, n] -> [B, r]`` at
    ``x0 [B, n]``, where row b of the output depends on row b of the input
    only: ``[B, r, n]``, one ``torch.func.jvp`` per tangent direction
    (vmapped), every tensor at least 1-d (ROADMAP C21)."""
    dirs = torch.eye(n, dtype=x0.dtype, device=x0.device)[:, None, :].expand(n, *x0.shape)
    r, J = torch.func.vmap(lambda v: torch.func.jvp(fn, (x0,), (v,)))(dirs)
    return r[0], J.permute(1, 2, 0)
