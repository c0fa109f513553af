"""The port's CPU factorizations are XLA:CPU's, bit for bit (ROADMAP C45).

``ops/linalg`` has one function per JAX call (``svd``, ``eigh``,
``cho_factor`` / ``cho_solve``, ``inv``, ``solve``, ``det3``). On the CPU
each loops into the LAPACK / BLAS routine jaxlib calls (through
``scipy.linalg``), so its outputs must equal the jitted JAX call's with
``np.array_equal``, signs of the singular and eigen vectors included, and
NaN where the JAX call gives NaN. The shapes are the call sites': the
8-point rows and their batch, the 3x3 projections and decompositions,
the 12x12 PnP rows, the 9x9 weighted refit, the 4x4 triangulation
systems, the BA's, global BA's and pose graph's dense camera systems
(n = 24, 192, 384), the global BA's landmark blocks, the line BA's 4x4
and the line tracker's 6x6 solves. The fused multiply-add helpers
(``fma``, ``einsum_fma``, ``norm``, ``inv3x3``) and ``tree_sum`` (XLA's
windows of 32 for ``jnp.sum``) are held against the jitted JAX
expressions they model, on random inputs of those shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from structure_plp_slam_tpu.ops import linalg as jlinalg
from structure_plp_slam_tpu_torch.ops import linalg


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _spd(seed, n):
    a = _rand(seed, (n, n + 5))
    return a @ a.T


def _equal(jax_out, port_out):
    jax_out = jax_out if isinstance(jax_out, (tuple, list)) else (jax_out,)
    port_out = port_out if isinstance(port_out, (tuple, list)) else (port_out,)
    assert len(jax_out) == len(port_out)
    for j, p in zip(jax_out, port_out):
        j = np.asarray(j)
        assert p.dtype == torch.float32 and tuple(p.shape) == j.shape
        assert np.array_equal(p.numpy(), j, equal_nan=True), np.nanmax(np.abs(p.numpy() - j))


@pytest.mark.parametrize("shape", [(8, 9), (3, 3), (12, 12), (64, 8, 9)])
def test_svd(shape):
    a = _rand(1, shape)
    _equal(jax.jit(lambda x: jnp.linalg.svd(x, full_matrices=True))(a),
           linalg.svd(torch.from_numpy(a), full_matrices=True))


@pytest.mark.parametrize("shape", [(9, 9), (256, 4, 4)])
def test_eigh(shape):
    a = _rand(2, shape)
    a = a @ np.swapaxes(a, -1, -2) + 0.01 * _rand(3, shape)  # JAX symmetrizes
    _equal(jax.jit(jnp.linalg.eigh)(a), linalg.eigh(torch.from_numpy(a)))


@pytest.mark.parametrize("n", [24, 192, 384, "not_pd"])
def test_cho_factor_solve(n):
    if n == "not_pd":
        a = np.diag(np.array([1.0, -1.0, 2.0, 3.0], np.float32))
    else:
        a = _spd(n, n)
    b = _rand(5, a.shape[0])
    cf = jax.jit(lambda x: jsl.cho_factor(x, lower=True)[0])(a)
    L = linalg.cho_factor(torch.from_numpy(a))
    _equal(cf, L)
    _equal(jax.jit(lambda c, y: jsl.cho_solve((c, True), y))(cf, b),
           linalg.cho_solve(L, torch.from_numpy(b)))
    if n == "not_pd":
        assert torch.isnan(L).any()


def test_block_cholesky_solve():
    """The BA's camera solve: the dense [Cb, Cb] matrix of its blocks."""
    C, bsz = 8, 6
    S = _spd(6, C * bsz)
    rhs = _rand(7, (C, bsz))
    ref = jax.jit(lambda s, r: jsl.cho_solve(jsl.cho_factor(s, lower=True), r.reshape(-1)))(
        S, rhs).reshape(C, bsz)
    blocks = torch.from_numpy(S).reshape(C, bsz, C, bsz).permute(0, 2, 1, 3)
    _equal(ref, linalg.block_cholesky_solve(blocks, torch.from_numpy(rhs)))


@pytest.mark.parametrize("case", ["batch32", "one", "singular"])
def test_inv(case):
    a = {"batch32": _rand(8, (32, 3, 3)), "one": _rand(9, (3, 3)),
         "singular": np.ones((3, 3), np.float32)}[case]
    _equal(jax.jit(jnp.linalg.inv)(a), linalg.inv(torch.from_numpy(a)))


@pytest.mark.parametrize("shape", [(16, 4, 4), (300, 4, 4), (5, 6, 6), (6, 6)])
def test_solve(shape):
    """A batch of one right-hand side each, as line_ba.py passes it
    (``b[..., None]`` in the JAX package), and a single 6x6 system with a
    vector, as the line tracker's."""
    a = _rand(10, shape)
    b = _rand(11, shape[:-1])
    if len(shape) == 2:
        ref = jax.jit(jnp.linalg.solve)(a, b)
    else:
        ref = jax.jit(lambda x, y: jnp.linalg.solve(x, y[..., None])[..., 0])(a, b)
    _equal(ref, linalg.solve(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("shape", [(4096, 3, 3), (3, 3)])
def test_det3(shape):
    a = _rand(12, shape)
    _equal(jax.jit(jnp.linalg.det)(a), linalg.det3(torch.from_numpy(a)))


def test_fma_rounds_once():
    """The f64 emulation against glibc's fmaf, including sums that land
    exactly halfway between two f32 values in f64."""
    import ctypes

    libm = ctypes.CDLL("libm.so.6")
    libm.fmaf.restype = ctypes.c_float
    libm.fmaf.argtypes = [ctypes.c_float] * 3
    rng = np.random.default_rng(13)
    x = rng.normal(size=4000).astype(np.float32)
    y = rng.normal(size=4000).astype(np.float32)
    z = (rng.normal(size=4000) * 1e-3).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies halfway between two f32
    # values; a z of +-2^-80 moves the exact sum off the tie, which the f64
    # sum rounds back onto.
    x[:3] = y[:3] = 1.0 + 2.0 ** -12
    z[:3] = [2.0 ** -80, -(2.0 ** -80), 0.0]
    got = linalg.fma(*(torch.from_numpy(v) for v in (x, y, z))).numpy()
    ref = np.array([libm.fmaf(*map(float, v)) for v in zip(x, y, z)], np.float32)
    assert np.array_equal(got, ref)


def test_einsum_fma_triangulation_normal_matrix():
    """``A^T A`` of the triangulation's [N, 4, 4] rows."""
    a = _rand(14, (1032, 4, 4))
    _equal(jax.jit(lambda x: jnp.einsum("...ij,...ik->...jk", x, x))(a),
           linalg.einsum_fma("...ij,...ik->...jk", torch.from_numpy(a), torch.from_numpy(a)))


@pytest.mark.parametrize("width", [2, 3])
def test_norm(width):
    v = _rand(15, (256, width)) * 100.0
    _equal(jax.jit(lambda x: jnp.linalg.norm(x, axis=-1))(v), linalg.norm(torch.from_numpy(v)))


def test_inv3x3_fused():
    h = _rand(16, (256, 3, 3))
    _equal(jax.jit(jlinalg.inv3x3)(h), linalg.inv3x3(torch.from_numpy(h)))


@pytest.mark.parametrize("shape,dim", [((7, 31), -1), ((50, 33), -1), ((1032, 121), -1),
                                       ((300, 96, 49), -1), ((300, 96), 1), ((40, 1100), -1),
                                       ((8, 616, 6), 1)])
def test_tree_sum(shape, dim):
    """``jnp.sum`` over one axis as XLA:CPU compiles it (windows of 32, the
    padding split around them, recursively past 32 windows): the stereo
    SAD sums (121 and 49 samples, 96 disparities), the init BA's grid sums
    (616 rows) and shapes on either side of one and two rounds."""
    x = np.abs(_rand(17, shape)) * 255.0
    _equal(jax.jit(lambda a: jnp.sum(a, axis=dim))(x), linalg.tree_sum(torch.from_numpy(x), dim))
