"""Port parity: random draws, RANSAC solvers and area matching.

``utils/prng`` must reproduce ``jax.random`` bit for bit (keys, splits,
uniforms and the weighted ``choice`` the RANSAC samplers use), so the
port's solvers see the JAX package's minimal sets for the same key. On
the same samples: E and H agree up to sign within 1e-4 relative (the
coherent E refit within 5e-3, see its test), inlier
masks are equal, decomposition candidates agree as sets (within 1e-4),
the cheirality pick agrees within 1e-4 with the same ``good`` mask, and
``match_in_area`` plus the rotation histogram are exact.

Two-view inputs come from tests/test_ransac.py's generator; the matching
inputs are the JAX frontend's features of two rendered frames.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.ops import matching as jmatching
from structure_plp_slam_tpu.ops import ransac as jransac
from structure_plp_slam_tpu_torch.ops import matching as tmatching
from structure_plp_slam_tpu_torch.ops import ransac as transac
from structure_plp_slam_tpu_torch.utils import prng
from tests.test_ransac import _two_view

torch.set_num_threads(2)


def T(a, dtype=None):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.int32:
        a = a.astype(np.int64)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _rel_up_to_sign(a, b):
    return min(_rel(a, b), _rel(-np.asarray(a), b))


# ---------------------------------------------------------------------------
# utils/prng
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_keys_and_splits_bit_equal(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert (np.asarray(kj).astype(np.int64) == kt.numpy()).all()
    for _ in range(4):  # the System's _split_key chain
        kj, sj = jax.random.split(kj)
        kt, st = prng.split(kt)
        assert (np.asarray(kj).astype(np.int64) == kt.numpy()).all()
        assert (np.asarray(sj).astype(np.int64) == st.numpy()).all()
    for n in (2, 3):
        assert (np.asarray(jax.random.split(kj, n)).astype(np.int64)
                == prng.split(kt, n).numpy()).all()
    assert (np.asarray(jax.random.uniform(kj, (256, 8)))
            == prng.uniform(kt, (256, 8)).numpy()).all()


@pytest.mark.parametrize("N,k", [(600, 8), (600, 4), (1032, 6), (1032, 8), (40, 4)])
def test_minimal_sets_bit_equal(N, k):
    """The RANSAC / PnP samplers' weighted choice (cumsum in XLA:CPU's
    order, uniform, searchsorted) draws the same indices."""
    rng = np.random.default_rng(N + k)
    sample = jax.jit(jransac.sample_minimal_sets, static_argnums=(1, 2, 3))
    for seed in range(3):
        valid = rng.uniform(size=N) < rng.uniform(0.05, 0.95)
        ij = np.asarray(sample(jax.random.PRNGKey(seed), 256, k, N, jnp.asarray(valid)))
        it = transac.sample_minimal_sets(prng.PRNGKey(seed), 256, k, N, T(valid))
        assert (ij == it.numpy()).all()


def test_cumsum_matches_xla():
    rng = np.random.default_rng(3)
    for n in (1, 15, 16, 17, 300, 1032, 4100):
        x = rng.uniform(size=n).astype(np.float32)
        ref = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(x)))
        assert (prng.cumsum_xla(torch.from_numpy(x)).numpy() == ref).all(), n


# ---------------------------------------------------------------------------
# ops/ransac
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _views(planar, noise_px, outlier_frac):
    return _two_view(np.random.default_rng(7), planar=planar, noise_px=noise_px,
                     outlier_frac=outlier_frac)


@pytest.mark.parametrize("coherent", [False, True])
def test_essential_ransac_parity(coherent):
    cam, K, R_gt, t_gt, uv1, uv2, b1, b2 = _views(False, 0.5, 0.2)
    valid = np.ones(len(b1), bool)
    valid[::17] = False
    key = jax.random.PRNGKey(5)
    if coherent:
        Ej, inj, sj = jransac.essential_ransac_coherent(
            jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(uv1, jnp.float32),
            jnp.asarray(valid), key)
        Et, int_, st = transac.essential_ransac_coherent(
            T(b1), T(b2), T(uv1, torch.float32), T(valid), prng.PRNGKey(5))
    else:
        Ej, inj, sj = jransac.essential_ransac(jnp.asarray(b1), jnp.asarray(b2),
                                               jnp.asarray(valid), key)
        Et, int_, st = transac.essential_ransac(T(b1), T(b2), T(valid), prng.PRNGKey(5))
    # The coherent refit takes the smallest eigenvector of A^T diag(x) A,
    # whose eigenvalues span about 1e6 on noisy bearings: an f32 eigh
    # there resolves the vector to about 1e-3 in either package, so the
    # refit is held at 5e-3 (E) and 1e-2 (score); the MSAC seed at 1e-4.
    tol_e, tol_s = (5e-3, 1e-2) if coherent else (1e-4, 1e-4)
    assert _rel_up_to_sign(Et.numpy(), Ej) < tol_e
    assert (int_.numpy() == np.asarray(inj)).all()
    assert _rel(st.numpy(), sj) < tol_s

    # Decomposition: the same 4 candidates as a set.
    Rj, tj = jransac.decompose_essential(Ej)
    Rt, tt = transac.decompose_essential(T(np.asarray(Ej)))
    _assert_same_set(Rj, tj, Rt, tt)

    # Cheirality on the same candidates: same pick, same good mask.
    _assert_same_pick(Rj, tj, b1, b2, inj)


@pytest.mark.parametrize("coherent", [False, True])
def test_homography_ransac_parity(coherent):
    cam, K, R_gt, t_gt, uv1, uv2, b1, b2 = _views(True, 0.3, 0.1)
    valid = np.ones(len(b1), bool)
    valid[::13] = False
    p1, p2 = uv1.astype(np.float32), uv2.astype(np.float32)
    fj = jransac.homography_ransac_coherent if coherent else jransac.homography_ransac
    ft = transac.homography_ransac_coherent if coherent else transac.homography_ransac
    Hj, inj, sj = fj(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                     jax.random.PRNGKey(9))
    Ht, int_, st = ft(T(p1), T(p2), T(valid), prng.PRNGKey(9))
    assert _rel(Ht.numpy(), Hj) < 1e-4  # normalized by H[2, 2]: no sign freedom
    assert (int_.numpy() == np.asarray(inj)).all()
    assert _rel(st.numpy(), sj) < 1e-4

    Kf = np.asarray(K, np.float32)
    Rj, tj = jransac.decompose_homography(Hj, jnp.asarray(Kf))
    Rt, tt = transac.decompose_homography(T(np.asarray(Hj)), T(Kf))
    _assert_same_set(Rj, tj, Rt, tt)
    _assert_same_pick(Rj, tj, b1, b2, inj)


def _assert_same_set(Rj, tj, Rt, tt):
    Rj, tj = np.asarray(Rj), np.asarray(tj)
    Rt, tt = Rt.numpy(), tt.numpy()
    for R, t in zip(Rt, tt):
        d = [np.abs(R - Ra).max() + np.abs(t - ta).max() for Ra, ta in zip(Rj, tj)]
        assert min(d) < 1e-4, min(d)
    for R, t in zip(Rj, tj):
        d = [np.abs(R - Rb).max() + np.abs(t - tb).max() for Rb, tb in zip(Rt, tt)]
        assert min(d) < 1e-4, min(d)


def _assert_same_pick(Rs, ts, b1, b2, inliers):
    Rj, tj, pj, gj, cj = jransac.select_pose_by_cheirality(
        Rs, ts, jnp.asarray(b1), jnp.asarray(b2), inliers)
    Rt, tt, pt, gt, ct = transac.select_pose_by_cheirality(
        T(np.asarray(Rs)), T(np.asarray(ts)), T(b1), T(b2), T(np.asarray(inliers)))
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-4
    assert (gt.numpy() == np.asarray(gj)).all()
    assert int(ct) == int(cj) > 0
    g = np.asarray(gj)
    assert _rel(pt.numpy()[g], np.asarray(pj)[g]) < 1e-4


def test_homography_4pt_and_transfer_error():
    rng = np.random.default_rng(11)
    p1 = rng.uniform(0, 320, (16, 4, 2)).astype(np.float32)
    p2 = (p1 + rng.normal(0, 8, p1.shape)).astype(np.float32)
    Hj = np.asarray(jransac.homography_4pt(jnp.asarray(p1), jnp.asarray(p2)))
    Ht = transac.homography_4pt(T(p1), T(p2)).numpy()
    assert _rel(Ht, Hj) < 1e-4
    q1 = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    q2 = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    ej = np.asarray(jransac.homography_transfer_error(jnp.asarray(Hj), jnp.asarray(q1),
                                                      jnp.asarray(q2)))
    et = transac.homography_transfer_error(T(Hj), T(q1), T(q2)).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-4)


# ---------------------------------------------------------------------------
# ops/matching: area matching for monocular init
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _frame_pair():
    from tests.test_torch_mono import jax_feats

    return jax_feats(0), jax_feats(3)


def test_match_in_area_exact():
    f1, f2 = _frame_pair()
    mj = np.asarray(jmatching.match_in_area(
        f1["xy"], f1["angle"], jmatching.unpack_desc_bits(f1["desc"]), f1["valid"],
        f2["xy"], f2["angle"], jmatching.unpack_desc_bits(f2["desc"]), f2["valid"],
        window=100.0, max_hamming=50, ratio=0.9))
    t1 = {k: T(v) for k, v in f1.items()}
    t2 = {k: T(v) for k, v in f2.items()}
    mt = tmatching.match_in_area(
        t1["xy"], t1["angle"], tmatching.unpack_desc_bits(t1["desc"]), t1["valid"],
        t2["xy"], t2["angle"], tmatching.unpack_desc_bits(t2["desc"]), t2["valid"],
        window=100.0, max_hamming=50, ratio=0.9).numpy()
    assert (mt == mj).all()
    assert (mj >= 0).sum() > 100


def test_rotation_histogram_exact_with_ties():
    """Random orientations (wrapping negatives) and a histogram whose
    counts tie, so top-3 order matters."""
    rng = np.random.default_rng(5)
    n = 400
    a1 = rng.uniform(-7, 7, n).astype(np.float32)
    a2 = rng.uniform(-7, 7, n).astype(np.float32)
    # Exact ties: equal counts in several bins.
    a2[:60] = a1[:60] - np.float32(0.1)
    a2[60:120] = a1[60:120] - np.float32(1.1)
    m = np.where(rng.uniform(size=n) < 0.8, rng.permutation(n), -1).astype(np.int32)
    mj = np.asarray(jmatching.filter_by_rotation_histogram(
        jnp.asarray(m), jnp.asarray(a1), jnp.asarray(a2)))
    mt = tmatching.filter_by_rotation_histogram(T(m), T(a1), T(a2)).numpy()
    assert (mt == mj).all()
