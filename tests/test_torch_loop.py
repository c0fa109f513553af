"""Port parity: the loop-closing building blocks.

The same numpy-seeded inputs go through the JAX function and the port's.
Tolerances:

* Sim(3) exp / log / compose / inverse / apply: 1e-5 (f32 transcendental
  and 3x3 sums in another order);
* Umeyama: 1e-4 (3x3 SVDs from XLA and LAPACK);
* ``sim3_ransac``: minimal sets bit-equal (``utils/prng``), the same
  winning hypothesis (inlier count and mask exact), R / t / s within
  1e-4; a case where most draws repeat a point shows the rule of ROADMAP
  C16 (the port scores those sets 0);
* ``refine_sim3``: inlier mask exact, R / t / s within 1e-4;
* pose graph, dense and PCG, against the JAX solvers: poses within 1e-4
  (20 Gauss-Newton steps of f32 Cholesky or CG, scatter sums in another
  order), and the port's PCG against its dense solve at the JAX test's
  bounds; block cyclic reduction against a dense solve at 1e-3;
* global BA, dense, PCG and on 8 landmark shards: the prepared
  observation and pair lists exactly equal, poses within 1e-4 of the JAX
  solver's and landmarks within 1e-3 (ten damped Gauss-Newton steps,
  f32), the port's PCG against its dense solve at the JAX test's bounds
  (5e-3, 2e-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.models import global_ba as jgba
from structure_plp_slam_tpu.models import pose_graph as jpg
from structure_plp_slam_tpu.ops import lie as jlie
from structure_plp_slam_tpu.ops import ransac as jransac
from structure_plp_slam_tpu.ops import sim3_solver as jsim3
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import global_ba as tgba
from structure_plp_slam_tpu_torch.models import pose_graph as tpg
from structure_plp_slam_tpu_torch.ops import lie as tlie
from structure_plp_slam_tpu_torch.ops import ransac as transac
from structure_plp_slam_tpu_torch.ops import sim3_solver as tsim3
from structure_plp_slam_tpu_torch.utils import prng
from tests.helpers import create_random_landmarks, make_camera
from tests.test_global_ba import _make_state

torch.set_num_threads(2)

JCAM = make_camera()


def port_camera(jc):
    """The port's Camera with the JAX Camera's fields."""
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(Camera)}
    return Camera(**{**kw, "setup": CameraSetup(jc.setup.value),
                     "model": CameraModel(jc.model.value)})


TCAM = port_camera(JCAM)


def T(a, dtype=None):
    a = np.array(a)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def N(t):
    return t.detach().cpu().numpy()


def _sim3_batch(rng, n=64):
    """Sim(3) tangents with the small-angle and small-scale branches hit."""
    xi = (rng.normal(size=(n, 7)) * 0.5).astype(np.float32)
    xi[:8, 6] = 1e-7
    xi[8:16, 3:6] = 1e-7
    xi[16:20, 3:7] = 0.0
    return xi


def test_sim3_group_parity():
    rng = np.random.default_rng(0)
    xa, xb = _sim3_batch(rng), _sim3_batch(rng)
    ja, jb = jlie.sim3_exp(jnp.asarray(xa)), jlie.sim3_exp(jnp.asarray(xb))
    ta, tb = tlie.sim3_exp(T(xa)), tlie.sim3_exp(T(xb))
    pts = rng.normal(size=(64, 5, 3)).astype(np.float32)
    pairs = [
        (ja, ta),
        (jlie.sim3_compose(*ja, *jb), tlie.sim3_compose(*ta, *tb)),
        (jlie.sim3_inverse(*ja), tlie.sim3_inverse(*ta)),
        ((jlie.sim3_log(*ja),), (tlie.sim3_log(*ta),)),
        ((jlie.sim3_apply(*ja, jnp.asarray(pts)),), (tlie.sim3_apply(*ta, T(pts)),)),
    ]
    for j, t in pairs:
        for a, b in zip(j, t):
            np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-5, rtol=1e-5)
    # log inverts exp on the port as well (away from the angle wrap).
    np.testing.assert_allclose(N(tlie.sim3_log(*ta)), xa, atol=1e-5)


def test_umeyama_parity():
    rng = np.random.default_rng(1)
    P = rng.normal(size=(32, 6, 3)).astype(np.float32) * 2
    R = np.stack([N(tlie.so3_exp(T(rng.normal(size=3).astype(np.float32)))) for _ in range(32)])
    Q = (1.3 * np.einsum("bij,bnj->bni", R, P) + rng.normal(size=(32, 1, 3))
         + rng.normal(size=P.shape) * 0.01).astype(np.float32)
    for with_scale in (True, False):
        j = jsim3.umeyama_alignment(jnp.asarray(P), jnp.asarray(Q), with_scale=with_scale)
        t = tsim3.umeyama_alignment(T(P), T(Q), with_scale=with_scale)
        for a, b in zip(j, t):
            np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-4, rtol=1e-4)


def _sim3_problem(rng, n=150, n_out=30):
    """Points in camera 1, their Sim3 image in camera 2, both projected;
    ``n_out`` camera-2 points moved off (outliers)."""
    pts1 = create_random_landmarks(rng, n).astype(np.float32)
    R = N(tlie.so3_exp(T((rng.normal(size=3) * 0.1).astype(np.float32))))
    pts2 = (1.25 * pts1 @ R.T + np.array([0.4, -0.2, 0.6])).astype(np.float32)

    def proj(p):
        return np.stack([JCAM.fx * p[:, 0] / p[:, 2] + JCAM.cx,
                         JCAM.fy * p[:, 1] / p[:, 2] + JCAM.cy], 1).astype(np.float32)

    uv1, uv2 = proj(pts1), proj(pts2)
    out = rng.choice(n, n_out, replace=False)
    pts2[out] += rng.normal(scale=2.0, size=(n_out, 3)).astype(np.float32)
    sig1 = rng.choice(np.array([1.0, 1.44, 2.0736], np.float32), n)
    sig2 = rng.choice(np.array([1.0, 1.44, 2.0736], np.float32), n)
    return pts1, pts2, uv1, uv2, sig1, sig2, R


@pytest.mark.parametrize("seed", [0, 3])
def test_sim3_ransac_parity(seed):
    rng = np.random.default_rng(seed)
    pts1, pts2, uv1, uv2, sig1, sig2, R_gt = _sim3_problem(rng)
    valid = rng.uniform(size=len(pts1)) < 0.9
    args = (pts1, pts2, uv1, uv2, sig1, sig2, valid)
    idx_j = np.asarray(jax.jit(jransac.sample_minimal_sets, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(seed), tsim3.NUM_HYPOTHESES, 3, len(pts1), jnp.asarray(valid)))
    idx_t = transac.sample_minimal_sets(prng.PRNGKey(seed), tsim3.NUM_HYPOTHESES, 3,
                                        len(pts1), T(valid))
    assert (N(idx_t) == idx_j).all()
    Rj, tj, sj, inj, nj = jsim3.sim3_ransac(JCAM, *(jnp.asarray(a) for a in args),
                                            jax.random.PRNGKey(seed))
    Rt, tt, st, int_, nt = tsim3.sim3_ransac(TCAM, *(T(a) for a in args), prng.PRNGKey(seed))
    assert int(nt) == int(nj) > 100
    assert (N(int_) == np.asarray(inj)).all()
    for a, b in ((Rj, Rt), (tj, tt), (sj, st)):
        np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(N(Rt), R_gt, atol=5e-3)

    # refine_sim3 from the RANSAC result.
    rj = jsim3.refine_sim3(JCAM, Rj, tj, sj, *(jnp.asarray(a) for a in args[:4]), inj)
    rt = tsim3.refine_sim3(TCAM, Rt, tt, st, *(T(a) for a in args[:4]), int_)
    assert (N(rt[3]) == np.asarray(rj[3])).all() and int(rt[4]) == int(rj[4])
    for a, b in zip(rj[:3], rt[:3]):
        np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-4, rtol=1e-4)


def test_sim3_ransac_repeated_draws_score_zero():
    """ROADMAP C16: with 4 valid points most 3-point sets repeat one, which
    leaves Umeyama's rotation undetermined. The port scores every such set
    0, so its winner is the first set of distinct points with the best
    count (here every distinct set fits all 4 points exactly)."""
    rng = np.random.default_rng(7)
    pts1, pts2, uv1, uv2, sig1, sig2, R_gt = _sim3_problem(rng, n=40, n_out=0)
    valid = np.zeros(40, bool)
    valid[[3, 11, 17, 29]] = True
    key = prng.PRNGKey(4)
    idx = transac.sample_minimal_sets(key, tsim3.NUM_HYPOTHESES, 3, 40, T(valid))
    distinct = N(transac.distinct_sets(idx))
    assert 0 < distinct.sum() < len(distinct) and not distinct[0]
    Rt, tt, st, inl, n = tsim3.sim3_ransac(TCAM, T(pts1), T(pts2), T(uv1), T(uv2), T(sig1),
                                           T(sig2), T(valid), key)
    assert int(n) == 4 and (N(inl) == valid).all()
    R_all, _, _ = tsim3.umeyama_alignment(T(pts1)[idx], T(pts2)[idx])
    first = int(np.argmax(distinct))
    np.testing.assert_allclose(N(Rt), N(R_all[first]), atol=1e-6)
    np.testing.assert_allclose(N(Rt), R_gt, atol=1e-4)


# ---------------------------------------------------------------------------
# Pose graph.
# ---------------------------------------------------------------------------


def _rot(phi):
    return N(tlie.so3_exp(T(np.asarray(phi, np.float32))))


def _chain_problem(rng, K=12, drift=0.02):
    """tests/test_loop_ops.py's keyframe chain with accumulated drift and
    one loop edge back to 0 (weight 5), as problem arrays."""
    R_gt, t_gt = [np.eye(3)], [np.zeros(3)]
    for _ in range(1, K):
        dR = _rot([0.0, 0.25, 0.0])
        R_gt.append(dR @ R_gt[-1])
        t_gt.append(np.array([0.0, 0.0, 0.4]) + dR @ t_gt[-1])
    R_est, t_est, edges = [np.eye(3)], [np.zeros(3)], []
    for k in range(1, K):
        R_rel = R_gt[k] @ R_gt[k - 1].T
        t_rel = t_gt[k] - R_rel @ t_gt[k - 1]
        edges.append((k - 1, k, R_rel, t_rel, 1.0))
        nR = _rot(rng.normal(size=3) * drift)
        R_est.append(nR @ R_rel @ R_est[-1])
        t_est.append(nR @ (R_rel @ t_est[-1] + t_rel) + rng.normal(size=3) * drift)
    R_loop = R_gt[0] @ R_gt[K - 1].T
    edges.append((K - 1, 0, R_loop, t_gt[0] - R_loop @ t_gt[K - 1], 5.0))
    E = len(edges)
    return dict(
        R=np.stack(R_est).astype(np.float32), t=np.stack(t_est).astype(np.float32),
        s=np.ones(K, np.float32), fixed=np.arange(K) == 0, valid=np.ones(K, bool),
        edge_i=np.array([e[0] for e in edges], np.int32),
        edge_j=np.array([e[1] for e in edges], np.int32),
        edge_R=np.stack([e[2] for e in edges]).astype(np.float32),
        edge_t=np.stack([e[3] for e in edges]).astype(np.float32),
        edge_s=np.ones(E, np.float32), edge_valid=np.ones(E, bool),
        edge_weight=np.array([e[4] for e in edges], np.float32),
    ), np.stack(t_gt)


def _circle_problem(K=32, n_loop=2, noise=0.05, seed=0):
    """tests/test_pose_graph_scale.py's circle with loop closures; exact
    measurements, drift-perturbed estimates."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, K, endpoint=False)
    R_gt = np.zeros((K, 3, 3), np.float32)
    t_gt = np.zeros((K, 3), np.float32)
    for k in range(K):
        c, s = np.cos(theta[k]), np.sin(theta[k])
        Rwc = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        R_gt[k] = Rwc.T
        t_gt[k] = -Rwc.T @ np.array([5 * c, 5 * s, 0], np.float32)
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(1, K):
        R0[k] = _rot(rng.normal(size=3) * noise * (k / K)) @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(size=3).astype(np.float32) * noise * 5 * (k / K)
    ei = list(range(K - 1)) + [K - 1] + [int(k) for k in rng.integers(0, K // 2, n_loop)]
    ej = list(range(1, K)) + [0] + [int(k) for k in rng.integers(K // 2, K, n_loop)]
    E = len(ei)
    eR = np.stack([R_gt[j] @ R_gt[i].T for i, j in zip(ei, ej)]).astype(np.float32)
    et = np.stack([t_gt[j] - eR[e] @ t_gt[i] for e, (i, j) in enumerate(zip(ei, ej))])
    return dict(
        R=R0, t=t0, s=np.ones(K, np.float32), fixed=np.arange(K) == 0, valid=np.ones(K, bool),
        edge_i=np.array(ei, np.int32), edge_j=np.array(ej, np.int32), edge_R=eR,
        edge_t=et.astype(np.float32), edge_s=np.ones(E, np.float32),
        edge_valid=np.ones(E, bool), edge_weight=np.ones(E, np.float32),
    ), t_gt


def _problems(arrays):
    return (jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tpg.PoseGraphProblem(**{k: T(v) for k, v in arrays.items()}))


def _assert_poses_close(j, t, atol):
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(N(b), np.asarray(a), atol=atol, rtol=atol)


def test_pose_graph_dense_parity():
    arrays, t_gt = _chain_problem(np.random.default_rng(42))
    jp, tp = _problems(arrays)
    j = jpg.optimize_pose_graph(jp, num_iters=25)
    t = tpg.optimize_pose_graph(tp, num_iters=25)
    _assert_poses_close(j, t, 1e-4)
    np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-3, atol=1e-6)
    # The loop edge pulled the drifted chain toward the truth.
    assert np.abs(N(t[1]) - t_gt).max() < 0.15


def test_pose_graph_jacobians_parity():
    """The forward-mode Jacobians of the Sim3 residual, edge by edge."""
    arrays, _ = _circle_problem(K=16)
    jp, tp = _problems(arrays)
    r, Ji, Jj = tpg._residual_and_jacobians(tp, tp.R, tp.t, tp.s)
    z = jnp.zeros((7,), jnp.float32)
    for e in range(tp.edge_i.shape[0]):
        i, j = int(arrays["edge_i"][e]), int(arrays["edge_j"][e])
        pose = (jp.R[i], jp.t[i], jp.s[i], jp.R[j], jp.t[j], jp.s[j],
                jp.edge_R[e], jp.edge_t[e], jp.edge_s[e])
        Ji_j = jax.jacfwd(lambda x: jpg._edge_residual(*pose, x, z))(z)
        Jj_j = jax.jacfwd(lambda x: jpg._edge_residual(*pose, z, x))(z)
        np.testing.assert_allclose(N(Ji[e]), np.asarray(Ji_j), atol=1e-4)
        np.testing.assert_allclose(N(Jj[e]), np.asarray(Jj_j), atol=1e-4)
        np.testing.assert_allclose(N(r[e]), np.asarray(jpg._edge_residual(*pose, z, z)),
                                   atol=1e-5)


def test_bcr_matches_dense_solve():
    rng = np.random.default_rng(3)
    n, d = 13, 7  # not a power of two: the factor pads
    A = np.zeros((n, d, d), np.float32)
    C = np.zeros((n, d, d), np.float32)
    B = np.zeros((n, d, d), np.float32)
    for i in range(n - 1):
        C[i] = rng.normal(size=(d, d)) * 0.3
        A[i + 1] = C[i].T
    for i in range(n):
        M = np.eye(d) * (d + 2.0) + rng.normal(size=(d, d)) * 0.1
        B[i] = (M + M.T) / 2
    b = rng.normal(size=(n, d)).astype(np.float32)
    Tm = np.zeros((n * d, n * d))
    for i in range(n):
        Tm[i * d:(i + 1) * d, i * d:(i + 1) * d] = B[i]
        if i + 1 < n:
            Tm[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = C[i]
            Tm[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = A[i + 1]
    x_dense = np.linalg.solve(Tm, b.reshape(-1)).reshape(n, d)
    x_t = N(tpg._bcr_apply(tpg._bcr_factor(T(B), T(A), T(C)), T(b)))
    x_j = np.asarray(jpg._bcr_apply(jpg._bcr_factor(jnp.asarray(B), jnp.asarray(A),
                                                    jnp.asarray(C)), jnp.asarray(b)))
    np.testing.assert_allclose(x_t, x_dense, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(x_t, x_j, atol=1e-5)


def test_pose_graph_pcg_parity():
    K = 32
    arrays, t_gt = _circle_problem(K=K)
    jp, tp = _problems(arrays)
    E = arrays["edge_i"].shape[0]
    chain = np.r_[np.arange(K - 1), -np.ones(E - (K - 1))].astype(np.int32)
    comp = np.arange(K, dtype=np.int32)
    j = jpg.optimize_pose_graph_pcg(jp, jnp.asarray(comp), jnp.asarray(chain))
    t = tpg.optimize_pose_graph_pcg(tp, T(comp), T(chain))
    _assert_poses_close(j, t, 1e-4)
    d = tpg.optimize_pose_graph(tp)
    # Both of the port's solvers recover the truth (exact measurements).
    assert np.linalg.norm(N(d[1]) - t_gt, axis=-1).max() < 1e-2
    assert np.linalg.norm(N(t[1]) - t_gt, axis=-1).max() < 1e-2
    np.testing.assert_allclose(N(t[2]), 1.0, atol=1e-3)


# ---------------------------------------------------------------------------
# Global BA.
# ---------------------------------------------------------------------------


def _ba_state(K=6, M=150, seed=42):
    """tests/test_global_ba.py's map (K keyframes all observing M
    landmarks, all but keyframe 0 perturbed) in both packages."""
    cam, jst, poses_gt, pts = _make_state(np.random.default_rng(seed), K=K, M=M)
    tst = tms.from_numpy({f: np.asarray(getattr(jst, f)) for f in jst._fields}, "cpu")
    return cam, jst, tst, poses_gt, pts


def test_global_ba_prepare_exact():
    cam, jst, tst, _, _ = _ba_state()
    table = np.array([1.0, 0.7, 0.5, 0.3, 0.2, 0.1, 0.1, 0.1], np.float32)
    dj = jgba.prepare(jst, table)
    dt = tgba.prepare(tst, table)
    assert dt.num_obs == dj.num_obs and dt.num_pairs == dj.num_pairs
    for f in ("obs_cam", "obs_lm", "obs_uv", "obs_xr", "obs_info", "pair_o1", "pair_o2"):
        assert (N(getattr(dt, f)) == np.asarray(getattr(dj, f))).all(), f
    c1j, c2j, rj = jgba.prepare_chain_pairs(dj, np.asarray(jst.kf_valid))
    c1t, c2t, rt = tgba.prepare_chain_pairs(dt, N(tst.kf_valid))
    assert (c1t == c1j).all() and (c2t == c2j).all() and (rt == rj).all()
    for a, b in zip(tgba.pad_chain_pairs(c1t, c2t), jgba.pad_chain_pairs(c1j, c2j)):
        assert (a == b).all()


def test_global_ba_dense_parity():
    cam, jst, tst, poses_gt, _ = _ba_state()
    table = np.ones(8, np.float32)
    sj = jgba.run_global_ba(cam, jst, table, anchor_kf=0, num_iters=8)
    st = tgba.run_global_ba(port_camera(cam), tst, table, anchor_kf=0, num_iters=8)
    np.testing.assert_allclose(N(st.kf_pose), np.asarray(sj.kf_pose), atol=1e-4)
    np.testing.assert_allclose(N(st.lm_pos), np.asarray(sj.lm_pos), atol=1e-3)
    for c, (R, t) in enumerate(poses_gt):  # the JAX test's convergence bounds
        assert np.linalg.norm(N(st.kf_pose[c, :, 3]) - t) < 0.05


def test_global_ba_pcg_parity():
    cam, jst, tst, _, pts = _ba_state(K=6, M=120)
    tcam = port_camera(cam)
    table = np.ones(8, np.float32)
    dj = jgba.prepare(jst, table)
    dt = tgba.prepare(tst, table)
    c1, c2, comp = tgba.prepare_chain_pairs(dt, N(tst.kf_valid))
    c1, c2 = tgba.pad_chain_pairs(c1, c2)
    K = tst.kf_pose.shape[0]
    fixed = np.arange(K) == 0
    pj = jgba.solve_pcg(cam, jst.kf_pose, jst.kf_valid, jnp.asarray(fixed), jst.lm_pos,
                        jst.lm_valid, dj, *(jnp.asarray(a, jnp.int32) for a in (c1, c2, comp)),
                        num_iters=8)
    pt = tgba.solve_pcg(tcam, tst.kf_pose, tst.kf_valid, T(fixed), tst.lm_pos, tst.lm_valid,
                        dt, T(c1), T(c2), T(comp), num_iters=8)
    np.testing.assert_allclose(N(pt[0]), np.asarray(pj[0]), atol=1e-4)
    np.testing.assert_allclose(N(pt[1]), np.asarray(pj[1]), atol=1e-3)
    dense = tgba.solve(tcam, tst.kf_pose, tst.kf_valid, T(fixed), tst.lm_pos, tst.lm_valid,
                       dt, num_iters=8)
    kv = N(tst.kf_valid)
    np.testing.assert_allclose(N(pt[0])[kv], N(dense[0])[kv], atol=5e-3)
    assert np.abs(N(pt[1])[:len(pts)] - N(dense[1])[:len(pts)]).max() < 2e-2


def test_global_ba_mesh_raises():
    """The mesh solve (ROADMAP A17, which raised until it was ported) on 8
    landmark shards equals the JAX package's on its 8 CPU devices."""
    from jax.sharding import Mesh

    from structure_plp_slam_tpu_torch.parallel.distributed_ba import LandmarkMesh

    cam, jst, tst, _, _ = _ba_state()
    table = np.ones(8, np.float32)
    sj = jgba.run_global_ba(cam, jst, table, num_iters=6,
                            mesh=Mesh(np.array(jax.devices()[:8]), ("lm",)))
    st = tgba.run_global_ba(port_camera(cam), tst, table, num_iters=6,
                            mesh=LandmarkMesh(["cpu"] * 8))
    np.testing.assert_allclose(N(st.kf_pose), np.asarray(sj.kf_pose), atol=1e-4)
    np.testing.assert_allclose(N(st.lm_pos), np.asarray(sj.lm_pos), atol=1e-3)
