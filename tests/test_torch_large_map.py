"""Port copies of the reference's large-K tests (ROADMAP A18).

``structure_plp_slam_tpu_torch/testing/large_map.py`` builds the
1024-keyframe chain map of tests/test_large_map_loop.py without JAX: its
arrays must equal ``_build_large_map``'s exactly for the same numpy seed.
The slow cases are the port's copies of
tests/test_large_map_loop.py::test_loop_correction_at_1024_keyframes (the
loop correction past K = 512: Sim3 propagation, the PCG pose graph, the
PCG global BA) and tests/test_pose_graph_scale.py::
test_pcg_pose_graph_large_k, with the originals' gates; run them with
``-m slow``.
"""

import time

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import pose_graph as tpg
from structure_plp_slam_tpu_torch.models.loop_closer import LoopCloser
from structure_plp_slam_tpu_torch.testing.large_map import build_large_map
from tests.test_large_map_loop import _build_large_map
from tests.test_torch_loop import N, T, port_camera

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [dict(), dict(K=40, lm_per_kf=8, N=32)])
def test_large_map_matches_reference_map(kw):
    jcam, jst, C_j = _build_large_map(np.random.default_rng(42), **kw)
    tcam, tst, C_t = build_large_map(np.random.default_rng(42), device="cpu", **kw)
    assert tcam == port_camera(jcam)
    assert (C_t == C_j).all()
    arrays = tms.to_numpy(tst)
    for f in jst._fields:
        a, b = arrays[f], np.asarray(getattr(jst, f))
        assert a.dtype == b.dtype and (a == b).all(), f


@pytest.mark.slow
def test_loop_correction_at_1024_keyframes(rng):
    K = 1024
    cam, state, C_gt = build_large_map(rng, K=K, device="cpu")

    # Drift in the later half (poses and their landmarks).
    T_t = np.array([1.2, 0.0, 0.6], np.float32)
    kf_cut = K // 2
    pose = N(state.kf_pose).copy()
    pose[kf_cut:, :, 3] += pose[kf_cut:, :, :3] @ (-T_t)
    lm = N(state.lm_pos).copy()
    lm[N(state.lm_ref_kf) >= kf_cut] += T_t
    state = state._replace(kf_pose=T(pose), lm_pos=T(lm))

    lc = LoopCloser(cam)
    kf_cur = K - 1
    # The Sim3 between the drifted revisit and keyframe 0, supplied as the
    # original test does.
    P0 = N(state.kf_pose[0])
    R_true = np.eye(3, dtype=np.float32)
    t_true = (-R_true @ C_gt[K - 1]).astype(np.float32)
    A = P0[:, :3] @ R_true.T
    b = P0[:, 3] - A @ t_true
    t0 = time.time()
    state2 = lc.correct(state, kf_cur, 0, A.astype(np.float32), b.astype(np.float32), 1.0,
                        np.ones(8, np.float32))
    wall = time.time() - t0
    pose2 = N(state2.kf_pose)
    assert np.all(np.isfinite(pose2))
    assert np.all(np.isfinite(N(state2.lm_pos)))
    C_last = -pose2[kf_cur, :, :3].T @ pose2[kf_cur, :, 3]
    err_after = np.linalg.norm(C_last - C_gt[K - 1])
    assert err_after < 0.4, f"revisit err {err_after} after correction"
    assert lc.num_loops_closed == 1
    print(f"\n1024-kf loop correction in {wall:.1f}s wall (CPU)")


@pytest.mark.slow
def test_pcg_pose_graph_large_k():
    from tests.test_pose_graph_scale import _circle_problem

    K = 1024
    prob, _, t_gt = _circle_problem(K=K, n_loop=4, noise=0.02)
    tp = tpg.PoseGraphProblem(**{f: T(np.asarray(getattr(prob, f))) for f in prob._fields})
    E = tp.edge_i.shape[0]
    chain_pos = np.r_[np.arange(K - 1), -np.ones(E - (K - 1))].astype(np.int64)
    _, t, _, _ = tpg.optimize_pose_graph_pcg(tp, torch.arange(K), torch.from_numpy(chain_pos),
                                             num_iters=20, cg_iters=30)
    err = np.max(np.linalg.norm(N(t) - t_gt, axis=-1))
    assert err < 5e-2, f"max translation error {err}"
