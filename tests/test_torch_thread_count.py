"""The port's CPU results do not follow the torch thread count (ROADMAP C45).

torch's CPU reduction to one value splits its sum across threads past
32768 elements, MKL's product splits a long contraction whose output is
small, and MKL's Cholesky factorization past ~128 rows splits its
updates, so their last bits follow ``torch.set_num_threads``. The port
sums those places in a fixed order on the CPU
(``utils/types.fixed_order_sum``) and factors with scipy's LAPACK, which
XLA:CPU calls and torch's thread count does not reach
(``ops/linalg.block_cholesky_solve``).
Here the init and BA paths run at 1, 2 and 3 torch threads at the full
width of chip_smoke.py's monocular path (640x480, 1000 keypoints over 8
levels, 1,032 slots) and their outputs must be bit-identical: the
two-view init on the port frontend's features, local BA (the init's
with both iterations: the PyTorch one and the C source's), the
neighbours' triangulation and the motion-only pose solve on the map the
port System builds from the first two frames; and the loop path's dense
solves, the global BA's reduced camera system (64 keyframes, 384 rows)
and the pose graph's Gauss-Newton (a 32-keyframe circle, 224 rows). The
slow case runs the
whole 40-frame monocular System at 1 and 3 threads: one trajectory, one
ATE.
"""

import functools

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.io import trajectory as traj_io
from structure_plp_slam_tpu_torch.models import (global_ba, initializer, mapper, pose_graph,
                                                 pose_opt)
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System
from structure_plp_slam_tpu_torch.testing import synthetic_scene
from structure_plp_slam_tpu_torch.utils import prng

THREADS = (1, 2, 3)
_KW = dict(name="b", cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5,
           fps=30.0, focal_x_baseline=0.0, depth_threshold=40.0, depthmap_factor=1.0)
CAM = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **_KW)
ORB = OrbParams(max_num_keypts=1000, num_levels=8)
SIZES = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=3,
             enable_loop_closing=False)


def _system():
    return System(Config(camera=CAM, orb=ORB, raw={}), device="cpu", **SIZES)


@functools.lru_cache(maxsize=None)
def _frames(n):
    return synthetic_scene.make_sequence(np.random.default_rng(42), CAM, n, step=0.08)


@functools.lru_cache(maxsize=1)
def _init_map():
    """The port System after frames 0-1 of numpy seed 42 (its two-view
    init and the init's BA): the System, its state and its frontend's
    features of frames 0-2."""
    frames, _ = _frames(3)
    slam = _system()
    slam.startup()
    for img, _, ts in frames[:2]:
        slam.feed_monocular_frame(img, ts)
    feats = [slam.frontend.mono(img) for img, _, _ in frames]
    return slam, slam.state, feats


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, ms.MapState):
        return [v for v in ms.to_numpy(x).values()]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return [x]


def _same_at_threads(fn):
    """``fn()`` at each of THREADS; every output bit-identical to the
    first run's. Returns the first run's output."""
    before = torch.get_num_threads()
    outs = []
    try:
        for n in THREADS:
            torch.set_num_threads(n)
            outs.append(_tensors(fn()))
    finally:
        torch.set_num_threads(before)
    for n, out in zip(THREADS[1:], outs[1:]):
        for i, (a, b) in enumerate(zip(outs[0], out, strict=True)):
            a, b = (np.asarray(v) for v in (a, b))
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), (
                f"output {i} differs between {THREADS[0]} and {n} torch threads")
    return outs[0]


@pytest.mark.parametrize("pair,key", [((0, 1), 0), ((0, 2), 1), ((0, 2), 2)])
def test_try_initialize_mono_same_at_threads(pair, key):
    _, _, feats = _init_map()
    out = _same_at_threads(lambda: initializer.try_initialize_mono(
        CAM, feats[pair[0]], feats[pair[1]], prng.PRNGKey(key)))
    assert int(out[-1]) > 100  # num_matches


def test_local_ba_same_at_threads():
    """The keyframe chain's local BA on the init map: a 32-camera window
    (a 192-row Schur system) over 4096 landmark slots."""
    slam, state, _ = _init_map()
    out = _same_at_threads(lambda: mapper.local_ba(
        CAM, state, 1, slam.frontend.inv_sigma_sq, return_cams=True))
    assert np.isfinite(float(out[-2]))  # chi2


def test_init_ba_same_at_threads():
    """The System's two-view BA after the init (8 cameras)."""
    slam, state, _ = _init_map()
    _same_at_threads(lambda: mapper.local_ba(CAM, state, 1, slam.frontend.inv_sigma_sq,
                                             max_opt=4, max_fix=4, max_lms=4096))


def test_init_ba_xla_cpu_same_at_threads():
    """The same BA as the System's init calls it (``_xla="init"``: the C
    source's XLA:CPU iteration, ``ops/ba_cpu``)."""
    slam, state, _ = _init_map()
    _same_at_threads(lambda: mapper.local_ba(CAM, state, 1, slam.frontend.inv_sigma_sq,
                                             max_opt=4, max_fix=4, max_lms=4096,
                                             _xla="init"))


def test_triangulate_with_neighbors_same_at_threads():
    slam, state, _ = _init_map()
    ind = ms.observation_indicator(state)
    _same_at_threads(lambda: mapper.triangulate_with_neighbors(
        CAM, state, 1, slam.next_lm, ind, num_neighbors=2, return_neighbors=True))


def test_optimize_pose_same_at_threads():
    """The tracker's stage-2 solve size: 8192 map points against one
    frame's observations, from a pose 2 cm and 0.5 degrees off. Both of
    the port's solves: the public ``optimize_pose`` (on the CPU the
    single-threaded C source, ``ops/pose_cpu``) and the PyTorch solve the
    card runs (``_optimize_pose_torch``), whose sums go through
    ``fixed_order_sum``."""
    rng = np.random.default_rng(3)
    n = 8192
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 9, n)], 1)
    uv = X[:, :2] / X[:, 2:] * 525.0 + [319.5, 239.5] + rng.normal(0, 0.7, (n, 2))
    ang = np.deg2rad(0.5)
    R0 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    valid = torch.from_numpy(rng.uniform(size=n) < 0.9)
    for solve in (pose_opt.optimize_pose, pose_opt._optimize_pose_torch):
        out = _same_at_threads(lambda solve=solve: solve(
            CAM, f(R0), f([0.02, 0.0, 0.0]), f(X), f(uv), f(-np.ones(n)), f(np.ones(n)), valid))
        assert np.abs(np.asarray(out[1])).max() < 5e-3  # back near t = 0


def test_global_ba_camera_solve_same_at_threads():
    """The global BA's reduced camera system at 64 keyframes (a 384-row
    Cholesky, past the size where MKL's splits its updates by thread):
    the blocks of a random SPD matrix, keyframe 0 fixed."""
    K = 64
    a = np.random.default_rng(5).normal(size=(6 * K, 6 * K + 8)).astype(np.float32)
    blocks = torch.from_numpy(a @ a.T).reshape(K, 6, K, 6).permute(0, 2, 1, 3)
    diag = torch.arange(K)
    Hcc = blocks[diag, diag].clone()
    S_red = -blocks.clone()
    S_red[diag, diag] = 0.0
    rhs = torch.from_numpy(np.random.default_rng(6).normal(size=(K, 6)).astype(np.float32))
    free = torch.arange(K) > 0
    out = _same_at_threads(lambda: global_ba._camera_solve(S_red, Hcc, rhs, free, 1e-4))
    dx = np.asarray(out[0])
    assert np.isfinite(dx).all() and not dx[0].any()


def test_pose_graph_same_at_threads():
    """The loop fix's dense pose graph on a 32-keyframe circle with two
    loop edges (tests/test_torch_loop.py's problem; a 224-row Cholesky
    per Gauss-Newton step)."""
    from tests.test_torch_loop import _circle_problem

    arrays, _ = _circle_problem(K=32)
    prob = pose_graph.PoseGraphProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    out = _same_at_threads(lambda: pose_graph.optimize_pose_graph(prob, num_iters=10))
    assert np.isfinite(np.asarray(out[1])).all()


@pytest.mark.slow
def test_full_width_mono_one_ate_across_threads():
    """chip_smoke.py's gated full-width monocular sequence (numpy seed 42,
    40 frames at 0.08 m a frame) through the port System at 1 and 3
    torch threads: the same trajectory, so one Sim3 ATE (printed)."""
    frames, poses = _frames(40)
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1).astype(np.float64))
          for i, (R, t) in enumerate(poses)]
    before = torch.get_num_threads()
    runs = []
    try:
        for n in (1, 3):
            torch.set_num_threads(n)
            slam = _system()
            slam.startup()
            for img, _, ts in frames:
                slam.feed_monocular_frame(img, ts)
            slam.shutdown()
            runs.append((slam.frame_trajectory(), slam.num_keyframes))
    finally:
        torch.set_num_threads(before)
    (ta, ka), (tb, kb) = runs
    assert ka == kb and len(ta) == len(tb)
    for (sa, pa), (sb, pb) in zip(ta, tb):
        assert sa == sb and np.array_equal(pa, pb)
    ate = traj_io.ate_rmse(ta, gt, align_scale=True)
    print(f"seed 42 at 640x480, 1 and 3 torch threads: {ka} keyframes, Sim3 ATE {ate:.6f} m")
    assert ate < 0.2
