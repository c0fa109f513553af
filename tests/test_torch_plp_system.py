"""Port parity: RGB-D point + line + plane SLAM, System against System.

Both packages' ``System(with_lines=True)`` take the same 6 rendered
RGB-D frames of the grid-textured scene (320x240, 600 keypoints over 4
levels, 16 keyframes / 4096 landmarks, ``max_kf_interval=2``, loop
closing off), each with the instance mask ``np.where(depth < 4.5, 1, 2)``.
Per-frame poses must agree within 1e-3 m and 1e-3 rad, the keyframe,
line and plane counts must be equal, and plane ownership must be equal on
at least 99% of the landmarks paired by position (nearest within 1 cm),
and slot by slot: with the frontends equal (ROADMAP C8) the two Systems
fill the same landmark slots here (C32).

The slow tests run the JAX package's PLP system tests
(tests/test_planes.py::test_rgbd_plane_slam, tests/test_line_system.py's
RGB-D and monocular runs, tests/test_stereo_line_system.py and
tests/test_init_structures.py's two cases) on both Systems, with the JAX
tests' own sequences and assertions.
"""

import functools

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.io import trajectory as jtraj
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System
from structure_plp_slam_tpu_torch.testing import synthetic_scene as tscene
from tests import synthetic_scene

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, depth_threshold=400.0, depthmap_factor=1.0)
NUM_FRAMES = 6
SIZES = dict(max_keyframes=16, max_landmarks=4096, enable_loop_closing=False, track_lag=2,
             max_kf_interval=2, with_lines=True)


def _seg(depth):
    return np.where(depth < 4.5, 1, 2).astype(np.int32)


def _camera(package, setup, focal_x_baseline):
    if package == "jax":
        return JCamera(setup=getattr(JSetup, setup), model=JModel.PERSPECTIVE,
                       focal_x_baseline=focal_x_baseline, **_KW)
    return Camera(setup=getattr(CameraSetup, setup), model=CameraModel.PERSPECTIVE,
                  focal_x_baseline=focal_x_baseline, **_KW)


def make_system(package, setup="RGBD", focal_x_baseline=26.0, **kw):
    """A System of either package on the tests' 320x240 camera. The JAX
    System keeps its global BA off the CPU device mesh (ROADMAP A17)."""
    cam = _camera(package, setup, focal_x_baseline)
    if package == "jax":
        cfg = JConfig(camera=cam, orb=JOrb(max_num_keypts=600, num_levels=4), raw={})
        return JSystem(cfg, distributed_ba=False, **kw)
    cfg = Config(camera=cam, orb=OrbParams(max_num_keypts=600, num_levels=4), raw={})
    return System(cfg, device="cpu", **kw)


@functools.lru_cache(maxsize=1)
def _frames():
    tex = synthetic_scene.make_texture(np.random.default_rng(0), grid=True)
    cam = _camera("jax", "RGBD", 26.0)
    out = []
    for i, (R, t) in enumerate(synthetic_scene.trajectory(NUM_FRAMES, step=0.06)):
        img, depth = synthetic_scene.render(cam, tex, R, t)
        out.append((img, depth, i / 30.0))
    return out


def _run(slam):
    slam.startup()
    poses = []
    for img, depth, ts in _frames():
        out = slam.feed_RGBD_frame(img, depth, ts, seg_mask=_seg(depth))
        poses.append(None if out is None else np.array(out))
    slam.shutdown()
    return poses


@functools.lru_cache(maxsize=1)
def run_jax():
    js = make_system("jax", **SIZES)
    return js, _run(js)


@functools.lru_cache(maxsize=1)
def run_port():
    ts = make_system("port", **SIZES)
    tfm.reset_counts()
    poses = _run(ts)
    return ts, poses, tfm.fused_match.calls, tfm.fused_match.launches


def _rot_angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)))


def test_plp_poses_match_jax():
    js, jposes = run_jax()
    ts, tposes, _, _ = run_port()
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        assert (a is None) == (b is None), f"frame {i}"
        if a is not None:
            dt = np.linalg.norm(a[:, 3] - b[:, 3])
            dr = _rot_angle(a[:, :3], b[:, :3])
            assert dt < 1e-3 and dr < 1e-3, f"frame {i}: {dt:.2e} m, {dr:.2e} rad"
    for (ta, pa), (tb, pb) in zip(js.frame_trajectory(), ts.frame_trajectory()):
        assert ta == tb
        assert np.abs(pa - pb).max() < 1e-3
    assert ts.tracking_state.value == js.tracking_state.value == "Tracking"


def test_plp_counts_match_jax():
    js, _ = run_jax()
    ts, _, _, _ = run_port()
    mj, mt = js.metrics(), ts.metrics()
    for k in ("keyframes", "lines", "planes"):
        assert mt[k] == mj[k], (k, mt[k], mj[k])
    assert int(ts.next_line) == int(js.next_line) >= 20
    assert int(ts.next_plane) == int(js.next_plane) >= 1
    assert mt["planes"] >= 1 and mt["lines"] >= 20
    assert abs(mt["landmarks"] - mj["landmarks"]) <= 0.02 * mj["landmarks"]


def test_plp_plane_ownership_matches_jax():
    """Ownership paired by position, and, with the frontends equal (ROADMAP
    C8, C32), slot by slot: the same valid slots, positions within 1e-3
    m and the same plane per slot."""
    js, _ = run_jax()
    ts, _, _, _ = run_port()
    jst, tst = js.state, ts.state
    vj, vt = np.asarray(jst.lm_valid), tst.lm_valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(tst.lm_pos.numpy()[vj], np.asarray(jst.lm_pos)[vj], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(tst.lm_plane.numpy()[vj], np.asarray(jst.lm_plane)[vj])
    d, ii = cKDTree(np.asarray(jst.lm_pos)[vj]).query(tst.lm_pos.numpy()[vt])
    paired = d < 1e-2
    assert paired.mean() > 0.99
    own_j = np.asarray(jst.lm_plane)[np.flatnonzero(vj)[ii[paired]]]
    own_t = tst.lm_plane.numpy()[np.flatnonzero(vt)[paired]]
    assert (own_j == own_t).mean() >= 0.99
    assert (own_t >= 0).sum() > 30
    pv = np.asarray(jst.pl_valid)
    np.testing.assert_array_equal(tst.pl_valid.numpy(), pv)
    a, b = np.asarray(jst.pl_coef)[pv], tst.pl_coef.numpy()[pv]
    assert np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1)).max() < 1e-3


def test_plp_went_through_matcher_and_stages():
    """Three matcher calls per tracked frame and one per keyframe chain
    (the plain version on CPU tensors); the line and plane stages ran."""
    ts, _, calls, launches = run_port()
    assert calls == 3 * ts.num_track_steps + ts.next_kf - 1
    assert launches == 0
    timing = ts.metrics()["timing"]
    assert timing["keyframe.lines"]["count"] == timing["keyframe.planes"]["count"] == \
        ts.next_kf - 1


def test_port_grid_texture_matches_test_helper():
    j = synthetic_scene.make_texture(np.random.default_rng(0), grid=True)
    t = tscene.make_texture(np.random.default_rng(0), grid=True)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-2)  # the blur's f32 sums


# ---------------------------------------------------------------------------
# The JAX package's PLP system tests on both Systems (slow).
# ---------------------------------------------------------------------------


def _gt(poses):
    return [(i / 30.0, np.concatenate([R, t[:, None]], 1).astype(np.float64))
            for i, (R, t) in enumerate(poses)]


def _ate(slam, poses, align_scale):
    return jtraj.ate_rmse(slam.frame_trajectory(), _gt(poses), align_scale=align_scale)


def _grid_frames(rng, package, setup, num_frames, step, baseline=None, grid=True):
    tex = synthetic_scene.make_texture(rng, grid=grid)
    cam = _camera(package, setup, 0.0)
    poses = synthetic_scene.trajectory(num_frames, step=step)
    frames = []
    for i, (R, t) in enumerate(poses):
        img, depth = synthetic_scene.render(cam, tex, R, t)
        right = None
        if baseline is not None:
            right, _ = synthetic_scene.render(cam, tex, R, t - np.array([baseline, 0.0, 0.0]))
        frames.append((img, depth, right, i / 30.0))
    return frames, poses


def _line_z(slam):
    st = slam.state
    eps = np.asarray(st.ln_endpoints)[np.asarray(st.ln_valid)]
    return np.concatenate([eps[:, 2], eps[:, 5]]), eps


PACKAGES = pytest.mark.parametrize("package", ["jax", "port"])


@pytest.mark.slow
@PACKAGES
def test_rgbd_plane_slam(package):
    frames, _ = _grid_frames(np.random.default_rng(42), package, "RGBD", 10, 0.06, grid=False)
    slam = make_system(package, "RGBD", 26.0, max_keyframes=32, max_landmarks=8192,
                       max_kf_interval=2)
    slam.startup()
    for img, depth, _, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts, seg_mask=_seg(depth))
    slam.shutdown()
    assert slam.tracking_state.value == "Tracking"
    st = slam.state
    pl_valid = np.asarray(st.pl_valid)
    assert pl_valid.sum() >= 1
    for c in np.asarray(st.pl_coef)[pl_valid]:
        n, d = (c[:3], c[3]) if c[2] >= 0 else (-c[:3], -c[3])
        assert abs(n[2]) > 0.98, n
        assert min(abs(-d - 3.5), abs(-d - 6.0)) < 0.3, d
    assert (np.asarray(st.lm_plane) >= 0).sum() > 30


@pytest.mark.slow
@PACKAGES
def test_rgbd_point_line_slam(package):
    frames, poses = _grid_frames(np.random.default_rng(42), package, "RGBD", 12, 0.06)
    slam = make_system(package, "RGBD", 26.0, max_keyframes=32, max_landmarks=8192,
                       max_kf_interval=2, with_lines=True)
    slam.startup()
    for img, depth, _, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
    slam.shutdown()
    assert slam.tracking_state.value == "Tracking"
    assert int(slam.next_line) >= 4
    z, _ = _line_z(slam)
    assert ((np.abs(z - 6.0) < 0.4) | (np.abs(z - 3.5) < 0.4)).mean() > 0.6, z
    assert _ate(slam, poses, False) < 0.06


@pytest.mark.slow
@PACKAGES
def test_mono_point_line_slam(package):
    frames, poses = _grid_frames(np.random.default_rng(42), package, "MONOCULAR", 16, 0.08)
    slam = make_system(package, "MONOCULAR", 0.0, max_keyframes=32, max_landmarks=8192,
                       max_kf_interval=3, with_lines=True)
    slam.startup()
    for img, _, _, ts in frames:
        slam.feed_monocular_frame(img, ts)
    slam.shutdown()
    assert slam.tracking_state.value == "Tracking"
    est = slam.frame_trajectory()
    assert _ate(slam, poses, True) < 0.08
    assert int(slam.next_line) >= 3
    # Sim3-align the map to ground truth through the camera centres.
    gt_C = np.stack([-R.T @ t for R, t in poses])
    est_C = np.stack([-p[:, :3].T @ p[:, 3] for _, p in est])
    n = min(len(gt_C), len(est_C))
    A, B = est_C[:n], gt_C[:n]
    mA, mB = A.mean(0), B.mean(0)
    U, D, Vt = np.linalg.svd((B - mB).T @ (A - mA) / n)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R_al = U @ S @ Vt
    s_al = np.trace(np.diag(D) @ S) / ((A - mA) ** 2).mean(0).sum()
    t_al = mB - s_al * R_al @ mA
    _, eps = _line_z(slam)
    pts = np.concatenate([eps[:, :3], eps[:, 3:]])
    z = (s_al * (R_al @ pts.T)).T[:, 2] + t_al[2]
    assert ((np.abs(z - 6.0) < 0.5) | (np.abs(z - 3.5) < 0.5)).mean() > 0.6, z


@pytest.mark.slow
@PACKAGES
def test_stereo_point_line_slam(package):
    frames, poses = _grid_frames(np.random.default_rng(42), package, "STEREO", 12, 0.06,
                                 baseline=0.1)
    slam = make_system(package, "STEREO", 26.0, max_keyframes=32, max_landmarks=8192,
                       max_kf_interval=2, with_lines=True)
    slam.startup()
    for img, _, right, ts in frames:
        slam.feed_stereo_frame(img, right, ts)
    slam.shutdown()
    assert slam.tracking_state.value == "Tracking"
    assert int(slam.next_line) >= 4
    z, _ = _line_z(slam)
    assert len(z) >= 8
    assert ((np.abs(z - 6.0) < 0.5) | (np.abs(z - 3.5) < 0.5)).mean() > 0.6, z
    assert _ate(slam, poses, False) < 0.06
    assert slam.num_landmarks > 200


@pytest.mark.slow
@PACKAGES
@pytest.mark.parametrize("setup", ["RGBD", "MONOCULAR"])
def test_init_creates_planes_and_lines(package, setup):
    frames, _ = _grid_frames(np.random.default_rng(42), package, setup,
                             2 if setup == "RGBD" else 8, 0.06 if setup == "RGBD" else 0.08)
    slam = make_system(package, setup, 26.0 if setup == "RGBD" else 0.0, max_keyframes=16,
                       max_landmarks=8192, with_lines=True)
    slam.startup()
    for img, depth, _, ts in frames:
        if setup == "RGBD":
            slam.feed_RGBD_frame(img, depth, ts, seg_mask=_seg(depth))
            break
        slam.feed_monocular_frame(img, ts, seg_mask=_seg(depth))
        if slam.tracking_state.value == "Tracking":
            break
    assert slam.tracking_state.value == "Tracking"
    m = slam.metrics()
    assert m["planes"] >= 1, m
    assert m["lines"] >= 1, m
    slam.shutdown()


@pytest.mark.slow
def test_full_width_mono_lines_matches_jax():
    """chip_smoke.py's phase 12 (b) at full width on the CPU: monocular
    points + lines at 640x480 (1000 keypoints over 8 levels), 16 frames
    at 0.08 m a frame of the grid-textured scene (numpy seed 42),
    ``max_kf_interval=3``, loop closing off; capacities cut to the JAX
    test's 32 keyframes / 8192 landmarks. With the frontends bit-equal
    (ROADMAP C8) both Systems initialize on the same frame pair and end
    at the same Sim3 ATE within 1e-3 m (printed)."""
    kw = dict(_KW, cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)
    frames, poses = None, None
    out = {}
    for package in ("jax", "port"):
        if package == "jax":
            cam = JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE,
                          focal_x_baseline=0.0, **kw)
            slam = JSystem(JConfig(camera=cam, orb=JOrb(max_num_keypts=1000, num_levels=8),
                                   raw={}), distributed_ba=False, max_keyframes=32,
                           max_landmarks=8192, max_kf_interval=3, with_lines=True,
                           enable_loop_closing=False)
        else:
            cam = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE,
                         focal_x_baseline=0.0, **kw)
            slam = System(Config(camera=cam, orb=OrbParams(max_num_keypts=1000, num_levels=8),
                                 raw={}), device="cpu", max_keyframes=32, max_landmarks=8192,
                          max_kf_interval=3, with_lines=True, enable_loop_closing=False)
        if frames is None:
            tex = synthetic_scene.make_texture(np.random.default_rng(42), grid=True)
            poses = synthetic_scene.trajectory(16, step=0.08)
            frames = [(synthetic_scene.render(cam, tex, R, t)[0], i / 30.0)
                      for i, (R, t) in enumerate(poses)]
        slam.startup()
        for img, ts in frames:
            slam.feed_monocular_frame(img, ts)
        slam.shutdown()
        est = slam.frame_trajectory()
        out[package] = (slam.tracking_state.value, round(est[0][0] * 30), _ate(slam, poses, True),
                        int(slam.next_line), slam.num_keyframes)
        print(f"{package} System: state {out[package][0]}, trajectory from frame "
              f"{out[package][1]}, Sim3 ATE {out[package][2]:.6f} m, lines created "
              f"{out[package][3]}, keyframes {out[package][4]}")
    j, t = out["jax"], out["port"]
    assert t[0] == j[0] == "Tracking"
    assert t[1] == j[1] and t[3] == j[3] and t[4] == j[4], (j, t)
    assert abs(t[2] - j[2]) < 1e-3, (j, t)
