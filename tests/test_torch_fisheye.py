"""Port parity: the fisheye (Kannala-Brandt) RGB-D System.

Both Systems take tests/test_fisheye_system.py's camera (320x240, fx = fy
= 240, k1..k4 = -0.05, 0.01, -0.003, 0.001), 600 keypoints over 4
levels and max_kf_interval=2, on frames from the port's fisheye renderer.
The JAX System runs its CPU branch (masked distance matrices), the port
its fused matcher, as on the perspective RGB-D path: per-frame poses
within 1e-3 m / 1e-3 rad, equal keyframe counts, landmark counts within
2%, and three matcher calls per tracked frame plus one per keyframe chain
(on the CPU they take the plain version, so none launches the kernel).

The slow case is tests/test_fisheye_system.py::
test_fisheye_rgbd_sequence_ate on both Systems, with its bounds.
"""

import functools

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.io import trajectory as traj_io
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System
from structure_plp_slam_tpu_torch.testing import synthetic_scene

torch.set_num_threads(2)

_KW = dict(name="fisheye", cols=320, rows=240, fx=240.0, fy=240.0, cx=159.5, cy=119.5,
           fps=30.0, k1=-0.05, k2=0.01, k3=-0.003, k4=0.001, focal_x_baseline=24.0,
           depth_threshold=400.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.FISHEYE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.FISHEYE, **_KW)
ORB = dict(max_num_keypts=600, num_levels=4)
NUM_FRAMES = 6
SIZES = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=2,
             enable_loop_closing=False, track_lag=2)


def _frames(n, step=0.05):
    tex = synthetic_scene.make_texture(np.random.default_rng(42))
    poses = synthetic_scene.trajectory(n, step=step)
    return [synthetic_scene.render_fisheye(TCAM, tex, R, t) for R, t in poses], poses


def _run(slam, frames):
    slam.startup()
    poses = []
    for i, (img, depth) in enumerate(frames):
        out = slam.feed_RGBD_frame(img, depth, float(i) / 30.0)
        if torch.is_tensor(out):
            out = out.cpu().numpy()
        poses.append(None if out is None else np.array(out))
    slam.shutdown()
    return poses


@functools.lru_cache(maxsize=1)
def run_both():
    frames, _ = _frames(NUM_FRAMES)
    js = JSystem(JConfig(camera=JCAM, orb=JOrb(**ORB), raw={}), distributed_ba=False, **SIZES)
    jposes = _run(js, frames)
    ts = System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), device="cpu", **SIZES)
    tfm.reset_counts()
    tposes = _run(ts, frames)
    return js, jposes, ts, tposes, tfm.fused_match.calls, tfm.fused_match.launches


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def test_fisheye_system_matches_jax():
    js, jposes, ts, tposes, _, _ = run_both()
    assert all(p is not None for p in jposes)
    assert all(p is not None for p in tposes)
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        dt = np.linalg.norm(a[:, 3] - b[:, 3])
        dr = _rot_angle(a[:, :3], b[:, :3])
        # 1e-3 m / 1e-3 rad: f32 sums in another order through LM and BA.
        assert dt < 1e-3 and dr < 1e-3, f"frame {i}: {dt:.2e} m, {dr:.2e} rad"
    assert ts.num_keyframes == js.num_keyframes >= 3
    assert abs(ts.num_landmarks - js.num_landmarks) <= 0.02 * js.num_landmarks
    assert ts.tracking_state.value == js.tracking_state.value == "Tracking"


def test_fisheye_system_went_through_matcher():
    """Fisheye frames take the fused matcher at every call site, as in the
    JAX package (only the equirectangular model goes around it)."""
    _, _, ts, _, calls, launches = run_both()
    assert ts.num_track_steps == NUM_FRAMES - 1  # the first frame initializes
    assert calls == 3 * ts.num_track_steps + ts.next_kf - 1, (calls, ts.num_track_steps)
    assert launches == 0  # CPU tensors take the plain version


@pytest.mark.slow
def test_fisheye_rgbd_sequence_ate():
    """tests/test_fisheye_system.py::test_fisheye_rgbd_sequence_ate on
    both Systems (the port's renderer, the JAX test's texture and bounds)."""
    frames, poses = _frames(10)
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1)) for i, (R, t) in enumerate(poses)]
    kw = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=2)
    for slam in (JSystem(JConfig(camera=JCAM, orb=JOrb(**ORB), raw={}), distributed_ba=False,
                         **kw),
                 System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), device="cpu", **kw)):
        _run(slam, frames)
        assert slam.tracking_state.value == "Tracking"
        est = slam.frame_trajectory()
        assert len(est) >= 8
        ate = traj_io.ate_rmse(est, gt, align_scale=False)
        assert ate < 0.06, f"{type(slam).__module__}: ATE {ate}"
