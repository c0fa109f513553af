"""Port parity: the whole RGB-D point slice, System against System.

Both packages' ``System`` take the same 6 rendered frames (320x240, 600
keypoints over 4 levels, 8 keyframes / 4096 landmarks, loop closing off,
``track_lag=2``). The JAX System runs its CPU branch (masked distance
matrices), the port its fused matcher; both compute the same function. On
the CPU the port computes what XLA:CPU compiles (its keyframe chain's local
BA over the 16-camera window too, ROADMAP C18), so the per-frame poses, the
frame trajectory and the keyframe and landmark counts must be equal, and the
run must meet no shape outside ``ops/ba_cpu``'s tables; on the card the poses
must agree within 1e-3 m / 1e-3 rad, the keyframe counts must be equal and
the landmark counts within 2%. The port's matcher
must have been called 3 times per tracked frame (stage 1 narrow + wide,
stage 2) and once per keyframe chain (fuse). On the CPU those calls take
the plain version, so ``fused_match.launches`` stays 0 there; the
card-marked case checks that every call launched the kernel.

The slow case is the port's version of
tests/test_system_e2e.py::test_rgbd_sequence_ate, with the same asserts.
Frames come from the port's copy of the renderer
(tests/test_torch_frontend.py holds it against tests/synthetic_scene.py),
so this file also runs where another package named ``tests`` shadows the
repository's.
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
from structure_plp_slam_tpu_torch.ops import ba_cpu
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System, TrackerState
from structure_plp_slam_tpu_torch.testing import synthetic_scene

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
NUM_FRAMES = 6
SIZES = dict(max_keyframes=8, max_landmarks=4096, enable_loop_closing=False, track_lag=2)


def _cfg(camera=TCAM):
    return Config(camera=camera, orb=OrbParams(max_num_keypts=600, num_levels=4), raw={})


@functools.lru_cache(maxsize=1)
def _frames():
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), TCAM,
                                              num_frames=NUM_FRAMES)
    return frames


def _run(slam, frames):
    slam.startup()
    poses = []
    for img, depth, ts in frames:
        out = slam.feed_RGBD_frame(img, depth, ts)
        if torch.is_tensor(out):
            out = out.cpu().numpy()
        poses.append(None if out is None else np.array(out))
    slam.shutdown()
    return poses


@functools.lru_cache(maxsize=1)
def run_jax():
    js = JSystem(JConfig(camera=JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={}),
                 **SIZES)
    return js, _run(js, _frames())


# The shapes outside ops/ba_cpu's tables each port run met, by device.
UNMEASURED = {}


def run_port(device):
    ts = System(_cfg(), device=device, **SIZES)
    tfm.reset_counts()
    with ba_cpu.unmeasured_shapes() as UNMEASURED[device]:
        poses = _run(ts, _frames())
    return ts, poses, tfm.fused_match.calls, tfm.fused_match.launches


@functools.lru_cache(maxsize=1)
def run_port_cpu():
    return run_port("cpu")


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _assert_systems_agree(js, jposes, ts, tposes, exact=False):
    """``exact``: every pose, the frame trajectory and the counts equal
    (the CPU); else within 1e-3 m / 1e-3 rad and 2% of the landmarks."""
    assert len(jposes) == len(tposes) == NUM_FRAMES
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        assert (a is None) == (b is None), f"frame {i}: one System returned no pose"
        if a is None:
            continue
        if exact:
            assert np.array_equal(a, b), f"frame {i}: {np.abs(a - b).max():.2e}"
            continue
        dt = np.linalg.norm(a[:, 3] - b[:, 3])
        dr = _rot_angle(a[:, :3], b[:, :3])
        # 1e-3 m / 1e-3 rad: the card's f32 sums in another order through LM
        # and BA.
        assert dt < 1e-3 and dr < 1e-3, f"frame {i}: {dt:.2e} m, {dr:.2e} rad"
    for (ta, pa), (tb, pb) in zip(js.frame_trajectory(), ts.frame_trajectory()):
        assert ta == tb
        assert np.array_equal(pa, pb) if exact else np.abs(pa - pb).max() < 1e-3
    assert ts.num_keyframes == js.num_keyframes
    assert ts.next_kf == js.next_kf
    n_j, n_t = js.num_landmarks, ts.num_landmarks
    assert n_t == n_j if exact else abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    assert ts.tracking_state.value == js.tracking_state.value == "Tracking"


def test_system_matches_jax():
    js, jposes = run_jax()
    ts, tposes, _, _ = run_port_cpu()
    _assert_systems_agree(js, jposes, ts, tposes, exact=True)
    assert js.next_kf >= 3  # local BA ran in both (it starts at the third keyframe)
    assert not UNMEASURED["cpu"], UNMEASURED["cpu"]


def test_system_went_through_matcher():
    ts, _, calls, launches = run_port_cpu()
    chains = ts.next_kf - 1
    assert ts.num_track_steps == NUM_FRAMES - 1  # the first frame initializes
    assert calls == 3 * ts.num_track_steps + chains, (calls, ts.num_track_steps, chains)
    assert launches == 0  # CPU tensors take the plain version


@pytest.mark.cuda
def test_system_launches_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    js, jposes = run_jax()
    ts, tposes, calls, launches = run_port("cuda")
    _assert_systems_agree(js, jposes, ts, tposes)
    assert launches == calls == 3 * ts.num_track_steps + ts.next_kf - 1


def test_system_default_device_needs_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        System(_cfg(), **SIZES)


PORTED_ITEMS = ("A14", "A15", "A17")
_FISHEYE_K = dict(k1=-0.05, k2=0.01, k3=-0.003, k4=0.001)


@pytest.mark.parametrize("kwargs,camera,item", [
    (dict(with_lines=True), TCAM, "A14"),
    ({}, Camera(setup=CameraSetup.RGBD, model=CameraModel.FISHEYE, **_KW, **_FISHEYE_K), "A15"),
    ({}, Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.EQUIRECTANGULAR, name="eq",
                cols=512, rows=256, fps=30.0), "A15"),
    (dict(distributed_ba=True), TCAM, "A17"),
])
def test_unported_options_raise(kwargs, camera, item):
    """Options the port has not yet raise, naming their ROADMAP item.
    ``with_lines`` (A14) and the fisheye and equirectangular cameras (A15)
    raised until the slices that ported them: now the line frontend's
    first RGB-D frame creates 3D lines, a fisheye RGB-D System tracks its
    rendered frames, and an equirectangular monocular System (the
    reference's sphere is monocular) initializes from two views. The
    multi-device global BA (A17) raised at its first use: a System asked
    for it on the CPU (one device) builds no mesh and tracks."""
    args = {**SIZES, **kwargs, "device": "cpu"}
    if item not in PORTED_ITEMS:
        with pytest.raises(NotImplementedError, match=item):
            System(_cfg(camera), **args)
        return
    slam = System(_cfg(camera), **args)
    slam.startup()
    tex = synthetic_scene.make_texture(np.random.default_rng(42))
    poses = synthetic_scene.trajectory(4, step=0.09)
    if camera.model is CameraModel.EQUIRECTANGULAR:
        for i, (R, t) in enumerate(poses):
            slam.feed_monocular_frame(synthetic_scene.render_equirect(camera, tex, R, t)[0],
                                      i / 30.0)
        assert slam.tracking_state is TrackerState.TRACKING
        assert slam.num_keyframes >= 2
        return
    if item == "A17":
        assert slam.loop_closer.mesh is None
        img, depth, ts = _frames()[0]
        slam.feed_RGBD_frame(img, depth, ts)
        assert slam.tracking_state is TrackerState.TRACKING
        return
    if camera.model is CameraModel.FISHEYE:
        for i, (R, t) in enumerate(poses[:2]):
            slam.feed_RGBD_frame(*synthetic_scene.render_fisheye(camera, tex, R, t), i / 30.0)
        assert slam.tracking_state is TrackerState.TRACKING
        assert slam.num_landmarks > 100
        return
    assert slam.frontend.with_lines
    img, depth, ts = _frames()[0]
    slam.feed_RGBD_frame(img, depth, ts)
    assert slam.tracking_state is TrackerState.TRACKING
    assert slam.metrics()["lines"] >= 1


def _started(**kw):
    slam = System(_cfg(), device="cpu", **{**SIZES, **kw})
    slam.startup()
    return slam


def test_pause_tracker_drops_frames():
    """A paused System drops fed frames (the feed returns None, num_frames
    and the trajectory stay) until resume_tracker(); pausing first applies
    the lagged decisions, as the JAX System's does."""
    frames = _frames()
    slam = _started()
    for img, depth, ts in frames[:3]:
        slam.feed_RGBD_frame(img, depth, ts)
    assert slam._pending
    slam.pause_tracker()
    assert slam.tracker_is_paused() and not slam._pending
    n, traj = slam.num_frames, len(slam.frame_trajectory())
    for img, depth, ts in frames[3:5]:
        assert slam.feed_RGBD_frame(img, depth, ts) is None
    assert slam.num_frames == n and len(slam.frame_trajectory()) == traj
    slam.resume_tracker()
    assert not slam.tracker_is_paused()
    img, depth, ts = frames[5]
    assert slam.feed_RGBD_frame(img, depth, ts) is not None
    assert slam.num_frames == n + 1
    slam.shutdown()
    assert len(slam.frame_trajectory()) == traj + 1
    assert slam.tracking_state is TrackerState.TRACKING


def test_request_terminate_drops_frames():
    frames = _frames()
    slam = _started()
    for img, depth, ts in frames[:2]:
        slam.feed_RGBD_frame(img, depth, ts)
    assert not slam.terminate_is_requested()
    slam.request_terminate()
    assert slam.terminate_is_requested() and not slam._pending
    n = slam.num_frames
    for img, depth, ts in frames[2:]:
        assert slam.feed_RGBD_frame(img, depth, ts) is None
    assert slam.num_frames == n


def test_mapping_module_switch():
    """With the mapping module disabled, tracking goes on and no keyframe
    is inserted; enabling it again restores insertion."""
    frames = _frames()
    slam = _started()
    img, depth, ts = frames[0]
    slam.feed_RGBD_frame(img, depth, ts)
    slam.disable_mapping_module()
    assert not slam.enable_mapping
    for img, depth, ts in frames[1:]:
        assert slam.feed_RGBD_frame(img, depth, ts) is not None
    slam.shutdown()
    assert slam.num_keyframes == 1 and slam.tracking_state is TrackerState.TRACKING
    assert len(slam.frame_trajectory()) == NUM_FRAMES
    slam.enable_mapping_module()
    assert slam.enable_mapping


def test_get_landmarks_matches_jax():
    js, _ = run_jax()
    ts, _, _, _ = run_port_cpu()
    a, b = js.get_landmarks(), ts.get_landmarks()
    assert b.shape == a.shape and a.shape[0] > 200
    assert np.abs(b - a).max() < 1e-3


def test_loop_closing_system_runs():
    """Loop closing is on by default (it raised until the slice that
    ported it): the System builds and runs the 6 frames as the JAX System
    does. Loop detection starts at the eighth keyframe, so nothing moves
    here (tests/test_torch_loop_system.py drives it)."""
    js, jposes = run_jax()
    ts = System(_cfg(), device="cpu", **{**SIZES, "enable_loop_closing": True})
    assert ts.enable_loop_closing
    tposes = _run(ts, _frames())
    _assert_systems_agree(js, jposes, ts, tposes)
    assert ts.metrics()["loops_closed"] == 0
    ts.disable_loop_detector()
    assert not ts.enable_loop_closing
    ts.enable_loop_detector()
    assert ts.enable_loop_closing


@pytest.mark.parametrize("setup", [CameraSetup.MONOCULAR, CameraSetup.STEREO])
def test_mono_and_stereo_construct(setup):
    """The monocular and stereo setups construct (they raised until the
    slice that ported them)."""
    slam = System(_cfg(Camera(setup=setup, model=CameraModel.PERSPECTIVE, **_KW)),
                  device="cpu", **SIZES)
    assert slam.tracking_state is TrackerState.NOT_INITIALIZED


# Segmentation masks (planes, A13) raised on every feed until the slice
# that ported them: each feed now takes one and plane-fits the keyframes
# it initializes (a monocular map starts from two views: its first frame
# is kept, and the one frame fed here creates nothing yet).
@pytest.mark.parametrize("setup,feed,planes", [
    (CameraSetup.MONOCULAR, lambda s, f, m: s.feed_monocular_frame(f[0], f[2], seg_mask=m), 0),
    (CameraSetup.STEREO, lambda s, f, m: s.feed_stereo_frame(f[0], f[0], f[2], seg_mask=m), 0),
    (CameraSetup.RGBD, lambda s, f, m: s.feed_RGBD_frame(f[0], f[1], f[2], seg_mask=m), 1),
], ids=["monocular", "stereo", "seg_mask"])
def test_unported_feeds_raise(setup, feed, planes):
    camera = Camera(setup=setup, model=CameraModel.PERSPECTIVE, **_KW)
    slam = System(_cfg(camera), device="cpu", **SIZES)
    slam.startup()
    frame = _frames()[0]
    feed(slam, frame, np.where(frame[1] < 4.5, 1, 2).astype(np.int32))
    m = slam.metrics()
    assert m["planes"] >= planes, m
    if planes:
        assert m["tracking_state"] == "Tracking"
        assert int((slam.state.lm_plane >= 0).sum()) > 30


def test_feeds_run():
    """The monocular feed keeps a first frame as its first view; the
    stereo feed initializes from a rendered pair's disparities."""
    mono = System(_cfg(Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE,
                              **_KW)), device="cpu", **{**SIZES, "track_lag": 0})
    mono.startup()
    img, _, ts = _frames()[0]
    assert mono.feed_monocular_frame(img, ts) is None
    assert mono.tracking_state is TrackerState.NOT_INITIALIZED
    assert mono._init_feats is not None

    cam = Camera(setup=CameraSetup.STEREO, model=CameraModel.PERSPECTIVE, **_KW)
    tex = synthetic_scene.make_texture(np.random.default_rng(1))
    left, _ = synthetic_scene.render(cam, tex, np.eye(3), np.zeros(3))
    right, _ = synthetic_scene.render(cam, tex, np.eye(3), -np.array([cam.baseline, 0, 0]))
    stereo = System(_cfg(cam), device="cpu", **{**SIZES, "track_lag": 0})
    stereo.startup()
    assert stereo.feed_stereo_frame(left, right, 0.0) is not None
    assert stereo.tracking_state is TrackerState.TRACKING
    assert stereo.num_landmarks >= 30


def test_lost_frame_goes_lost():
    """A blank frame after initialization keeps fewer than 30 inliers: the
    System declares it Lost, the relocalizer finds nothing in a blank
    frame, and the frame is recorded as lost (no raise, no pose)."""
    slam = System(_cfg(), device="cpu", **{**SIZES, "track_lag": 0})
    slam.startup()
    (img0, d0, t0), (img1, d1, t1) = _frames()[:2]
    slam.feed_RGBD_frame(img0, d0, t0)
    slam.feed_RGBD_frame(img1, d1, t1)
    slam._init_frame_count -= 1000  # an old map: no young-map auto-reset
    assert slam.feed_RGBD_frame(np.zeros_like(img1), d1, t1 + 1.0 / 30.0) is None
    assert slam.tracking_state is TrackerState.LOST
    assert slam.num_relocalizations == 0
    assert slam._frame_stats[-1][3]  # recorded as lost ...
    assert len(slam.frame_trajectory()) == 2  # ... and left out of the trajectory


def test_young_map_resets_when_lost():
    """Lost within 5 s of initialization on a map of <= 3 keyframes: the
    System resets (tracking_module.cc:506-513) and starts over."""
    slam = System(_cfg(), device="cpu", **{**SIZES, "track_lag": 0})
    slam.startup()
    img, depth, ts = _frames()[0]
    slam.feed_RGBD_frame(img, depth, ts)
    assert slam.feed_RGBD_frame(np.zeros_like(img), depth, ts + 1.0 / 30.0) is None
    assert slam.tracking_state is TrackerState.NOT_INITIALIZED
    assert slam.next_kf == 0 and slam.frame_trajectory() == []


def test_capacity_growth():
    """A map whose landmark headroom runs out doubles its landmark
    capacity (map_database.grow) and keeps tracking."""
    pad_to = System(_cfg(), device="cpu", **SIZES).frontend.pad_to
    L0 = 2 * pad_to + 64
    slam = System(_cfg(), device="cpu", **{**SIZES, "max_landmarks": L0, "track_lag": 0})
    slam.startup()
    (img0, d0, t0), (img1, d1, t1) = _frames()[:2]
    slam.feed_RGBD_frame(img0, d0, t0)
    assert slam.next_lm > 64  # the depth seeds alone use up the headroom
    assert slam.feed_RGBD_frame(img1, d1, t1) is not None
    assert slam.max_landmarks == slam.state.lm_pos.shape[0] == 2 * L0
    assert slam.tracking_state is TrackerState.TRACKING


@pytest.mark.slow
def test_rgbd_sequence_ate(rng):
    """tests/test_system_e2e.py::test_rgbd_sequence_ate on the port."""
    frames, poses = synthetic_scene.make_sequence(rng, TCAM, num_frames=16)
    slam = System(_cfg(), max_keyframes=32, max_landmarks=8192, enable_loop_closing=False,
                  device="cpu")
    slam.startup()
    tracked = 0
    for img, depth, ts in frames:
        if slam.feed_RGBD_frame(img, depth, ts) is not None:
            tracked += 1
    slam.shutdown()
    assert slam.tracking_state is TrackerState.TRACKING
    assert tracked >= len(frames) - 1
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1).astype(np.float64))
          for i, (R, t) in enumerate(poses)]
    ate = traj_io.ate_rmse(slam.frame_trajectory(), gt, align_scale=False)
    assert ate < 0.05, f"ATE {ate}"
    assert slam.num_keyframes >= 2
    assert slam.num_landmarks > 200


@pytest.mark.slow
def test_rgbd_main_path_matches_jax():
    """ROADMAP's main path on both Systems: test_rgbd_sequence_ate's 16
    frames (320x240, numpy seed 42, 32 keyframes / 8192 landmarks, loop
    closing off). With the frontend, the tracker's pose solve and the
    keyframe chain (its local BA's stereo rows included) computing
    XLA:CPU's arithmetic on the CPU, every frame's pose and the final
    trajectory are bit-equal to the JAX System's, and so is the map."""
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), TCAM, num_frames=16)
    sizes = dict(max_keyframes=32, max_landmarks=8192, enable_loop_closing=False)
    js = JSystem(JConfig(camera=JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={}),
                 **sizes)
    ts = System(_cfg(), device="cpu", **sizes)
    jposes, tposes = _run(js, frames), _run(ts, frames)
    assert len(jposes) == len(tposes) == 16
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        assert (a is None) == (b is None), i
        assert a is None or np.array_equal(a, b), i
    jt, tt = js.frame_trajectory(), ts.frame_trajectory()
    assert len(jt) == len(tt) == 16
    assert all(np.array_equal(np.asarray(a[1]), np.asarray(b[1])) for a, b in zip(jt, tt))
    for f in js.state._fields:
        a, b = np.asarray(getattr(js.state, f)), getattr(ts.state, f).numpy()
        assert np.array_equal(a.view(np.int32) if a.dtype == np.uint32 else a, b), f
    assert ts.num_keyframes == js.num_keyframes >= 2
    assert ts.tracking_state is TrackerState.TRACKING
