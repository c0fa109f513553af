"""Port parity: the frame and map publishers, the HTML viewer payload and
the live viewer.

Both packages' Systems take the same 6 frames of tests/synthetic_scene.py
(numpy seed 42, 320x240, 600 keypoints over 4 levels, 8 keyframes / 4096
landmarks, loop closing off, ``store_dense_cloud=True``), as in
tests/test_torch_system.py, whose equality holds here: on the CPU the port
computes what XLA:CPU compiles, so keyframe poses, landmarks and the
tracked keypoints are equal. The map snapshot (landmarks, colours, keyframe
poses, lines, planes, the dense cloud) and ``html_viewer.map_data`` of the
port System are held against the JAX System's on the same frames, the
frame snapshot likewise. The live viewer serves the port System's map
over HTTP. The slow cases are the port's copies of
tests/test_publish_live.py (device="cpu").
"""

import functools
import json
import urllib.request

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.publish import html_viewer as jhtml
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.publish import html_viewer
from structure_plp_slam_tpu_torch.publish.frame_publisher import FramePublisher
from structure_plp_slam_tpu_torch.system import System, TrackerState
from tests import synthetic_scene

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
SIZES = dict(max_keyframes=8, max_landmarks=4096, enable_loop_closing=False, track_lag=2,
             store_dense_cloud=True)


def _cfg():
    return Config(camera=TCAM, orb=OrbParams(max_num_keypts=600, num_levels=4), raw={})


@functools.lru_cache(maxsize=1)
def _frames():
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), JCAM, num_frames=6)
    return frames


def _run(slam):
    slam.startup()
    for img, depth, ts in _frames():
        slam.feed_RGBD_frame(img, depth, ts)
    slam.shutdown()
    return slam


@pytest.fixture(scope="module")
def systems():
    js = _run(JSystem(JConfig(camera=JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={}),
                      **SIZES))
    ts = _run(System(_cfg(), device="cpu", **SIZES))
    return js, ts


def test_system_publish_keeps_references(systems):
    """The System's last consumed frame is held as references (this runs
    before any test reads the frame snapshot)."""
    _, ts = systems
    raw = ts.get_frame_publisher()._raw
    assert torch.is_tensor(raw["kp_xy"]) and torch.is_tensor(raw["kp_plane"])
    assert isinstance(ts.map_publisher._current_pose, tuple)
    assert all(torch.is_tensor(a) for a in ts.map_publisher._current_pose)


def test_map_snapshot_matches_jax(systems):
    """On the CPU the port computes what XLA:CPU compiles (the 16-camera
    local BA window of its 8 keyframes too, ROADMAP C18), so the snapshots
    are equal: keyframe poses, landmarks, the dense cloud, the current
    pose."""
    js, ts = systems
    jsnap, tsnap = js.get_map_publisher().snapshot(), ts.get_map_publisher().snapshot()
    jk, tk = jsnap.get_keyframe_poses(), tsnap.get_keyframe_poses()
    assert jk.shape == tk.shape and len(tk) >= 2
    np.testing.assert_array_equal(tk, jk)
    jl, tl = jsnap.get_landmarks(), tsnap.get_landmarks()
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tl, ts.get_landmarks())
    tc = tsnap.get_landmark_colors()
    assert tc.shape == (len(tl), 3) and tc.dtype == np.uint8
    assert (tc == 180).all() and (jsnap.get_landmark_colors() == 180).all()  # no planes
    assert tsnap.get_lines().shape == (0, 6) and tsnap.get_planes().shape == (0, 4)
    assert jsnap.get_lines().shape == (0, 6) and jsnap.get_planes().shape == (0, 4)
    # The dense cloud: the same keyframes' strided images under the same
    # poses.
    jp, jg = jsnap.get_dense_cloud()
    tp, tg = tsnap.get_dense_cloud()
    assert len(tp) > 1000 and tp.shape == jp.shape and tp.dtype == np.float32
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tp, jp)
    jpose = jsnap.get_current_cam_pose()
    tpose = tsnap.get_current_cam_pose()
    assert tpose.shape == (3, 4)
    np.testing.assert_array_equal(tpose, np.asarray(jpose))


def test_map_data_matches_jax(systems):
    js, ts = systems
    j = jhtml.map_data(js.get_map_publisher())
    t = html_viewer.map_data(ts.get_map_publisher())
    assert sorted(t) == sorted(j)
    assert t["points"] == j["points"]
    assert len(t["point_colors"]) == len(t["points"])
    for key in ("trajectory", "frusta", "center"):
        assert np.asarray(t[key]).shape == np.asarray(j[key]).shape, key
        np.testing.assert_array_equal(np.asarray(t[key]), np.asarray(j[key]), err_msg=key)
    assert t["scale"] == j["scale"]
    assert t["lines"] == j["lines"] == [] and t["planes"] == j["planes"] == []
    assert t["stats"].split(" · ")[1:] == j["stats"].split(" · ")[1:]
    # The page embeds the same payload.
    page = html_viewer.render_html(t)
    assert "<canvas" in page and json.dumps(t["center"]) in page


def test_frame_snapshot_matches_jax(systems):
    js, ts = systems
    j = js.get_frame_publisher().snapshot()
    t = ts.get_frame_publisher().snapshot()
    assert t.state == j.state == "Tracking"
    assert t.timestamp == j.timestamp
    assert t.num_tracked == j.num_tracked
    np.testing.assert_array_equal(t.image, j.image)
    np.testing.assert_array_equal(t.kp_xy, np.asarray(j.kp_xy))
    np.testing.assert_array_equal(t.kp_has_landmark, np.asarray(j.kp_has_landmark))
    assert (t.kp_plane == -1).all() and t.segments is None
    jd, td = js.get_frame_publisher().draw_frame(), ts.get_frame_publisher().draw_frame()
    assert td.shape == jd.shape == (240, 320, 3) and td.dtype == np.uint8
    # Green keypoint discs on the grey image: the JAX drawing.
    green = lambda d: int(((d[..., 1] == 255) & (d[..., 0] == 0)).sum())  # noqa: E731
    assert green(td) > 0
    np.testing.assert_array_equal(td, jd)


def test_publish_is_copy_on_read():
    """A consumed frame hands the publishers references: tensors stay
    tensors (no copy to the host on the frame path) until a viewer reads."""
    fp = FramePublisher()
    xy = torch.rand(10, 2) * 100
    valid = torch.ones(10, dtype=torch.bool)
    lm = torch.arange(10) % 3 == 0
    fp.update(image=torch.zeros(120, 160), kp_xy=xy, kp_valid=valid, kp_has_landmark=lm,
              kp_plane=torch.where(lm, 1, -1), state="Tracking", num_tracked=4, timestamp=0.5)
    assert fp._raw["kp_xy"] is xy
    s = fp.snapshot()
    assert isinstance(s.kp_xy, np.ndarray) and isinstance(s.image, np.ndarray)
    np.testing.assert_array_equal(s.kp_xy, xy.numpy())
    img = fp.draw_frame()
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    assert fp.snapshot() is s  # nothing new: the same snapshot


def test_live_viewer_serves_port_map(systems):
    _, ts = systems
    port = ts.start_live_viewer()
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read().decode()
        assert "map.json" in page and "canvas" in page
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/map.json", timeout=30)
        assert resp.status == 200
        data = json.loads(resp.read())
        want = json.loads(json.dumps(html_viewer.map_data(ts.get_map_publisher())))
        assert data == want
        n_dense = len(ts.get_map_publisher().get_dense_cloud()[0])
        assert len(data["points"]) == len(ts.get_landmarks()) + n_dense
        assert len(data["frusta"]) == ts.num_keyframes
    finally:
        ts.stop_live_viewer()
    assert ts._live_viewer is None


@pytest.mark.slow
def test_live_viewer_and_pause_protocol(rng):
    """tests/test_publish_live.py::test_live_viewer_and_pause_protocol on
    the port (its camera and ORB settings are this file's)."""
    cfg = _cfg()
    frames, _ = synthetic_scene.make_sequence(rng, JCAM, num_frames=6)
    slam = System(cfg, max_keyframes=32, max_landmarks=8192, device="cpu")
    slam.startup()
    for img, depth, ts in frames[:4]:
        slam.feed_RGBD_frame(img, depth, ts)
    assert slam.tracking_state is TrackerState.TRACKING

    n_before = slam.num_frames
    slam.pause_tracker()
    assert slam.tracker_is_paused()
    assert slam.feed_RGBD_frame(frames[4][0], frames[4][1], frames[4][2]) is None
    assert slam.num_frames == n_before
    slam.resume_tracker()
    out = slam.feed_RGBD_frame(frames[4][0], frames[4][1], frames[4][2])
    assert out is not None

    port = slam.start_live_viewer()
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read().decode()
        assert "map.json" in page and "canvas" in page
        data = json.loads(
            urllib.request.urlopen(f"http://127.0.0.1:{port}/map.json", timeout=10).read())
        assert len(data["points"]) > 100
        assert len(data["frusta"]) == slam.num_keyframes
        assert "keyframes" in data["stats"]
        assert np.isfinite(np.asarray(data["center"], dtype=np.float64)).all()
    finally:
        slam.stop_live_viewer()

    slam.request_terminate()
    assert slam.terminate_is_requested()
    assert slam.feed_RGBD_frame(frames[5][0], frames[5][1], frames[5][2]) is None
    slam.shutdown()


@pytest.mark.slow
def test_dense_rgbd_cloud(rng):
    """tests/test_publish_live.py::test_dense_rgbd_cloud on the port (its
    camera and ORB settings are this file's)."""
    cfg = _cfg()
    frames, _ = synthetic_scene.make_sequence(rng, JCAM, num_frames=8)
    slam = System(cfg, max_keyframes=16, max_landmarks=4096, max_kf_interval=2,
                  store_dense_cloud=True, device="cpu")
    slam.startup()
    for img, depth, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
    slam.shutdown()
    pts, gray = slam.get_map_publisher().get_dense_cloud()
    assert len(pts) > 1000, f"dense cloud too small: {len(pts)}"
    assert len(pts) == len(gray)
    z = pts[:, 2]
    on_planes = (np.abs(z - 6.0) < 0.35) | (np.abs(z - 3.5) < 0.35)
    assert on_planes.mean() > 0.9, f"dense cloud off-scene: {z.min()}..{z.max()}"
    data = html_viewer.map_data(slam.get_map_publisher())
    assert len(data["points"]) > 1000
