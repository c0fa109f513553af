"""Port parity: the YAML config and the map snapshot, in either package.

``load_config`` on the YAML strings of tests/test_run_cli.py and
tests/test_long_sequence.py and on OpenVSLAM's example/aist
equirectangular settings (chip_smoke.py phase 15) gives the JAX package's
Camera, OrbParams and raw dict. The snapshot document the port builds for
a map is byte for byte the JAX package's (camera entry included), so a
file either package writes loads in the other: a map the JAX System
saves loads into a port System, whose first localized frame's pose is
within 1e-3 m / 1e-3 rad of a JAX System loaded from the same file, and a
map the port saves loads into a JAX System, which relocalizes on a
mid-sequence frame. The frame is shown turned 180 degrees about the
optical axis (a kidnapped camera, as chip_smoke.py phase 9): tracked from
the loaded map's origin it fails, so only the relocalizer recovers it.
Copies of tests/test_map_io.py's round-trip and counter-fallback tests run
against the port's map_io; its slow localization test has a port copy
here too.

Inputs: 8 frames of tests/synthetic_scene.py (numpy seed 42) at 320x240,
600 keypoints over 4 levels, 16 keyframes / 4096 landmarks, a keyframe
at most every 2 frames, loop closing off.
"""

import dataclasses
import functools

import msgpack
import numpy as np
import pytest
import torch

from structure_plp_slam_tpu import config as jconfig
from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.data import map_state as jms
from structure_plp_slam_tpu.io import map_io as jmap_io
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch import config as tconfig
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.io import map_io
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System, TrackerState
from tests import synthetic_scene

torch.set_num_threads(2)

_RUN_CLI_YAML = """%YAML:1.0
Camera.name: synth
Camera.setup: {setup}
Camera.model: perspective
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 159.5
Camera.cy: 119.5
Camera.cols: 320
Camera.rows: 240
Camera.fps: 30.0
Camera.focal_x_baseline: 26.0
depth_threshold: 400.0
depthmap_factor: 5000.0
Feature.max_num_keypoints: 600
Feature.num_levels: 4
"""

_LONG_YAML = _RUN_CLI_YAML.replace("synth", "long").replace("{setup}", "RGBD")

# OpenVSLAM's example/aist/equirectangular.yaml settings (RICOH THETA S).
_EQUIRECT_YAML = """%YAML:1.0
Camera.name: "RICOH THETA S 960"
Camera.setup: "monocular"
Camera.model: "equirectangular"
Camera.fps: 30.0
Camera.cols: 1920
Camera.rows: 960
Camera.color_order: "RGB"
Feature.max_num_keypoints: 2000
Feature.scale_factor: 1.2
Feature.num_levels: 8
Feature.ini_fast_threshold: 20
Feature.min_fast_threshold: 7
Feature.mask_rectangles:
  - [0.0, 1.0, 0.0, 0.1]
  - [0.0, 1.0, 0.84, 1.0]
  - [0.0, 0.2, 0.7, 1.0]
  - [0.8, 1.0, 0.7, 1.0]
Mapping.baseline_dist_thr_ratio: 0.02
"""


def _plain(obj):
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(obj).items()}


@pytest.mark.parametrize("text", [
    _RUN_CLI_YAML.format(setup="rgbd"), _RUN_CLI_YAML.format(setup="monocular"), _LONG_YAML,
    _EQUIRECT_YAML,
], ids=["run_cli_rgbd", "run_cli_monocular", "long_sequence", "equirectangular"])
def test_load_config_matches_jax(text, tmp_path):
    j = jconfig.load_config(yaml_text=text)
    t = tconfig.load_config(yaml_text=text)
    assert [f.name for f in dataclasses.fields(Camera)] == \
        [f.name for f in dataclasses.fields(JCamera)]
    assert _plain(t.camera) == _plain(j.camera)
    assert _plain(t.orb) == _plain(j.orb)
    assert t.raw == j.raw
    assert t.camera.setup.value == j.camera.setup.value
    p = tmp_path / "cfg.yaml"
    p.write_text(text)
    assert tconfig.load_config(str(p)) == t


# ---------------------------------------------------------------------------
# The snapshot format.
# ---------------------------------------------------------------------------


def test_snapshot_roundtrip(tmp_path):
    """tests/test_map_io.py::test_snapshot_roundtrip against the port."""
    state = ms.create(8, 64, 256, device="cpu")
    state = state._replace(
        lm_valid=ms.with_row(state.lm_valid, slice(0, 5), True),
        kf_valid=ms.with_row(state.kf_valid, slice(0, 2), True),
        ln_valid=ms.with_row(state.ln_valid, slice(0, 3), True),
        pl_valid=ms.with_row(state.pl_valid, slice(0, 1), True),
    )
    p = str(tmp_path / "map.msg")
    map_io.save_map(p, state, next_kf=2, next_lm=5, next_line=3, next_plane=1,
                    camera_name="cam")
    state2, nkf, nlm = map_io.load_map(p, device="cpu")
    assert nkf == 2 and nlm == 5
    counters = map_io.load_counters(p)
    assert counters == {"next_kf": 2, "next_lm": 5, "next_line": 3, "next_plane": 1}
    for name in state._fields:
        a, b = getattr(state, name), getattr(state2, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


def test_snapshot_counter_fallback(tmp_path):
    """tests/test_map_io.py::test_snapshot_counter_fallback against the
    port: snapshots written without line/plane counters fall back to the
    highest valid slot + 1 on load."""
    state = ms.create(8, 64, 256, device="cpu")
    state = state._replace(
        ln_valid=ms.with_row(state.ln_valid, 4, True),
        pl_valid=ms.with_row(state.pl_valid, 2, True),
    )
    p = str(tmp_path / "map.msg")
    map_io.save_map(p, state, next_kf=0, next_lm=0)
    with open(p, "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False)
    del doc["line_next_id"], doc["plane_next_id"]
    with open(p, "wb") as f:
        f.write(msgpack.packb(doc, use_bin_type=True))
    counters = map_io.load_counters(p)
    assert counters["next_line"] == 5 and counters["next_plane"] == 3
    assert counters == jmap_io.load_counters(p)


def test_snapshot_rejects_other_versions(tmp_path):
    p = str(tmp_path / "map.msg")
    map_io.save_map(p, ms.create(2, 8, 16, device="cpu"), next_kf=0, next_lm=0)
    with open(p, "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False)
    doc["version"] = 2
    with open(p, "wb") as f:
        f.write(msgpack.packb(doc, use_bin_type=True))
    with pytest.raises(ValueError, match="version 2"):
        map_io.load_map(p, device="cpu")


def _random_jax_state(rng):
    """A small JAX MapState with every field filled from ``rng``."""
    st = jms.create(6, 40, 96)
    fields = {}
    for name in st._fields:
        a = np.asarray(getattr(st, name))
        if a.dtype == np.bool_:
            v = rng.random(a.shape) < 0.5
        elif a.dtype == np.uint32:
            v = rng.integers(0, 2**32, a.shape, dtype=np.uint32)
        elif np.issubdtype(a.dtype, np.integer):
            v = rng.integers(-1, 90, a.shape).astype(a.dtype)
        else:
            v = rng.standard_normal(a.shape).astype(a.dtype)
        fields[name] = v
    return jms.MapState(**fields)


_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
NUM_FRAMES = 8
SIZES = dict(max_keyframes=16, max_landmarks=4096, max_kf_interval=2, enable_loop_closing=False)
_ORB = dict(max_num_keypts=600, num_levels=4)


@functools.lru_cache(maxsize=1)
def _sequence():
    return synthetic_scene.make_sequence(np.random.default_rng(42), JCAM,
                                         num_frames=NUM_FRAMES)


def _jcfg():
    return jconfig.Config(camera=JCAM, orb=JOrb(**_ORB), raw={})


def _tcfg(**orb):
    return tconfig.Config(camera=TCAM, orb=OrbParams(**{**_ORB, **orb}), raw={})


def _feed_all(slam, frames):
    slam.startup()
    for img, depth, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
    slam.shutdown()
    return slam


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """Each package's System run on the same frames, each map saved."""
    d = tmp_path_factory.mktemp("maps")
    frames, _ = _sequence()
    js = _feed_all(JSystem(_jcfg(), **SIZES), frames)
    ts = _feed_all(System(_tcfg(), device="cpu", **SIZES), frames)
    paths = {"jax": str(d / "jax.msg"), "port": str(d / "port.msg")}
    js.save_map_database(paths["jax"])
    ts.save_map_database(paths["port"])
    return js, ts, paths


@pytest.mark.parametrize("kind", ["random_state", "system_map"])
def test_snapshot_doc_byte_equal_to_jax(kind, maps, tmp_path):
    """The document the port builds from ``from_numpy(jax_state)`` is the
    JAX package's, byte for byte (camera entry included)."""
    if kind == "random_state":
        jstate = _random_jax_state(np.random.default_rng(3))
        counters = dict(next_kf=5, next_lm=77, next_line=4, next_plane=2)
        p = str(tmp_path / "jax.msg")
        jmap_io.save_map(p, jstate, camera_name=JCAM.name, camera=JCAM, **counters)
    else:
        p = maps[2]["jax"]
        jstate, counters = jmap_io.load_map_with_counters(p)
    with open(p, "rb") as f:
        jax_bytes = f.read()
    tstate = ms.from_numpy({k: np.asarray(v) for k, v in jstate._asdict().items()}, "cpu")
    port_bytes = map_io.pack_map(tstate, camera_name=TCAM.name, camera=TCAM, **counters)
    assert port_bytes == jax_bytes
    # And the port's file reads back in the JAX package, field for field.
    q = str(tmp_path / "port.msg")
    map_io.save_map(q, tstate, camera_name=TCAM.name, camera=TCAM, **counters)
    back, back_counters = jmap_io.load_map_with_counters(q)
    assert back_counters == counters
    for name in jstate._fields:
        a, b = np.asarray(getattr(jstate, name)), np.asarray(getattr(back, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert map_io.load_cameras(q) == jmap_io.load_cameras(p)


# ---------------------------------------------------------------------------
# Cross-loading: a map saved by one package localizes the other.
# ---------------------------------------------------------------------------


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _turned(frame, pose):
    """``frame`` seen by the camera turned 180 degrees about its optical
    axis (the principal point is the image centre): the image and depth
    turned round, R -> diag(-1, -1, 1) R, the same centre."""
    img, depth, ts = frame
    R, t = pose
    flip = np.diag([-1.0, -1.0, 1.0])
    return ((np.ascontiguousarray(img[::-1, ::-1]), np.ascontiguousarray(depth[::-1, ::-1]),
             ts), (flip @ R, flip @ t))


def _centre_err(P, pose):
    R, t = pose
    return float(np.linalg.norm(-P[:, :3].T @ P[:, 3] + R.T @ t))


def _localize(slam, path, frame):
    slam.load_map_database(path)
    slam.disable_mapping_module()
    slam.startup(need_initialize=False)
    assert slam.tracking_state.value == "Lost"
    img, depth, _ = frame
    out = slam.feed_RGBD_frame(img, depth, 99.0)
    if torch.is_tensor(out):
        out = out.cpu().numpy()
    return None if out is None else np.array(out)


def test_port_localizes_on_jax_map(maps):
    """A map the JAX System saved: a port System and a JAX System load it
    and localize the same mid-sequence frame; poses within 1e-3 m /
    1e-3 rad, the same counts."""
    js_build, _, paths = maps
    frames, poses = _sequence()
    frame, pose = _turned(frames[5], poses[5])
    js = JSystem(_jcfg(), **SIZES)
    ts = System(_tcfg(), device="cpu", **SIZES)
    j_out = _localize(js, paths["jax"], frame)
    t_out = _localize(ts, paths["jax"], frame)
    assert j_out is not None and t_out is not None
    assert ts.tracking_state is TrackerState.TRACKING
    assert js.tracking_state.value == "Tracking"
    assert np.linalg.norm(j_out[:, 3] - t_out[:, 3]) < 1e-3
    assert _rot_angle(j_out[:, :3], t_out[:, :3]) < 1e-3
    (jt, jp), = js.frame_trajectory()
    (tt, tp), = ts.frame_trajectory()
    assert jt == tt == 99.0
    assert np.linalg.norm(jp[:, 3] - tp[:, 3]) < 1e-3
    assert _rot_angle(jp[:, :3], tp[:, :3]) < 1e-3
    assert ts.num_relocalizations == js.num_relocalizations == 1
    assert ts.num_keyframes == js.num_keyframes == js_build.num_keyframes
    assert (ts.next_kf, ts.next_lm) == (js.next_kf, js.next_lm)
    assert _centre_err(tp, pose) < 0.08


def test_jax_localizes_on_port_map(maps):
    """A map the port saved loads into a JAX System, which localizes a
    mid-sequence frame against it (mapping off: no keyframe added)."""
    _, ts_build, paths = maps
    frames, poses = _sequence()
    frame, pose = _turned(frames[4], poses[4])
    js = JSystem(_jcfg(), **SIZES)
    out = _localize(js, paths["port"], frame)
    assert out is not None
    assert js.tracking_state.value == "Tracking"
    assert js.num_relocalizations == 1
    assert js.num_keyframes == ts_build.num_keyframes
    (_, P), = js.frame_trajectory()
    assert _centre_err(P, pose) < 0.08


def test_load_rejects_other_keypoint_count(maps):
    """A map built with another ORB capacity cannot drive this System's
    tracker: the load says so instead of failing inside it."""
    ts = System(_tcfg(max_num_keypts=300), device="cpu", **SIZES)
    with pytest.raises(ValueError, match="keypoint slots"):
        ts.load_map_database(maps[2]["jax"])


@pytest.mark.slow
def test_localization_from_saved_map(tmp_path):
    """tests/test_map_io.py::test_localization_from_saved_map on the port
    (device="cpu")."""
    from tests.test_system_e2e import _camera, _orb

    jcam = _camera(JSetup.RGBD)
    cam = Camera(**{**_plain(jcam), "setup": CameraSetup.RGBD,
                    "model": CameraModel(jcam.model.value)})
    jorb = _orb()
    cfg = tconfig.Config(camera=cam, orb=OrbParams(**dataclasses.asdict(jorb)), raw={})
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(42), jcam,
                                                  num_frames=10)
    slam = System(cfg, max_keyframes=32, max_landmarks=8192, max_kf_interval=2, device="cpu")
    _feed_all(slam, frames)
    p = str(tmp_path / "map.msg")
    slam.save_map_database(p)

    slam2 = System(cfg, max_keyframes=32, max_landmarks=8192, device="cpu")
    out = _localize(slam2, p, frames[5])
    assert out is not None
    assert slam2.tracking_state is TrackerState.TRACKING
    R_gt, t_gt = poses[5]
    C_est = -out[:, :3].T @ out[:, 3]
    C_gt = -R_gt.T @ t_gt
    assert np.linalg.norm(C_est - C_gt) < 0.08
    # Mapping disabled: no new keyframes were created.
    assert slam2.num_keyframes == slam.num_keyframes
