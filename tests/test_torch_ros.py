"""The port's ROS adapter with a stubbed rospy (reference:
ros/src/openvslam/src/run_slam.cc image-topic subscriber): copies of
tests/test_ros_adapter.py against structure_plp_slam_tpu_torch/ros.py
(the node's System on device="cpu"), the image decoding and the pose
message held against the JAX package's on the same inputs, and the node's
default System on the card.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu import ros as jros
from structure_plp_slam_tpu.camera import CameraSetup
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel
from structure_plp_slam_tpu_torch.camera import CameraSetup as TSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.ros import RosNode, _decode_image
from structure_plp_slam_tpu_torch.system import TrackerState
from tests import synthetic_scene
from tests.test_system_e2e import _camera, _orb


def _port_cfg(setup):
    jcam = _camera(setup)
    fields = {f.name: getattr(jcam, f.name) for f in dataclasses.fields(jcam)}
    cam = Camera(**{**fields, "setup": TSetup(jcam.setup.value),
                    "model": CameraModel(jcam.model.value)})
    return Config(camera=cam, orb=OrbParams(**dataclasses.asdict(_orb())), raw={})


class _FakeRospy:
    def __init__(self):
        self.subscriptions = []

    def init_node(self, name):
        self.node_name = name

    def Subscriber(self, topic, msg_type, cb, queue_size=1):
        self.subscriptions.append((topic, cb))
        return ("sub", topic)


def _img_msg(img: np.ndarray):
    msg = types.SimpleNamespace()
    msg.height, msg.width = img.shape
    msg.step = img.shape[1]
    msg.encoding = "mono8"
    msg.data = np.clip(img, 0, 255).astype(np.uint8).tobytes()
    msg.header = "hdr"
    return msg


def test_decode_image_encodings():
    g = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert np.allclose(_decode_image(_img_msg(g.astype(np.float32))), g)
    # bgr8: luma of a pure-green image is 0.587 * 200.
    msg = types.SimpleNamespace(height=2, width=3, step=9, encoding="bgr8")
    px = np.zeros((2, 3, 3), np.uint8)
    px[..., 1] = 200
    msg.data = px.tobytes()
    out = _decode_image(msg)
    assert out.shape == (2, 3) and np.allclose(out, 0.587 * 200, atol=0.5)
    msg.encoding = "yuv422"
    with pytest.raises(ValueError):
        _decode_image(msg)


@pytest.mark.parametrize("enc", ["mono8", "8UC1", "bgr8", "rgb8"])
def test_decode_image_matches_jax(enc):
    rng = np.random.default_rng(7)
    h, w = 24, 32
    ch = 1 if enc in ("mono8", "8UC1") else 3
    step = w * ch + 5  # padded rows
    buf = rng.integers(0, 256, (h, step), dtype=np.uint8)
    msg = types.SimpleNamespace(height=h, width=w, step=step, encoding=enc,
                                data=buf.tobytes())
    out = _decode_image(msg)
    assert out.dtype == np.float32 and out.shape == (h, w)
    np.testing.assert_array_equal(out, jros._decode_image(msg))


@pytest.mark.parametrize("turn", [0.3, 3.0])
def test_publish_pose_matches_jax(turn):
    """The pose message from a [3, 4] tensor (what the port's feed
    returns) equals the JAX node's from the same pose as numpy; both
    branches of the quaternion (trace > 0 and the largest diagonal)."""
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(turn) * K + (1 - np.cos(turn)) * K @ K
    P = np.concatenate([R, [[0.4], [-0.2], [1.5]]], 1).astype(np.float32)
    got, want = [], []
    for node, pose, sink in ((RosNode.__new__(RosNode), torch.from_numpy(P), got),
                             (jros.RosNode.__new__(jros.RosNode), P, want)):
        node._pose_pub = lambda header, position, orientation, sink=sink: sink.append(
            (header, np.asarray(position), np.asarray(orientation)))
        node._publish_pose(pose, types.SimpleNamespace(header="hdr"))
    (h, C, q), = got
    (jh, jC, jq), = want
    assert h == jh == "hdr"
    np.testing.assert_allclose(C, jC, atol=1e-6)
    np.testing.assert_allclose(q, jq, atol=1e-6)
    assert abs(np.linalg.norm(q) - 1.0) < 1e-5


def test_ros_node_default_system_needs_card(monkeypatch):
    """The node's System runs on the card unless system_kwargs asks for
    another device: without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RosNode(_port_cfg(CameraSetup.MONOCULAR), rospy_module=_FakeRospy())


@pytest.mark.slow
def test_ros_node_tracks_and_publishes(rng):
    cam = _camera(CameraSetup.MONOCULAR)
    cfg = _port_cfg(CameraSetup.MONOCULAR)
    frames, _ = synthetic_scene.make_sequence(rng, cam, num_frames=8, step=0.08)

    fake = _FakeRospy()
    node = RosNode(
        cfg, image_topic="cam0/raw", rospy_module=fake,
        system_kwargs=dict(max_keyframes=32, max_landmarks=8192,
                           max_kf_interval=3, device="cpu"),
    )
    # Bypass sensor_msgs import: the fake subscriber ignores the type.
    node._image_msg_type = lambda: object
    poses = []
    node.start(pose_publish_fn=lambda header, position, orientation:
               poses.append((header, position, orientation)))
    assert fake.node_name == "structure_plp_slam_tpu"
    topic, cb = fake.subscriptions[0]
    assert topic == "cam0/raw"
    for img, _depth, _ts in frames:
        cb(_img_msg(img))
    assert node.system.tracking_state is TrackerState.TRACKING
    assert len(node.track_times) == len(frames)
    assert len(poses) >= 1
    hdr, C, q = poses[-1]
    assert hdr == "hdr"
    assert np.isfinite(C).all() and abs(np.linalg.norm(q) - 1.0) < 1e-5
