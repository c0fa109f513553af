"""ROS adapter: run the SLAM system as an image-topic subscriber node.

Port of structure_plp_slam_tpu/ros.py. Counterpart of the reference's ROS1
wrapper (ros/src/openvslam/src/run_slam.cc:57-64): subscribe to a raw image
topic, feed each message as a monocular frame, publish the tracked pose.
ROS is not part of this environment, so ``rospy`` is imported lazily —
constructing ``RosNode`` without a ROS installation raises a clear error,
and everything above the import seam is unit-testable with a stubbed
``rospy``/``sensor_msgs``.

Usage on a ROS1 machine:

    from structure_plp_slam_tpu_torch.config import load_config
    from structure_plp_slam_tpu_torch.ros import RosNode
    node = RosNode(load_config("cfg.yaml"), image_topic="camera/image_raw")

The System it builds runs on the card unless ``system_kwargs`` asks for
another device (``{"device": "cpu"}``).
    node.spin()
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from structure_plp_slam_tpu_torch.utils.types import to_host


def _decode_image(msg) -> np.ndarray:
    """sensor_msgs/Image → float32 grayscale [H, W] (no cv_bridge
    dependency; handles the encodings the reference pipeline feeds)."""
    h, w, enc = msg.height, msg.width, msg.encoding
    buf = np.frombuffer(msg.data, np.uint8)
    if enc in ("mono8", "8UC1"):
        img = buf.reshape(h, msg.step)[:, :w].astype(np.float32)
    elif enc in ("bgr8", "rgb8"):
        px = buf.reshape(h, msg.step)[:, : w * 3].reshape(h, w, 3)
        b, g, r = (px[..., 0], px[..., 1], px[..., 2])
        if enc == "rgb8":
            r, b = b, r
        # BT.601 luma, matching util::convert_to_grayscale's cv::cvtColor.
        img = 0.114 * b + 0.587 * g + 0.299 * r
    else:
        raise ValueError(f"unsupported image encoding {enc!r}")
    return np.ascontiguousarray(img, dtype=np.float32)


class RosNode:
    """Monocular SLAM fed from a ROS image topic.

    The tracked pose is published as a ``geometry_msgs/PoseStamped`` on
    ``~pose`` (role of the reference's ros/src/publisher mirror)."""

    def __init__(self, config, *, image_topic: str = "camera/image_raw",
                 node_name: str = "structure_plp_slam_tpu",
                 world_frame_id: str = "map",
                 system_kwargs: Optional[dict] = None, rospy_module=None):
        if rospy_module is None:  # pragma: no cover - needs a ROS install
            try:
                import rospy as rospy_module
            except ImportError as e:
                raise RuntimeError(
                    "ROS (rospy) is not installed; RosNode requires a ROS1 "
                    "environment. Use the dataset/video CLI drivers instead."
                ) from e
        self._rospy = rospy_module
        from structure_plp_slam_tpu_torch.system import System

        self.system = System(config, **(system_kwargs or {}))
        self.image_topic = image_topic
        self.node_name = node_name
        self.world_frame_id = world_frame_id
        self.track_times: list = []
        self._t0 = None
        self._started = False

    def _on_image(self, msg):
        if self._t0 is None:
            self._t0 = time.perf_counter()
        ts = time.perf_counter() - self._t0
        t1 = time.perf_counter()
        pose = self.system.feed_monocular_frame(_decode_image(msg), ts)
        self.track_times.append(time.perf_counter() - t1)
        if pose is not None:
            self._publish_pose(pose, msg)

    def _publish_pose(self, pose_cw, img_msg):
        pub = getattr(self, "_pose_pub", None)
        if pub is None:
            return
        pose_cw = to_host(pose_cw)  # the feed's [3, 4] tensor, on the card
        R, t = pose_cw[:, :3], pose_cw[:, 3]
        C = -R.T @ t  # camera center in world
        # Rotation (world→cam)ᵀ as a quaternion (w last per ROS).
        Rwc = R.T
        tr = np.trace(Rwc)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q = np.array([(Rwc[2, 1] - Rwc[1, 2]) / s,
                          (Rwc[0, 2] - Rwc[2, 0]) / s,
                          (Rwc[1, 0] - Rwc[0, 1]) / s, 0.25 * s])
        else:
            i = int(np.argmax(np.diag(Rwc)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(1.0 + Rwc[i, i] - Rwc[j, j] - Rwc[k, k]) * 2
            q = np.zeros(4)
            q[i] = 0.25 * s
            q[j] = (Rwc[j, i] + Rwc[i, j]) / s
            q[k] = (Rwc[k, i] + Rwc[i, k]) / s
            q[3] = (Rwc[k, j] - Rwc[j, k]) / s
        pub(header=getattr(img_msg, "header", None), position=C, orientation=q)

    def start(self, pose_publish_fn=None):
        """Initialize the node and subscribe. ``pose_publish_fn`` (used in
        tests) overrides the default PoseStamped publisher. Idempotent:
        a second call is a no-op (so start() + spin() composes)."""
        if self._started:
            return
        self._started = True
        rospy = self._rospy
        rospy.init_node(self.node_name)
        self._pose_pub = pose_publish_fn or self._make_pose_publisher()
        self.system.startup()
        self._sub = rospy.Subscriber(
            self.image_topic, self._image_msg_type(), self._on_image,
            queue_size=1,
        )

    def _image_msg_type(self):
        from sensor_msgs.msg import Image  # pragma: no cover

        return Image

    def _make_pose_publisher(self):  # pragma: no cover - needs ROS
        from geometry_msgs.msg import PoseStamped

        rospy = self._rospy
        topic = rospy.Publisher("~pose", PoseStamped, queue_size=1)

        def publish(header, position, orientation):
            msg = PoseStamped()
            if header is not None:
                # Keep the image stamp, but the pose is expressed in the
                # WORLD frame — the camera optical frame_id from the image
                # header would be semantically wrong for TF consumers.
                msg.header.stamp = header.stamp
            msg.header.frame_id = self.world_frame_id
            msg.pose.position.x, msg.pose.position.y, msg.pose.position.z = (
                float(position[0]), float(position[1]), float(position[2])
            )
            (msg.pose.orientation.x, msg.pose.orientation.y,
             msg.pose.orientation.z, msg.pose.orientation.w) = (
                float(orientation[0]), float(orientation[1]),
                float(orientation[2]), float(orientation[3])
            )
            topic.publish(msg)

        return publish

    def spin(self):  # pragma: no cover - needs ROS
        self.start()  # no-op if the caller already started with options
        self._rospy.spin()
        self.system.shutdown()
