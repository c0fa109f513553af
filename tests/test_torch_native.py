"""The port's bindings to the native C++ runtime (native/, built with
make): copies of tests/test_native.py against
structure_plp_slam_tpu_torch/native.py, a build that fails raising with
make's output, and the System's autosave and native publisher on 6
frames of tests/synthetic_scene.py (320x240, numpy seed 42, device
"cpu")."""

import os
import socket
import struct
import time

import msgpack
import numpy as np
import pytest
import torch

from structure_plp_slam_tpu_torch import native


def test_snapshot_writer_roundtrip(tmp_path):
    p = str(tmp_path / "snap.bin")
    with native.AsyncSnapshotWriter(p) as w:
        blob = b"hello-map-" * 1000
        w.submit(blob)
        w.wait()
        assert open(p, "rb").read() == blob
        # Latest-wins: submit several, only need the last.
        for i in range(5):
            w.submit(f"v{i}".encode() * 10)
        w.wait()
        assert open(p, "rb").read() == b"v4" * 10


def test_publisher_broadcast():
    with native.NativePublisher() as pub:
        port = pub.port
        assert port > 0
        cli = socket.create_connection(("127.0.0.1", port), timeout=5)
        # Wait for the server to register the client.
        for _ in range(100):
            if pub.num_clients >= 1:
                break
            time.sleep(0.01)
        assert pub.num_clients == 1

        payload = np.arange(1000, dtype=np.float32).tobytes()
        pub.publish(payload)

        hdr = b""
        while len(hdr) < 4:
            hdr += cli.recv(4 - len(hdr))
        (n,) = struct.unpack("!I", hdr)
        assert n == len(payload)
        buf = b""
        while len(buf) < n:
            buf += cli.recv(n - len(buf))
        np.testing.assert_array_equal(
            np.frombuffer(buf, np.float32), np.arange(1000, dtype=np.float32)
        )
        cli.close()
        time.sleep(0.05)

    # Probe: publishing with no clients must be a no-op, not an error.
    with native.NativePublisher() as pub2:
        pub2.publish(b"nobody-listening")
        assert pub2.num_clients == 0


def test_map_packet_stream():
    """Stream a serialized map snapshot like the system would."""
    from structure_plp_slam_tpu_torch.data import map_state as ms

    state = ms.create(4, 32, 64, device="cpu")
    doc = msgpack.packb(
        {"lm": state.lm_pos.numpy().tobytes(), "n": 64}, use_bin_type=True
    )
    with native.NativePublisher() as pub:
        cli = socket.create_connection(("127.0.0.1", pub.port), timeout=5)
        for _ in range(100):
            if pub.num_clients >= 1:
                break
            time.sleep(0.01)
        pub.publish(doc)
        hdr = b""
        while len(hdr) < 4:
            hdr += cli.recv(4 - len(hdr))
        (n,) = struct.unpack("!I", hdr)
        buf = b""
        while len(buf) < n:
            buf += cli.recv(n - len(buf))
        decoded = msgpack.unpackb(buf, raw=False)
        assert decoded["n"] == 64
        cli.close()


def _recv_packet(cli):
    hdr = b""
    while len(hdr) < 4:
        hdr += cli.recv(4 - len(hdr))
    (n,) = struct.unpack("!I", hdr)
    buf = b""
    while len(buf) < n:
        buf += cli.recv(n - len(buf))
    return buf


def test_failed_build_raises_with_make_output(tmp_path, monkeypatch):
    """No library and a make that fails: the load raises, and the message
    carries make's output (the JAX package's loader returns None)."""
    (tmp_path / "Makefile").write_text("all:\n\t@echo broken-toolchain-here >&2; false\n")
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "libplpslam_native.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="broken-toolchain-here"):
        native.AsyncSnapshotWriter(str(tmp_path / "snap.bin"))
    with pytest.raises(RuntimeError, match="make exited"):
        native.NativePublisher()


def test_system_autosave_and_native_publisher(tmp_path):
    """A port System with autosave every 2 keyframes and the native
    publisher: a client gets one length-prefixed msgpack packet per
    keyframe at most, the last with the map's final counts;
    the autosave file loads, with the counters of an autosaved keyframe."""
    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.config import Config
    from structure_plp_slam_tpu_torch.io import map_io
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams
    from structure_plp_slam_tpu_torch.system import System
    from tests import synthetic_scene

    torch.set_num_threads(2)
    cam = Camera(name="synt", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
                 cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5, fps=30.0,
                 focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
    cfg = Config(camera=cam, orb=OrbParams(max_num_keypts=600, num_levels=4), raw={})
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, num_frames=6)
    slam = System(cfg, max_keyframes=16, max_landmarks=4096, max_kf_interval=2,
                  enable_loop_closing=False, device="cpu")
    auto = str(tmp_path / "auto.msg")
    slam.enable_autosave(auto, every_n_keyframes=2)
    port = slam.start_native_publisher()
    cli = socket.create_connection(("127.0.0.1", port), timeout=60)
    for _ in range(200):
        if slam._native_pub.num_clients >= 1:
            break
        time.sleep(0.01)
    saved = []
    slam.startup()
    for img, depth, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
        if slam.next_kf % 2 == 0:
            saved.append((slam.next_kf, int(slam.next_lm)))
    slam._drain_pending()
    if slam.next_kf % 2 == 0:
        saved.append((slam.next_kf, int(slam.next_lm)))
    chains = slam.timer.summary()["kf.publish"]["count"]
    final = (slam.num_landmarks, slam.num_keyframes)
    # Each connection's sender is latest-wins: packets queued while one is
    # on the wire are replaced by the newest, so the client sees at most
    # one per keyframe and always the last.
    packets = []
    while not packets or (packets[-1]["num_landmarks"], packets[-1]["num_keyframes"]) != final:
        packets.append(msgpack.unpackb(_recv_packet(cli), raw=False))
    sent = slam._native_pub.packets_sent
    slam.shutdown()  # closes the writer after its last write, and the publisher
    cli.close()
    assert chains >= 2 and 1 <= len(packets) <= sent <= chains
    last = packets[-1]
    pts = np.frombuffer(last["landmarks"], np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(pts, slam.get_landmarks())
    assert np.frombuffer(last["current_pose"], np.float32).shape == (12,)
    assert os.path.exists(auto)
    state, counters = map_io.load_map_with_counters(auto, device="cpu")
    assert (counters["next_kf"], counters["next_lm"]) in saved
    assert counters["next_kf"] % 2 == 0
    assert int(state.kf_valid.sum()) >= 2
