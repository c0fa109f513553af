"""The port's CLI (structure_plp_slam_tpu_torch/run.py) end to end on
fabricated datasets, on the CPU (``--device cpu``); reference:
example/run_tum_rgbd_slam.cc, run_video_slam.cc driver surfaces.

Not slow: on an 8-frame TUM RGB-D layout of tests/synthetic_scene.py
(numpy seed 42, 320x240, 600 keypoints over 4 levels, 16 keyframes / 4096
landmarks) the CLI writes trajectory files equal to those of a port
System fed the same decoded frames directly, its map snapshot and HTML
export, and localizes against the saved map with mapping off. The slow
cases are the port's copies of tests/test_run_cli.py's three drivers.
"""

import json
import os

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch import run as run_mod
from tests import synthetic_scene

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

_YAML = """%YAML:1.0
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


def _camera(setup):
    return Camera(
        name="synth", setup=setup, model=CameraModel.PERSPECTIVE,
        cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5, fps=30.0,
    )


def _write_tum(tmp_path, rng, n=10):
    cam = _camera(CameraSetup.RGBD)
    tex = synthetic_scene.make_texture(rng)
    poses = synthetic_scene.trajectory(n, step=0.06)
    os.makedirs(tmp_path / "rgb")
    os.makedirs(tmp_path / "depth")
    rgb_lines, depth_lines = [], []
    for i, (R, t) in enumerate(poses):
        img, depth = synthetic_scene.render(cam, tex, R, t)
        ts = i / 30.0
        cv2.imwrite(str(tmp_path / "rgb" / f"{i}.png"), img.astype(np.uint8))
        cv2.imwrite(
            str(tmp_path / "depth" / f"{i}.png"),
            (depth * 5000.0).astype(np.uint16),
        )
        rgb_lines.append(f"{ts:.6f} rgb/{i}.png")
        depth_lines.append(f"{ts:.6f} depth/{i}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    return poses


_SMALL = ["--max-keyframes", "16", "--max-landmarks", "4096", "--device", "cpu"]


@pytest.fixture(scope="module")
def tum8(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum8")
    poses = _write_tum(root, np.random.default_rng(42), n=8)
    cfg = root / "cfg.yaml"
    cfg.write_text(_YAML.format(setup="rgbd"))
    return root, cfg, poses


def _cli(capsys, *argv):
    run_mod.main(list(argv))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_matches_system(tum8, tmp_path, capsys, monkeypatch):
    """The CLI's trajectories equal those of a port System fed the same
    decoded frames (load_tum_rgbd, imread_gray, raw imread_depth) in
    order; its map snapshot and HTML export are written."""
    from structure_plp_slam_tpu_torch.config import load_config
    from structure_plp_slam_tpu_torch.io import datasets, map_io
    from structure_plp_slam_tpu_torch.system import System

    root, cfg, _ = tum8
    monkeypatch.chdir(tmp_path)
    out = _cli(capsys, "tum_rgbd", "-c", str(cfg), "-d", str(root), *_SMALL, "--eval-log",
               "--map-db-out", "map.msg", "--export-map-html", "map.html")
    assert out["frames"] == 8 and out["keyframes"] >= 2 and out["landmarks"] > 100
    assert set(out) == {"frames", "keyframes", "landmarks", "lines", "planes", "loops_closed",
                        "median_track_time_s", "mean_track_time_s"}
    assert len((tmp_path / "track_times.txt").read_text().split()) == 8
    html = (tmp_path / "map.html").read_text()
    assert "<canvas" in html and "keyframes" in html

    slam = System(load_config(str(cfg)), max_keyframes=16, max_landmarks=4096, device="cpu")
    slam.startup()
    for rec in datasets.load_tum_rgbd(str(root)):
        slam.feed_RGBD_frame(datasets.imread_gray(rec.img_path),
                             datasets.imread_depth(rec.depth_path).astype(np.float32),
                             rec.timestamp)
    slam.shutdown()
    slam.save_frame_trajectory(str(tmp_path / "direct_frames.txt"))
    slam.save_keyframe_trajectory(str(tmp_path / "direct_keyframes.txt"))
    assert (tmp_path / "frame_trajectory.txt").read_text() == \
        (tmp_path / "direct_frames.txt").read_text()
    assert (tmp_path / "keyframe_trajectory.txt").read_text() == \
        (tmp_path / "direct_keyframes.txt").read_text()
    assert (out["keyframes"], out["landmarks"]) == (slam.num_keyframes, slam.num_landmarks)
    counters = map_io.load_counters(str(tmp_path / "map.msg"))
    assert (counters["next_kf"], counters["next_lm"]) == (slam.next_kf, int(slam.next_lm))

    # Localization: the saved map, mapping off, the first 3 frames.
    out = _cli(capsys, "tum_rgbd", "-c", str(cfg), "-d", str(root), *_SMALL,
               "--map-db-in", "map.msg", "--max-frames", "3", "--frame-traj", "loc.txt",
               "--traj-format", "kitti")
    assert out["frames"] == 3 and out["keyframes"] == slam.num_keyframes
    rows = (tmp_path / "loc.txt").read_text().strip().splitlines()
    assert len(rows) == 3 and all(len(r.split()) == 12 for r in rows)


def test_cli_runs_on_the_card_by_default(tum8, capsys, monkeypatch):
    """Without --device the CLI's System asks for the card, and raises
    where there is none."""
    root, cfg, _ = tum8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mod.main(["tum_rgbd", "-c", str(cfg), "-d", str(root), "--max-frames", "1"])


@pytest.mark.slow
def test_tum_rgbd_driver(tmp_path, rng, capsys, monkeypatch):
    poses = _write_tum(tmp_path, rng)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(_YAML.format(setup="rgbd"))
    monkeypatch.chdir(tmp_path)
    run_mod.main([
        "tum_rgbd", "-c", str(cfg), "-d", str(tmp_path),
        "--max-keyframes", "32", "--max-landmarks", "8192", "--device", "cpu", "--eval-log",
        "--map-db-out", str(tmp_path / "map.msg"),
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 10
    assert out["keyframes"] >= 2
    assert out["landmarks"] > 100
    assert (tmp_path / "frame_trajectory.txt").exists()
    assert (tmp_path / "keyframe_trajectory.txt").exists()
    assert (tmp_path / "track_times.txt").exists()
    assert (tmp_path / "map.msg").stat().st_size > 1000
    traj = (tmp_path / "frame_trajectory.txt").read_text().strip().splitlines()
    assert len(traj) >= 8 and len(traj[0].split()) == 8  # TUM format
    # ATE regression through the full CLI path (PNG depth round-trip +
    # PrefetchReader + depthmap_factor): guards against depth-scaling
    # bugs anywhere between disk and the frontend.
    from structure_plp_slam_tpu_torch.io import trajectory as traj_io

    est = traj_io.load_tum(str(tmp_path / "frame_trajectory.txt"))
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1).astype(np.float64))
          for i, (R, t) in enumerate(poses)]
    ate = traj_io.ate_rmse(est, gt, align_scale=False)
    assert ate < 0.05, f"CLI ATE {ate}"


@pytest.mark.slow
def test_tum_rgbd_driver_with_masks(tmp_path, rng, capsys, monkeypatch):
    """--mask-dir drives the plane pipeline from the CLI (reference:
    run_slam_planeSeg.cc drivers)."""
    cam = _camera(CameraSetup.RGBD)
    tex = synthetic_scene.make_texture(rng)
    poses = synthetic_scene.trajectory(8, step=0.06)
    os.makedirs(tmp_path / "rgb")
    os.makedirs(tmp_path / "depth")
    os.makedirs(tmp_path / "mask")
    rgb_lines, depth_lines = [], []
    for i, (R, t) in enumerate(poses):
        img, depth = synthetic_scene.render(cam, tex, R, t)
        cv2.imwrite(str(tmp_path / "rgb" / f"{i}.png"), img.astype(np.uint8))
        cv2.imwrite(
            str(tmp_path / "depth" / f"{i}.png"),
            (depth * 5000.0).astype(np.uint16),
        )
        cv2.imwrite(
            str(tmp_path / "mask" / f"{i}.png"),
            np.where(depth < 4.5, 1, 2).astype(np.uint8),
        )
        ts = i / 30.0
        rgb_lines.append(f"{ts:.6f} rgb/{i}.png")
        depth_lines.append(f"{ts:.6f} depth/{i}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(_YAML.format(setup="rgbd"))
    monkeypatch.chdir(tmp_path)
    run_mod.main([
        "tum_rgbd", "-c", str(cfg), "-d", str(tmp_path),
        "--mask-dir", str(tmp_path / "mask"),
        "--max-keyframes", "32", "--max-landmarks", "8192", "--device", "cpu",
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["planes"] >= 1


@pytest.mark.slow
def test_video_driver(tmp_path, rng, capsys, monkeypatch):
    cam = _camera(CameraSetup.MONOCULAR)
    tex = synthetic_scene.make_texture(rng)
    poses = synthetic_scene.trajectory(12, step=0.08)
    vid = str(tmp_path / "seq.avi")
    vw = cv2.VideoWriter(
        vid, cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (320, 240), False
    )
    assert vw.isOpened()
    for R, t in poses:
        img, _ = synthetic_scene.render(cam, tex, R, t)
        vw.write(img.astype(np.uint8))
    vw.release()
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(_YAML.format(setup="monocular"))
    monkeypatch.chdir(tmp_path)
    run_mod.main([
        "video", "-c", str(cfg), "--video", vid,
        "--max-keyframes", "32", "--max-landmarks", "8192", "--device", "cpu",
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 12
    assert out["keyframes"] >= 2
    assert (tmp_path / "frame_trajectory.txt").exists()
