"""The port's copy of tests/test_long_sequence.py's CLI run: a
1000-frame TUM-format RGB-D dataset (rgb/ + depth/ + rgb.txt + depth.txt
+ groundtruth.txt, 16-bit depth at 5000/m) fabricated on disk from
tests/synthetic_scene.py (numpy seed 5, 320x240) and driven through the
port's ``run.py tum_rgbd --device cpu`` — the reference's
example/run_tum_rgbd_slam.cc protocol — gating ATE, trajectory length,
AUTO-GROW activation (capacities start at 32 keyframes) and total wall
time, with the original's bounds.
"""

import json
import os
import time

import numpy as np
import pytest

from structure_plp_slam_tpu.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.io import trajectory as traj_io
from tests import synthetic_scene

cv2 = pytest.importorskip("cv2")

_YAML = """%YAML:1.0
Camera.name: long
Camera.setup: RGBD
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

N_FRAMES = 1000


def _camera():
    return Camera(
        name="long", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
        cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
        fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0,
        depthmap_factor=5000.0,
    )


def _trajectory(n=N_FRAMES):
    """Two out-and-back excursions (x then y) with soft starts — two
    revisits of the origin region."""
    leg = n // 4
    xs = np.zeros((n, 3))
    ramp = np.minimum(1.0, (np.arange(leg) + 1) / 10.0) * 0.05
    out = np.cumsum(ramp)
    xs[:leg, 0] = out
    xs[leg:2 * leg, 0] = out[::-1]
    xs[2 * leg:3 * leg, 1] = out[:leg]
    xs[3 * leg:4 * leg, 1] = out[::-1][:n - 3 * leg]
    poses = []
    for C in xs:
        R = np.eye(3)
        poses.append((R, -R @ C))
    return poses


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("tum_long")
    cam = _camera()
    tex = synthetic_scene.make_texture(rng, size=1536)
    poses = _trajectory()
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rgb_lines, depth_lines, gt_lines = [], [], []
    span = 0.05 * (N_FRAMES // 4)
    for i, (R, t) in enumerate(poses):
        img, depth = synthetic_scene.render(
            cam, tex, R, t, plane_half=span + 8.0
        )
        ts = i / 30.0
        cv2.imwrite(str(root / "rgb" / f"{i:06d}.png"),
                    img.astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i:06d}.png"),
                    (depth * 5000.0).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} rgb/{i:06d}.png")
        depth_lines.append(f"{ts:.6f} depth/{i:06d}.png")
        C = -R.T @ t
        gt_lines.append(f"{ts:.6f} {C[0]} {C[1]} {C[2]} 0 0 0 1")
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    (root / "config.yaml").write_text(_YAML)
    return root, poses


@pytest.mark.slow
def test_long_tum_cli_ate_growth_walltime(tum_dir, capsys, monkeypatch):
    from structure_plp_slam_tpu_torch import run as run_mod

    root, poses = tum_dir
    t0 = time.perf_counter()
    monkeypatch.chdir(root)
    run_mod.main([
        "tum_rgbd", "-c", str(root / "config.yaml"), "-d", str(root),
        "--max-keyframes", "32", "--max-landmarks", "8192",
        "--eval-log", "--device", "cpu",
    ])
    wall = time.perf_counter() - t0
    out = capsys.readouterr().out
    info = json.loads(out.strip().splitlines()[-1])
    # Auto-grow must have fired (starting capacity 32 keyframes cannot
    # hold a 1000-frame two-excursion run).
    assert info["keyframes"] > 32, info
    est = traj_io.load_tum(str(root / "frame_trajectory.txt"))
    gt = traj_io.load_tum(str(root / "groundtruth.txt"))
    ate = traj_io.ate_rmse(est, gt)
    assert ate < 0.08, f"ATE {ate:.3f} over {len(est)} frames"
    assert len(est) >= 0.95 * N_FRAMES, len(est)
    # Wall-time gate: CI-scale bound (CPU, uncached jit) — catches
    # pathological slowdowns, not a perf benchmark.
    assert wall < 3000.0, wall
