"""Loop-closure asynchrony on the port: tests/test_loop_latency.py on
``structure_plp_slam_tpu_torch``'s System, on the CPU.

A firing loop must never stall the feed: the System advances the loop
fix as bounded per-frame phases (``System._advance_pending_fix``). The
same scene (tests/test_loop_system.py's organic out-and-back, numpy
seed 42, 320x240), the same drift and the same two assertions:

* STRUCTURAL: the validate and correct phases run on different fed
  frames, and the map correction lands while feeding continues;
* LATENCY: no feed call in the loop window exceeds 25x the run's median
  feed time.
"""

import time

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System, TrackerState
from tests.test_torch_loop_system import _out_and_back, inject_drift

torch.set_num_threads(2)


def _camera():
    return Camera(
        name="synt", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
        cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
        fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0,
        depthmap_factor=1.0,
    )


@pytest.mark.slow
def test_loop_fix_phases_spread_across_frames():
    cam = _camera()
    cfg = Config(camera=cam, orb=OrbParams(max_num_keypts=600, num_levels=4), raw={})
    frames, _ = _out_and_back(cam, 42)
    n_out = len(frames) // 2
    slam = System(cfg, max_keyframes=64, max_landmarks=24576, max_kf_interval=2,
                  device="cpu")
    slam.startup()
    for img, depth, ts in frames[:n_out]:
        slam.feed_RGBD_frame(img, depth, ts)
    assert slam.tracking_state is TrackerState.TRACKING
    inject_drift(slam, torch.from_numpy)

    # Which fed frame ran which phase of the loop fix.
    phase_frames = []
    orig_advance = slam._advance_pending_fix

    def spy():
        f = slam._pending_fix
        if f is not None:
            phase_frames.append((len(feed_times), f["phase"]))
        orig_advance()

    slam._advance_pending_fix = spy

    feed_times = []
    for img, depth, ts in frames[n_out:]:
        t0 = time.perf_counter()
        slam.feed_RGBD_frame(img, depth, ts)
        feed_times.append(time.perf_counter() - t0)
    slam._drain_pending()
    m = slam.metrics()
    slam.shutdown()
    assert m["loops_closed"] >= 1, f"no organic loop closure fired: {m}"

    # STRUCTURAL: the phases ran, on different fed frames.
    assert phase_frames, "loop fix never advanced during the feed"
    frames_used = {i for i, _ in phase_frames}
    phases_used = {p for _, p in phase_frames}
    assert "validate" in phases_used and "correct" in phases_used, phase_frames
    assert len(frames_used) >= 2, f"phases did not spread: {phase_frames}"

    # LATENCY: the loop window's worst feed call within 25x the median.
    med = float(np.median(feed_times))
    worst = float(np.max(feed_times))
    print(f"loop fix phases by fed frame {phase_frames}; worst feed {worst:.3f} s, median "
          f"{med:.3f} s ({worst / med:.2f}x)")
    assert worst <= 25.0 * med, (worst, med)
