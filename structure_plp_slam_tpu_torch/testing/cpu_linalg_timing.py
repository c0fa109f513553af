"""CPU wall time of the port's steps that lean on small factorizations
(ROADMAP C45).

    python -m structure_plp_slam_tpu_torch.testing.cpu_linalg_timing [--repeats 3] [--threads 2] [--only NAME ...]

On the CPU, ``ops/linalg`` loops every batch of small factorizations
into scipy's LAPACK, one call per matrix, as XLA:CPU computes them; this
script times the two steps where those batches are largest. Everything
runs on the CPU. Prints one JSON object per measurement, the median of
``--repeats`` runs after one warm-up, in seconds:

* ``global_ba_iter``: one iteration of the dense global BA
  (``global_ba.solve``, ``num_iters=1``) on testing/large_map.py's chain
  at K = 256 keyframes, 128 landmarks per keyframe and 256 slots (L =
  32,768, the loop path's landmark capacity; numpy seed 0): the landmark
  blocks' 3x3 inverses over L and the 1536-row camera Cholesky;
* ``mono_init``: ``initializer.try_initialize_mono`` at 640x480 with
  1000 keypoints over 8 levels, on the frontend's features of numpy seed
  42's frames 0 and 2 (0.16 m apart; key 0): the 8-point and homography
  SVDs over the RANSAC hypotheses and the triangulation's eigh over
  every match;
* ``track_frame_320x240`` and ``track_frame_640x480``: ``tracker.track_frame``
  inside an RGB-D System (loop closing off) on numpy seed 0's synthetic
  sequence, 600 keypoints over 4 levels at 320x240 and 1000 over 8 at
  640x480: the median of the frames after the first tracked one, over
  ``--repeats`` + 4 frames (its two pose solves are ``ops/pose_cpu``'s C
  source on the CPU).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from structure_plp_slam_tpu_torch import system as system_mod
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.models import global_ba, initializer
from structure_plp_slam_tpu_torch.models.frontend import Frontend
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.testing import synthetic_scene
from structure_plp_slam_tpu_torch.testing.large_map import build_large_map
from structure_plp_slam_tpu_torch.utils import prng


def _median_seconds(fn, repeats: int) -> float:
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def global_ba_iter(repeats: int) -> dict:
    cam, state, _ = build_large_map(np.random.default_rng(0), K=256, lm_per_kf=128, N=256,
                                    device="cpu")
    data = global_ba.prepare(state, torch.ones(8))
    K = state.kf_pose.shape[0]
    fixed = torch.arange(K) == 0

    def run():
        global_ba.solve(cam, state.kf_pose, state.kf_valid, fixed, state.lm_pos,
                        state.lm_valid, data, num_iters=1)

    return dict(name="global_ba_iter", K=K, L=int(state.lm_pos.shape[0]),
                observations=int(data.num_obs), seconds=_median_seconds(run, repeats))


def mono_init(repeats: int) -> dict:
    cam = Camera(name="b", setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE,
                 cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5, fps=30.0)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, 3, step=0.08)
    fe = Frontend(cam, OrbParams(max_num_keypts=1000, num_levels=8), pad_to=1032,
                  device="cpu")
    f1, f2 = (fe.mono(torch.as_tensor(frames[i][0])) for i in (0, 2))
    out = {}

    def run():
        out["res"] = initializer.try_initialize_mono(cam, f1, f2, prng.PRNGKey(0))

    seconds = _median_seconds(run, repeats)
    return dict(name="mono_init", success=bool(out["res"].success),
                points=int(out["res"].num_points), seconds=seconds)


def _track_frame(repeats: int, cols: int, rows: int, f: float, keypoints: int,
                 levels: int) -> dict:
    cam = Camera(name="t", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, cols=cols,
                 rows=rows, fx=f, fy=f, cx=(cols - 1) / 2, cy=(rows - 1) / 2, fps=30.0,
                 focal_x_baseline=f * 0.1, depth_threshold=400.0, depthmap_factor=1.0)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(0), cam, repeats + 4)
    slam = system_mod.System(
        Config(camera=cam, orb=OrbParams(max_num_keypts=keypoints, num_levels=levels), raw={}),
        device="cpu", enable_loop_closing=False, max_keyframes=16, max_landmarks=8192)
    times = []
    track = system_mod.tracker.track_frame

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = track(*a, **k)
        times.append(time.perf_counter() - t0)
        return out

    system_mod.tracker.track_frame = timed
    try:
        slam.startup()
        for img, depth, ts in frames:
            slam.feed_RGBD_frame(img, depth, ts)
        slam.shutdown()
    finally:
        system_mod.tracker.track_frame = track
    return dict(name=f"track_frame_{cols}x{rows}", calls=len(times),
                seconds=statistics.median(times[1:]))


def track_frame_320(repeats: int) -> dict:
    return _track_frame(repeats, 320, 240, 260.0, 600, 4)


def track_frame_640(repeats: int) -> dict:
    return _track_frame(repeats, 640, 480, 525.0, 1000, 8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2, help="torch's CPU thread count")
    ap.add_argument("--only", nargs="*", help="measurements to run (default: all)")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for measure in (global_ba_iter, mono_init, track_frame_320, track_frame_640):
        if args.only and measure.__name__ not in args.only:
            continue
        print(json.dumps(dict(measure(args.repeats), threads=args.threads)), flush=True)


if __name__ == "__main__":
    main()
