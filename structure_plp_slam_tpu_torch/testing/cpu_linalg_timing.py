"""CPU wall time of the port's steps that lean on small factorizations
(ROADMAP C45).

    python -m structure_plp_slam_tpu_torch.testing.cpu_linalg_timing [--repeats 3] [--threads 2]

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
  every match.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2, help="torch's CPU thread count")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for measure in (global_ba_iter, mono_init):
        print(json.dumps(dict(measure(args.repeats), threads=args.threads)), flush=True)


if __name__ == "__main__":
    main()
