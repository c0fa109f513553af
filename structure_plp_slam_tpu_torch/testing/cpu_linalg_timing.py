"""CPU wall time of the port's steps that lean on small factorizations
(ROADMAP C45).

    python -m structure_plp_slam_tpu_torch.testing.cpu_linalg_timing [--repeats 3] [--threads 2] [--only NAME ...]

On the CPU, ``ops/linalg`` loops every batch of small factorizations
into scipy's LAPACK, one call per matrix, as XLA:CPU computes them; this
script times the steps where those batches are largest, and the steps
that compute XLA:CPU's arithmetic in a C source. Everything
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
  source on the CPU);
* ``init_ba_640x480``: the monocular System's two-view BA after its init
  (its first ``mapper.local_ba`` call: 8 window cameras, 4096 landmark
  slots; ``ops/ba_cpu``'s C source on the CPU) at 640x480 with 1000
  keypoints over 8 levels on numpy seed 42's sequence, a new System per
  repeat;
* ``chain_ba_640x480``: the local BA of the same System's first keyframe
  chain after the init (its first ``mapper.local_ba`` call with
  ``return_cams``: 32 window cameras, 4096 landmark slots; ``ops/ba_cpu``'s
  C source on the CPU), the call recorded once and repeated;
* ``kf_chain_640x480``: that chain whole (``system._kf_chain``: insert,
  cull, triangulate, fuse, the local BA, the statistics; XLA:CPU's
  arithmetic on the CPU), recorded once and repeated on its input;
* ``chain_ba_rgbd_640x480`` and ``kf_chain_rgbd_640x480``: the same two for
  the main path's RGB-D System (focal_x_baseline 40, numpy seed 42's
  sequence at 0.06 m a frame), whose window's observations carry stereo
  rows from the depth (the C source's 3-row arithmetic on the CPU);
* ``chain_ba_c16_320x240``: the local BA of the first keyframe chain of the
  tier-1 tests' RGB-D System (320x240, 600 keypoints over 4 levels,
  focal_x_baseline 26, numpy seed 42's sequence, 8 keyframes and 4096
  landmarks): a window of 16 cameras, the C source's 16-camera layout on
  the CPU;
* ``match_stereo_640x480``, ``match_stereo_752x480`` and
  ``match_stereo_1241x376``: the stereo frontend's ``match_stereo`` on one
  rendered pair (numpy seed 0) at the 640x480 main path's camera (0.1 m
  baseline, 1000 keypoints, 1,032 slots) and at EuRoC's and KITTI's image
  size, focal length and baseline (1000 keypoints and 1,032 slots; 2000
  and 2,040), 8 levels: its SAD sums are XLA:CPU's tree order on the CPU
  (``ops/linalg.tree_sum``).
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
from structure_plp_slam_tpu_torch.models import frontend as frontend_mod
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


def init_ba_640(repeats: int) -> dict:
    cam = Camera(name="b", setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE,
                 cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5, fps=30.0)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, 12, step=0.08)
    local_ba = system_mod.mapper.local_ba
    times = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = local_ba(*a, **k)
        times.append(time.perf_counter() - t0)
        return out

    per_run = []
    system_mod.mapper.local_ba = timed
    try:
        for _ in range(repeats + 1):
            times.clear()
            slam = system_mod.System(
                Config(camera=cam, orb=OrbParams(max_num_keypts=1000, num_levels=8), raw={}),
                device="cpu", enable_loop_closing=False, max_keyframes=32, max_landmarks=8192)
            slam.startup()
            for img, _, ts in frames:
                slam.feed_monocular_frame(img, ts)
                if times:
                    break
            slam.shutdown()
            per_run.append(times[0])
    finally:
        system_mod.mapper.local_ba = local_ba
    return dict(name="init_ba_640x480", seconds=statistics.median(per_run[1:]))


def _first_chain_call(owner, name: str, want, rgbd: bool = False, small: bool = False):
    """The first call of ``owner.name`` that ``want(kwargs)`` accepts, in
    the monocular System at 640x480 (1000 keypoints over 8 levels, numpy
    seed 42's sequence, 32 keyframes), or with ``rgbd`` in the RGB-D System
    of the main path's camera, or with ``small`` too in the tier-1 tests'
    RGB-D System (320x240, 600 keypoints over 4 levels, 8 keyframes and 4096
    landmarks): ``(the function, args, kwargs)``."""
    depth = dict(focal_x_baseline=26.0 if small else 40.0,
                 depth_threshold=400.0 if small else 40.0, depthmap_factor=1.0) if rgbd else {}
    if small:
        intr = dict(cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
        orb, sizes = dict(max_num_keypts=600, num_levels=4), dict(max_keyframes=8,
                                                                   max_landmarks=4096)
    else:
        intr = dict(cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)
        orb, sizes = dict(max_num_keypts=1000, num_levels=8), dict(max_keyframes=32,
                                                                   max_landmarks=8192)
    cam = Camera(name="b", setup=CameraSetup.RGBD if rgbd else CameraSetup.MONOCULAR,
                 model=CameraModel.PERSPECTIVE, fps=30.0, **intr, **depth)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, 12,
                                              step=0.06 if rgbd else 0.08)
    fn = getattr(owner, name)
    calls = []

    def record(*a, **k):
        if want(k) and not calls:
            calls.append((a, k))
        return fn(*a, **k)

    setattr(owner, name, record)
    try:
        slam = system_mod.System(Config(camera=cam, orb=OrbParams(**orb), raw={}), device="cpu",
                                 enable_loop_closing=False, max_kf_interval=3, **sizes)
        slam.startup()
        for img, depth, ts in frames:
            if rgbd:
                slam.feed_RGBD_frame(img, depth, ts)
            else:
                slam.feed_monocular_frame(img, ts)
            if calls:
                break
        slam.shutdown()
    finally:
        setattr(owner, name, fn)
    (a, k), = calls
    return fn, a, k


def chain_ba_640(repeats: int) -> dict:
    local_ba, a, k = _first_chain_call(system_mod.mapper, "local_ba",
                                       lambda k: k.get("return_cams"))
    return dict(name="chain_ba_640x480", slot=int(a[2]),
                seconds=_median_seconds(lambda: local_ba(*a, **k), repeats))


def kf_chain_640(repeats: int) -> dict:
    chain, a, k = _first_chain_call(system_mod, "_kf_chain", lambda k: k.get("do_ba"))
    return dict(name="kf_chain_640x480", slot=int(a[2]),
                seconds=_median_seconds(lambda: chain(*a, **k), repeats))


def chain_ba_rgbd(repeats: int) -> dict:
    local_ba, a, k = _first_chain_call(system_mod.mapper, "local_ba",
                                       lambda k: k.get("return_cams"), rgbd=True)
    return dict(name="chain_ba_rgbd_640x480", slot=int(a[2]),
                seconds=_median_seconds(lambda: local_ba(*a, **k), repeats))


def kf_chain_rgbd(repeats: int) -> dict:
    chain, a, k = _first_chain_call(system_mod, "_kf_chain", lambda k: k.get("do_ba"),
                                    rgbd=True)
    return dict(name="kf_chain_rgbd_640x480", slot=int(a[2]),
                seconds=_median_seconds(lambda: chain(*a, **k), repeats))


def chain_ba_c16(repeats: int) -> dict:
    local_ba, a, k = _first_chain_call(system_mod.mapper, "local_ba",
                                       lambda k: k.get("return_cams"), rgbd=True, small=True)
    return dict(name="chain_ba_c16_320x240", slot=int(a[2]),
                seconds=_median_seconds(lambda: local_ba(*a, **k), repeats))


# (name, cols, rows, fx, focal_x_baseline, keypoints, slots): the main
# path's stereo camera and the EuRoC and KITTI stereo YAMLs' sizes, focal
# lengths and baselines (chip_smoke.py DATASET_CAMERAS).
STEREO_CAMERAS = (("640x480", 640, 480, 525.0, 52.5, 1000, 1032),
                  ("752x480", 752, 480, 435.2046959714599, 47.90639384423901, 1000, 1032),
                  ("1241x376", 1241, 376, 718.856, 386.1448, 2000, 2040))


def _match_stereo(repeats: int, name, cols, rows, f, fxb, keypoints, slots) -> dict:
    cam = Camera(name=name, setup=CameraSetup.STEREO, model=CameraModel.PERSPECTIVE, cols=cols,
                 rows=rows, fx=f, fy=f, cx=(cols - 1) / 2, cy=(rows - 1) / 2, fps=30.0,
                 focal_x_baseline=fxb, depth_threshold=40.0)
    tex = synthetic_scene.make_texture(np.random.default_rng(0))
    R, t = synthetic_scene.trajectory(1)[0]
    left, _ = synthetic_scene.render(cam, tex, R, t, plane_half=8.0)
    right, _ = synthetic_scene.render(cam, tex, R, t - np.array([fxb / f, 0.0, 0.0]),
                                      plane_half=8.0)
    fe = Frontend(cam, OrbParams(max_num_keypts=keypoints, num_levels=8), pad_to=slots,
                  device="cpu")
    match = frontend_mod.stereo_ops.match_stereo
    calls = []

    def record(*a, **k):
        calls.append((a, k))
        return match(*a, **k)

    frontend_mod.stereo_ops.match_stereo = record
    try:
        fe.stereo(left, right)
    finally:
        frontend_mod.stereo_ops.match_stereo = match
    (a, k), = calls
    out = {}

    def run():
        out["ok"] = match(*a, **k)[2]

    seconds = _median_seconds(run, repeats)
    return dict(name=f"match_stereo_{name}", slots=slots, matched=int(out["ok"].sum()),
                seconds=seconds)


def match_stereo_640(repeats: int) -> dict:
    return _match_stereo(repeats, *STEREO_CAMERAS[0])


def match_stereo_752(repeats: int) -> dict:
    return _match_stereo(repeats, *STEREO_CAMERAS[1])


def match_stereo_1241(repeats: int) -> dict:
    return _match_stereo(repeats, *STEREO_CAMERAS[2])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2, help="torch's CPU thread count")
    ap.add_argument("--only", nargs="*", help="measurements to run (default: all)")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for measure in (global_ba_iter, mono_init, track_frame_320, track_frame_640, init_ba_640,
                    chain_ba_640, kf_chain_640, chain_ba_rgbd, kf_chain_rgbd, chain_ba_c16,
                    match_stereo_640, match_stereo_752,
                    match_stereo_1241):
        if args.only and measure.__name__ not in args.only:
            continue
        print(json.dumps(dict(measure(args.repeats), threads=args.threads)), flush=True)


if __name__ == "__main__":
    main()
