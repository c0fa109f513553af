"""The port's cached [K, L] observation indicator after every keyframe
burst equals its rebuild: tests/test_indicator_incremental.py's two cases
(RGB-D with planes; RGB-D with lines) on the port System alone.

The keyframe chain patches the cached indicator by rows
(``data/map_state.indicator_update_rows``) instead of rebuilding it, and
the cache seeds the next frame's tracking, so a divergence would silently
change the matching. Exact equality, as in the JAX test.
"""

import numpy as np
import torch

from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System
from structure_plp_slam_tpu_torch.testing import synthetic_scene as sc

torch.set_num_threads(2)

CAM = Camera(name="synt", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, cols=320,
             rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5, fps=30.0,
             focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
CFG = Config(camera=CAM, orb=OrbParams(max_num_keypts=600, num_levels=4), raw={})


def _check(slam):
    if slam._ind_cache is None:
        return 0
    full = ms.observation_indicator(slam.state).numpy()
    inc = slam._ind_cache.numpy()
    mism = np.argwhere(full != inc)
    assert mism.size == 0, (
        f"incremental indicator diverged at {mism[:10]} "
        f"(full={full[tuple(mism[0])]}, inc={inc[tuple(mism[0])]})"
    )
    return 1


def _drive(slam, tex, n, every, seg):
    slam.startup()
    checked = 0
    for i, (R, t) in enumerate(sc.trajectory(n, step=0.06)):
        img, depth = sc.render(CAM, tex, R, t)
        mask = np.where(depth < 4.5, 1, 2).astype(np.int32) if seg else None
        slam.feed_RGBD_frame(np.clip(img, 0, 255).astype(np.float32),
                             depth.astype(np.float32) * CAM.depthmap_factor, i / 30.0,
                             seg_mask=mask)
        if i % every == every - 1:
            slam._drain_pending()
            checked += _check(slam)
    slam._drain_pending()
    checked += _check(slam)
    slam.shutdown()
    assert checked >= 3 and slam.num_keyframes >= 3


def test_incremental_indicator_matches_rebuild_planes():
    slam = System(CFG, max_keyframes=32, max_landmarks=4096, device="cpu")
    _drive(slam, sc.make_texture(np.random.default_rng(42)), 30, 5, seg=True)
    assert slam.metrics()["planes"] >= 1


def test_incremental_indicator_matches_rebuild_lines():
    slam = System(CFG, max_keyframes=32, max_landmarks=4096, with_lines=True, device="cpu")
    _drive(slam, sc.make_texture(np.random.default_rng(42), grid=True), 24, 6, seg=False)
    assert slam.metrics()["lines"] >= 1
