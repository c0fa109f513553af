"""A synthetic K-keyframe chain map, built directly as a MapState.

Port of ``tests/test_large_map_loop.py::_build_large_map`` (the map the
JAX package's large-K tests drive: the PCG pose graph, the PCG global BA
and its mesh route past K = 512), so that ``chip_smoke.py`` and the port
tests can build it without JAX. The same numpy draws in the same order
give the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.data import map_state as ms


def make_camera() -> Camera:
    """tests/helpers.py's ``make_camera()``: a 640x480 monocular pinhole."""
    return Camera(name="test", setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE,
                  cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)


def build_large_map(rng, K: int = 1024, lm_per_kf: int = 24, N: int = 64, *, device):
    """A forward corridor of K keyframes 0.25 m apart: each keyframe
    observes ``lm_per_kf`` fresh landmarks 4-8 m ahead and the previous
    keyframe's (chain covisibility); the last keyframe revisits the first
    (a loop) and also observes keyframe 0's landmarks. Returns (camera,
    MapState on ``device``, ground-truth centres [K, 3])."""
    cam = make_camera()
    L = K * lm_per_kf
    state = ms.create(max_keyframes=K, max_kps=N, max_landmarks=L, device=device)

    C_gt = np.zeros((K, 3))
    C_gt[:, 2] = 0.25 * np.arange(K)
    C_gt[K - 1] = C_gt[0] + [0.05, 0.0, 0.1]  # the revisit

    pose = np.zeros((K, 3, 4), np.float32)
    lm_pos = np.zeros((L, 3), np.float32)
    lm_ref = np.zeros((L,), np.int64)
    kf_lm_idx = np.full((K, N), -1, np.int64)
    kf_xy = np.zeros((K, N, 2), np.float32)
    kp_valid = np.zeros((K, N), bool)

    def obs(kk, pts_w, ids, slot0):
        Rk, tk = pose[kk, :, :3], pose[kk, :, 3]
        pc = pts_w @ Rk.T + tk
        uv = np.stack([cam.fx * pc[:, 0] / np.maximum(pc[:, 2], 0.5) + cam.cx,
                       cam.fy * pc[:, 1] / np.maximum(pc[:, 2], 0.5) + cam.cy], axis=1)
        j = np.nonzero((pc[:, 2] > 0.5) & (slot0 + np.arange(len(pc)) < N))[0]
        kf_lm_idx[kk, slot0 + j] = np.asarray(ids)[j]
        kf_xy[kk, slot0 + j] = uv[j]
        kp_valid[kk, slot0 + j] = True

    for k in range(K):
        R = np.eye(3, dtype=np.float32)
        pose[k, :, :3] = R
        pose[k, :, 3] = (-R @ C_gt[k]).astype(np.float32)
        base = k * lm_per_kf
        pts = np.stack([rng.uniform(-3, 3, lm_per_kf), rng.uniform(-2, 2, lm_per_kf),
                        C_gt[k, 2] + rng.uniform(4, 8, lm_per_kf)], axis=1).astype(np.float32)
        lm_pos[base:base + lm_per_kf] = pts
        lm_ref[base:base + lm_per_kf] = k
        obs(k, pts, range(base, base + lm_per_kf), 0)
        if k > 0:
            prev = (k - 1) * lm_per_kf
            obs(k, lm_pos[prev:prev + lm_per_kf], range(prev, prev + lm_per_kf), lm_per_kf)
    obs(K - 1, lm_pos[0:lm_per_kf], range(0, lm_per_kf), 2 * lm_per_kf)

    def dev(a):
        return torch.from_numpy(a).to(device)

    state = state._replace(
        kf_pose=dev(pose), kf_valid=torch.ones((K,), dtype=torch.bool, device=device),
        kf_timestamp=torch.arange(K, dtype=torch.float32, device=device),
        kf_lm_idx=dev(kf_lm_idx), kf_xy=dev(kf_xy), kf_kp_valid=dev(kp_valid),
        lm_pos=dev(lm_pos), lm_valid=torch.ones((L,), dtype=torch.bool, device=device),
        lm_ref_kf=dev(lm_ref),
    )
    return cam, state, C_gt
