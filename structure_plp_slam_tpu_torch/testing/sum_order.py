"""How far the summation order moves the K = 1024 chain's PCG global BA
(ROADMAP C44) and the IC angles (C8).

    python -m structure_plp_slam_tpu_torch.testing.sum_order [--device cpu]

Runs on the card unless ``--device`` names another device. Prints one
JSON object per measurement:

* ``pcg_shards``: testing/large_map.py's K = 1024 chain (8 landmarks per
  keyframe, 32 slots) with 2 cm of noise on every pose but the anchor's
  (numpy seed 42: the map of tests/test_torch_distributed_ba.py's
  large-K tests), 2 iterations, in float32 and in float64:
  ``run_global_ba`` on one device against its mesh route on 2, 3, 4, 8
  and 16 shards of the device, and the meshes against each other
  (largest pose and landmark differences over the valid ones);
* ``pcg_draws``: the chip's map (24 landmarks per keyframe, 64 slots),
  four noise draws (seeds 0-3), float32: one device against 3 and 4
  shards;
* ``ic_angles``: 1000 keypoints (numpy seed 19, the borders' margin
  off) of the first 640x480 frame of the main path's sequence: the f32
  angles against the angles from f64 moment maps (rad).

The mesh route sums the same terms as the one-device route, in another
order (each shard's part, then the shards'). In float64 the two agree
to rounding; the float32 gap is that order, amplified by the 40 CG
steps on the weakly tied chain.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from structure_plp_slam_tpu_torch.models import global_ba
from structure_plp_slam_tpu_torch.parallel.distributed_ba import LandmarkMesh
from structure_plp_slam_tpu_torch.testing.large_map import build_large_map
from structure_plp_slam_tpu_torch.utils.types import resolve_device

TABLE = np.ones(8, np.float32)
SHARDS = (2, 3, 4, 8, 16)


def _perturbed(lm_per_kf, slots, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    cam, state, _ = build_large_map(rng, K=1024, lm_per_kf=lm_per_kf, N=slots, device=device)
    pose = state.kf_pose.clone()
    noise = rng.normal(size=(pose.shape[0] - 1, 3)).astype(np.float32)
    pose[1:, :, 3] += torch.from_numpy(noise).to(device) * 0.02
    return cam, state._replace(kf_pose=pose.to(dtype), lm_pos=state.lm_pos.to(dtype))


def _solve(cam, state, n=1):
    mesh = LandmarkMesh([state.kf_pose.device] * n) if n > 1 else None
    return global_ba.run_global_ba(cam, state, TABLE, anchor_kf=0, num_iters=2, mesh=mesh)


def _gaps(a, b, state):
    """Largest pose and landmark differences over the valid ones."""
    kv, lv = state.kf_valid, state.lm_valid
    return [float((a.kf_pose - b.kf_pose)[kv].abs().max()),
            float((a.lm_pos - b.lm_pos)[lv].abs().max())]


def pcg_shards(device):
    out = {}
    for dtype in (torch.float32, torch.float64):
        cam, state = _perturbed(8, 32, 42, device, dtype)
        ref = _solve(cam, state)
        mesh = {n: _solve(cam, state, n) for n in SHARDS}
        out[str(dtype).removeprefix("torch.")] = {
            "moved_m": _gaps(ref, state, state)[0],
            "mesh_vs_one_device": {n: _gaps(p, ref, state) for n, p in mesh.items()},
            "mesh_vs_mesh": {f"{a}-{b}": _gaps(mesh[a], mesh[b], state)[0]
                             for a in mesh for b in mesh if a < b}}
    return out


def pcg_draws(device):
    out = {}
    for seed in range(4):
        cam, state = _perturbed(24, 64, seed, device)
        ref = _solve(cam, state)
        out[seed] = {n: _gaps(_solve(cam, state, n), ref, state) for n in (3, 4)}
    return {"mesh_vs_one_device_by_seed": out}


def ic_angles(device):
    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.ops import orb
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    cam = Camera(name="bench", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
                 cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5, fps=30.0,
                 focal_x_baseline=40.0, depth_threshold=40.0, depthmap_factor=1.0)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(0), cam, 1)
    img = torch.from_numpy(np.asarray(frames[0][0], np.float32)).to(device)
    rng = np.random.default_rng(19)
    m = orb.EDGE_MARGIN
    xy = torch.from_numpy(np.stack([rng.uniform(m, 640 - m, 1000), rng.uniform(m, 480 - m, 1000)],
                                   1).astype(np.float32)).to(device)
    a32 = orb.ic_angles(img, xy).double()
    a64 = orb.ic_angles(img.double(), xy.double())
    return {"f32_vs_f64_rad": float((a32 - a64).abs().max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    device = resolve_device(ap.parse_args(argv).device)
    for fn in (pcg_shards, pcg_draws, ic_angles):
        print(json.dumps({fn.__name__: fn(device)}), flush=True)


if __name__ == "__main__":
    main()
