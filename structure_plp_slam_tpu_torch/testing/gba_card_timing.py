"""Card time of the one-device dense global BA (``global_ba.solve``).

    python -m structure_plp_slam_tpu_torch.testing.gba_card_timing [--iters 10] [--repeats 5]

Needs a CUDA device (it raises without one). Builds testing/large_map.py's
chain at K = 256 keyframes, 128 landmarks per keyframe and 256 slots (L =
32,768, numpy seed 0: ``cpu_linalg_timing``'s ``global_ba_iter`` map)
with 2 cm of noise on every pose but the first, and times
``global_ba.solve`` over ``--iters`` Gauss-Newton iterations: the median
of ``--repeats`` calls between CUDA events, and one call under
torch.profiler (the device's busy time, its kernel count and the kernels
with the most device time). Prints one JSON object, with the card's name
and power limit. It uses only ``global_ba.prepare`` / ``solve`` and
``testing/large_map``, so a copy of it run from the root of an older
checkout (``python -m ...`` there) times that tree's solve: run the two
in turns (old, new, new, old) in one call to compare them.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script times the card")
    from torch.profiler import ProfilerActivity, profile

    from structure_plp_slam_tpu_torch.models import global_ba
    from structure_plp_slam_tpu_torch.testing.large_map import build_large_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cam, state, _ = build_large_map(np.random.default_rng(0), K=256, lm_per_kf=128, N=256,
                                    device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    pose = state.kf_pose.clone()
    pose[1:, :, 3] += torch.randn(pose.shape[0] - 1, 3, device="cuda", generator=g) * 0.02
    data = global_ba.prepare(state, torch.ones(8, device="cuda"))
    fixed = torch.arange(pose.shape[0], device="cuda") == 0

    def solve():
        return global_ba.solve(cam, pose, state.kf_valid, fixed, state.lm_pos, state.lm_valid,
                               data, num_iters=args.iters)

    out = solve()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        solve()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    res = {"K": int(pose.shape[0]), "L": int(state.lm_pos.shape[0]),
           "observations": int(data.num_obs), "pairs": int(data.num_pairs),
           "iters": args.iters, "wall_ms_median": float(np.median(times)), "wall_ms": times,
           "device_kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
           "device_kernels": len(kernels),
           "top": [{"name": k[:80], "count": n, "ms": us / 1e3} for k, (n, us) in top],
           "moved_poses_by": float((out[0] - pose)[state.kf_valid].abs().max()),
           "card": _card()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
